"""Cost-based planning of the port (relational/stats.py,
relational/cost.py, obs/telemetry.py) against the JAX package.

The same seeded arrays go into a CPU session of the port and into the
JAX package's device backend, both with their default configuration
(the cost model, WCOJ and re-planning on).  Statistics sketches must be
equal with integers exact, and on the planning benchmark's five query
families (a 2,000-person version of ``bench.py`` config 9's graph) both
engines must make the same decisions (EXPLAIN's cost section), plan the
same operators with the same strategies and ``~rows=`` estimates, and
return the same bags.  The pricing rules and the divergence → re-plan
loop mirror ``tests/test_cost.py``.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

import caps_tpu_torch
from caps_tpu.backends.tpu.session import TPUCypherSession
from caps_tpu.frontend.parser import normalize_query as jax_normalize
from caps_tpu.ir.pattern import Direction as JaxDirection
from caps_tpu.obs.telemetry import OpStatsStore as JaxOpStatsStore
from caps_tpu.okapi import types as JT
from caps_tpu.okapi.config import EngineConfig as JaxConfig
from caps_tpu.relational import cost as jax_cost
from caps_tpu.relational import stats as jax_stats
from caps_tpu.relational.entity_tables import (
    NodeMapping as JaxNodeMapping, NodeTable as JaxNodeTable,
)
from caps_tpu.relational.shapes import ShapeBucketLattice as JaxLattice
from caps_tpu.testing import faults
from caps_tpu_torch.datasets.patterns import PLAN_FAMILIES, plan_graph
from caps_tpu_torch.interop import graph_from_numpy
from caps_tpu_torch.ir.pattern import Direction
from caps_tpu_torch.obs import OpStatsStore
from caps_tpu_torch.okapi import types as PT
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.relational import cost as port_cost
from caps_tpu_torch.relational import stats as port_stats
from caps_tpu_torch.relational.entity_tables import NodeMapping, NodeTable
from caps_tpu_torch.relational.shapes import ShapeBucketLattice
from caps_tpu_torch.testing.faults import stale_statistics
from tests.test_torch_count_pushdown import jax_graph


def both(nodes, rels, port_config=None, jax_config=None):
    """(port graph, JAX graph) over the same arrays, default configs."""
    port = caps_tpu_torch.local_session(device="cpu", config=port_config)
    ref = TPUCypherSession(config=jax_config)
    return graph_from_numpy(port, nodes, rels), jax_graph(ref, nodes, rels)


def skewed_graph(n_person=1500, n_city=30, seed=7):
    """Many Persons, few Cities, one LIVES_IN edge each: a chain whose
    cheap root is the City end (``tests/test_cost.py _skewed_graph``)."""
    rng = np.random.RandomState(seed)
    city = n_person + rng.randint(0, n_city, n_person)
    nodes = {"Person": {"_id": np.arange(n_person, dtype=np.int64),
                        "name": [f"p{i}" for i in range(n_person)]},
             "City": {"_id": np.arange(n_person, n_person + n_city,
                                       dtype=np.int64),
                      "name": [f"c{i}" for i in range(n_city)]}}
    rels = {"LIVES_IN": {
        "_id": np.arange(10 ** 6, 10 ** 6 + n_person, dtype=np.int64),
        "_src": np.arange(n_person, dtype=np.int64), "_tgt": city}}
    return nodes, rels


CHAIN_Q = ("MATCH (a:Person)-[:LIVES_IN]->(c:City) WHERE c.name = $city "
           "RETURN a.name AS n")


def bag(result):
    return sorted(repr(sorted(r.items())) for r in result.records.to_maps())


def ops_and_strategies(result):
    return [(m["op"], m.get("strategy"), m.get("est_rows"))
            for m in result.metrics["operators"]]


# -- statistics sketches -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_degree_sketch_matches_jax(seed):
    rng = np.random.RandomState(seed)
    keys = np.concatenate([rng.randint(0, 50, 400),
                           np.full(90, 7), rng.zipf(1.5, 300) % 1000])
    assert port_stats._sketch(keys).to_payload() == \
        jax_stats._sketch(keys).to_payload()
    assert port_stats._sketch(keys[:0]).to_payload() == \
        jax_stats._sketch(keys[:0]).to_payload()


GRAPHS = {
    "skewed": lambda: skewed_graph(),
    "plan": lambda: plan_graph(2000, 40, 100, 10_000),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_statistics_payload_equals_jax(name):
    port_g, jax_g = both(*GRAPHS[name]())
    got, want = port_g.statistics(), jax_g.statistics()
    assert got.to_payload() == want.to_payload()
    assert got.summary() == want.summary()


def _special_columns():
    """Property columns with nulls, -0.0 beside 0.0, NaN rows, repeated
    strings, booleans and a list column."""
    nan = float("nan")
    return (
        {"_id": list(range(12)),
         "i": [1, None, 1, 2, 3, None, 3, 3, 7, 8, 9, 1],
         "f": [0.0, -0.0, nan, nan, 1.5, None, 1.5, -2.0, nan, 0.0, None,
               2.5],
         "s": ["a", "b", None, "a", "", "", "c", None, "b", "d", "a", "e"],
         "b": [True, False, None, True, True, None, False, True, True,
               False, True, True],
         "l": [[1, 2], [1, 2], None, [3], [], [], [1], [2], [2], None,
               [1, 2], [4]]},
        {"_id": "int", "i": "int?", "f": "float?", "s": "str?",
         "b": "bool?", "l": "list?"})


def _typed(mod, name):
    base = {"int": mod.CTInteger, "float": mod.CTFloat, "str": mod.CTString,
            "bool": mod.CTBoolean,
            "list": mod.CTList(mod.CTInteger)}[name.rstrip("?")]
    return base.nullable if name.endswith("?") else base


def test_distinct_counts_on_the_device_equal_the_reference_set():
    """The per-property distinct count computed on the device columns
    equals the reference's ``len(set(values))`` exactly: nulls left out,
    -0.0 and 0.0 once, each NaN row on its own, strings by value, no
    count for a list column."""
    data, kinds = _special_columns()
    port = caps_tpu_torch.local_session(device="cpu")
    ref = TPUCypherSession()
    graphs = []
    for session, mod, mapping, table_cls in (
            (port, PT, NodeMapping, NodeTable),
            (ref, JT, JaxNodeMapping, JaxNodeTable)):
        m = mapping.on("_id").with_implied_labels("N")
        for k in data:
            if k != "_id":
                m = m.with_property(k)
        t = session.table_factory.from_columns(
            data, {k: _typed(mod, v) for k, v in kinds.items()})
        graphs.append(session.create_graph([table_cls(m, t)], []))
    got = graphs[0].statistics().property_distinct
    want = graphs[1].statistics().property_distinct
    assert got == want
    combo = frozenset({"N"})
    # the reference's rule, spelled out
    assert got[(combo, "i")] == 6
    assert got[(combo, "f")] == 7   # 0.0, 1.5, -2.0, 2.5 + 3 NaN rows
    assert got[(combo, "s")] == 6
    assert got[(combo, "b")] == 2
    assert (combo, "l") not in got


def test_statistics_lookups_and_caching():
    port_g, jax_g = both(*skewed_graph(n_person=200, n_city=10))
    stats = port_g.statistics()
    want = jax_g.statistics()
    for labels in (["Person"], ["City"], []):
        assert stats.node_cardinality(labels) == \
            want.node_cardinality(labels)
        assert stats.label_fraction(labels) == want.label_fraction(labels)
    assert stats.rel_cardinality(["LIVES_IN"]) == 200
    assert stats.rel_cardinality(["NOPE"]) == 0
    assert stats.eq_distinct(["Person"], "name") == 200
    assert stats.eq_distinct(["Person"], "nope") is None
    for out in (True, False):
        assert stats.degree_per_node(["LIVES_IN"], out) == \
            want.degree_per_node(["LIVES_IN"], out)
        assert stats.skew(["LIVES_IN"], out) == want.skew(["LIVES_IN"], out)
        assert stats.hot_keys(["LIVES_IN"], out) == \
            want.hot_keys(["LIVES_IN"], out)
    session = port_g._session
    assert session.metrics_snapshot()["stats.computed"] == 1
    assert port_g.statistics() is stats
    assert session.metrics_snapshot()["stats.computed"] == 1


def test_stats_payload_roundtrip():
    port_g, _ = both(*skewed_graph(n_person=100, n_city=8))
    stats = port_g.statistics()
    back = port_stats.GraphStatistics.from_payload(stats.to_payload())
    assert back.to_payload() == stats.to_payload()
    assert back.eq_distinct(["City"], "name") == 8
    assert port_stats.GraphStatistics.from_payload(
        {"node_combos": 7}) is None
    assert port_stats.GraphStatistics.from_payload(
        {"rels": {"K": {"rows": "NaN-ish", "out": []}}}) is None


def test_seed_statistics_adopts_persisted_prior():
    g1, _ = both(*skewed_graph(n_person=100, n_city=8))
    payload = g1.statistics().to_payload()
    g2, _ = both(*skewed_graph(n_person=10, n_city=2))
    assert g2.seed_statistics(payload) is True
    assert g2.statistics().node_cardinality(["Person"]) == 100
    snap = g2._session.metrics_snapshot()
    assert snap.get("stats.seeded", 0) == 1
    assert snap.get("stats.computed", 0) == 0
    g3, _ = both(*skewed_graph(n_person=10, n_city=2))
    g3.statistics()
    assert g3.seed_statistics(payload) is False
    assert g3.statistics().node_cardinality(["Person"]) == 10
    g4, _ = both(*skewed_graph(n_person=10, n_city=2))
    assert g4.seed_statistics({"node_combos": 7}) is False
    assert g4.seed_statistics({}) is False


@pytest.mark.parametrize("created,hidden_n,hidden_r", [
    (3, 0, 0), (0, 40, 0), (2, 5, 30)])
def test_fold_delta_matches_jax(created, hidden_n, hidden_r):
    """A snapshot's delta counts fold over the base sketch as in the JAX
    package (its first caller, the update path, is ROADMAP item 6)."""
    _, jax_g = both(*skewed_graph(n_person=200, n_city=10))
    payload = jax_g.statistics().to_payload()
    state = types.SimpleNamespace(
        nodes=[types.SimpleNamespace(labels=("Person",))] * created
        + [types.SimpleNamespace(labels=("Person", "New"))],
        rels=[types.SimpleNamespace(rel_type="LIVES_IN")] * created
        + [types.SimpleNamespace(rel_type="NEW")],
        hidden_nodes=list(range(hidden_n)),
        hidden_rels=list(range(hidden_r)))
    got = port_stats.fold_delta(
        port_stats.GraphStatistics.from_payload(payload), state, 5)
    want = jax_stats.fold_delta(
        jax_stats.GraphStatistics.from_payload(payload), state, 5)
    assert got.to_payload() == want.to_payload()
    assert got.version == 5


# -- the cost model ----------------------------------------------------------


class _Cfg:
    broadcast_join_threshold = 4096
    join_hot_factor = 4.0
    use_cost_model = True


@pytest.mark.parametrize("probe,build,shards,skew,threshold", [
    (100_000, 1000, 8, 1.0, 4096), (100_000, 100_000, 8, 1.0, 4096),
    (100_000, 100_000, 8, 6.0, 4096), (10_000_000, 5000, 8, 1.0, 4096),
    (100_000, 10, 8, 1.0, 0)])
def test_choose_dist_strategy_matches_jax(probe, build, shards, skew,
                                          threshold):
    cfg = _Cfg()
    cfg.broadcast_join_threshold = threshold
    assert port_cost.choose_dist_strategy(probe, build, shards, cfg, skew) \
        == jax_cost.choose_dist_strategy(probe, build, shards, cfg, skew)


def test_device_cost_prices_padded_buckets():
    lattices = []
    for cls in (ShapeBucketLattice, JaxLattice):
        lat = cls()
        lat.seed([1000, 5000])
        lattices.append(lat)
    model = port_cost.CostModel(lattice=lattices[0])
    ref = jax_cost.CostModel(lattice=lattices[1])
    for rows in (3, 1000, 4097, 10 ** 6, 10 ** 7):
        assert model.padded_rows(rows) == ref.padded_rows(rows)
        assert model.device_cost(rows) == ref.device_cost(rows)
    beyond = lattices[0].boundaries()[-1] * 2
    assert model.device_cost(beyond) == \
        model.padded_rows(beyond) * port_cost.ROW_BYTES * 2.0


def _stats_pair(n, e):
    out = []
    for mod in (port_stats, jax_stats):
        out.append(mod.GraphStatistics(
            {frozenset(["P"]): n},
            {"K": mod.RelStats("K", e, mod.DegreeSketch(
                rows=e, distinct=n, mean=e / n))},
            {(frozenset(["P"]), "name"): n}))
    return out


@pytest.mark.parametrize("n,e", [(5000, 5000), (2_000_000, 2_000_000)],
                         ids=["small", "huge"])
def test_count_pushdown_boundary_matches_jax(n, e):
    """The decision boundary on synthetic statistics: the small graph
    keeps the SpMV, the huge graph with a unique seed routes around
    it — the same decision and decision log as the JAX package."""
    ps, js = _stats_pair(n, e)
    model = port_cost.CostModel(ps, lattice=ShapeBucketLattice())
    ref = jax_cost.CostModel(js, lattice=JaxLattice())
    got = model.count_pushdown_wins(
        ["P"], 1 / n, [(("K",), Direction.OUTGOING, (), 1.0)])
    want = ref.count_pushdown_wins(
        ["P"], 1 / n, [(("K",), JaxDirection.OUTGOING, (), 1.0)])
    assert got == want == (n == 5000)
    assert model.render_decisions() == ref.render_decisions()


def test_wcoj_decision_surface_matches_jax():
    ps, js = _stats_pair(60, 600)
    model = port_cost.CostModel(ps, lattice=ShapeBucketLattice())
    ref = jax_cost.CostModel(js, lattice=JaxLattice())
    got = model.wcoj_vs_cascade(
        frozenset({"P"}), 1.0,
        [(("K",), Direction.OUTGOING, frozenset(), 1.0, ()),
         (("K",), Direction.OUTGOING, frozenset(), 1.0, (("K",),))],
        [("K",)])
    want = ref.wcoj_vs_cascade(
        frozenset({"P"}), 1.0,
        [(("K",), JaxDirection.OUTGOING, frozenset(), 1.0, ()),
         (("K",), JaxDirection.OUTGOING, frozenset(), 1.0, (("K",),))],
        [("K",)])
    assert got == want
    assert got[0] is True
    assert model.decisions[-1]["kind"] == "wcoj_strategy"


def test_calibrated_rows_prefers_observed_history():
    store = OpStatsStore()
    entries = [{"op_id": 1, "op": "Scan", "rows": 500, "seconds": 0.0}]
    model = port_cost.CostModel(op_stats=store, family="FAM")
    assert model.calibrated_rows(1, "Scan", 7.0) == (7.0, "model")
    store.record("FAM", entries)
    store.record("FAM", entries)
    model = port_cost.CostModel(op_stats=store, family="FAM")
    assert model.calibrated_rows(1, "Scan", 7.0) == (500.0, "observed")


def test_opstats_divergence_matches_jax():
    """The same executions folded into both stores give the same
    divergences, re-plan candidates and per-operator view."""
    stores = [cls(replan_threshold=2, bucket_fn=lat.bucket)
              for cls, lat in ((OpStatsStore, ShapeBucketLattice()),
                               (JaxOpStatsStore, JaxLattice()))]
    sequence = [(200, 10), (5000, 100), (5000, 100), (100, 1), (9, None)]
    handed = [[], []]
    for rows, est in sequence:
        entry = {"op_id": 1, "op": "Scan", "rows": rows, "seconds": 0.0}
        if est is not None:
            entry["est_rows"] = est
        for i, store in enumerate(stores):
            store.record("FAM", [entry])
            handed[i].append(store.take_replan_candidates())
    assert handed[0] == handed[1] == [[], [], ["FAM"], [], []]
    assert stores[0].stats() == stores[1].stats()
    assert stores[0].summary() == stores[1].summary()


# -- the planning benchmark's five families ----------------------------------


@pytest.fixture(scope="module")
def plan_graphs():
    return both(*plan_graph(2000, 40, 100, 10_000))


@pytest.mark.parametrize("family", sorted(PLAN_FAMILIES))
def test_family_plans_and_answers_like_jax(plan_graphs, family):
    """Per binding: the same EXPLAIN (relational plan with its ``~rows=``
    estimates, and the cost section's decisions), the same operators,
    strategies and estimates when it runs, the same bag of rows."""
    port_g, jax_g = plan_graphs
    query, bindings = PLAN_FAMILIES[family]
    for params in bindings:
        got = port_g.cypher("EXPLAIN " + query, params).plans
        want = jax_g.cypher("EXPLAIN " + query, params).plans
        assert got["relational"] == want["relational"]
        assert "~rows=" in got["relational"]
        assert got["cost"] == want["cost"]
        rp, rj = port_g.cypher(query, params), jax_g.cypher(query, params)
        assert ops_and_strategies(rp) == ops_and_strategies(rj)
        assert bag(rp) == bag(rj)
    rerooted = "chosen=reversed" in got["cost"]
    assert rerooted == family.endswith("_reroot")
    if family.endswith("_guard"):
        assert "count_strategy: chosen=fused-spmv" in got["cost"]


def test_cost_model_off_restores_heuristic_planning():
    port_g, jax_g = both(
        *skewed_graph(), port_config=EngineConfig(use_cost_model=False),
        jax_config=JaxConfig(use_cost_model=False))
    got = port_g.cypher("EXPLAIN " + CHAIN_Q, {"city": "c3"})
    want = jax_g.cypher("EXPLAIN " + CHAIN_Q, {"city": "c3"})
    assert "cost" not in got.plans
    assert "~rows=" not in got.plans["relational"]
    assert got.plans["relational"] == want.plans["relational"]
    plan = got.plans["relational"]
    assert plan.index("Scan(a: CTNode(Person))") \
        < plan.index("Scan(c: CTNode(City))")


def test_chain_reroot_counts_and_explains():
    port_g, jax_g = both(*skewed_graph())
    res = port_g.cypher(CHAIN_Q, {"city": "c3"})
    assert bag(res) == bag(jax_g.cypher(CHAIN_Q, {"city": "c3"}))
    plan = res.plans["relational"]
    assert plan.index("Scan(c: CTNode(City))") \
        < plan.index("Scan(a: CTNode(Person))")
    assert port_g._session.metrics_snapshot()["cost.reorders"] == 1
    exp = port_g.cypher("EXPLAIN " + CHAIN_Q, {"city": "c3"}).explain()
    assert "~rows=" in exp and "(model)" in exp
    assert "join_order:" in exp and "chosen=reversed" in exp


# -- pricing rules -----------------------------------------------------------


def _unique_names_graph():
    rng = np.random.RandomState(3)
    pairs = rng.randint(0, 5000, size=(5000, 2))
    nodes = {"P": {"_id": np.arange(5000, dtype=np.int64),
                   "name": [f"u{i}" for i in range(5000)]}}
    rels = {"K": {"_id": np.arange(10 ** 6, 10 ** 6 + 5000, dtype=np.int64),
                  "_src": pairs[:, 0].copy(), "_tgt": pairs[:, 1].copy()}}
    return nodes, rels


def test_count_pushdown_stays_fused_when_spmv_wins():
    port_g, jax_g = both(*skewed_graph(n_person=200, n_city=10))
    q = "MATCH (a:Person)-[:LIVES_IN]->(c:City) RETURN count(*) AS c"
    got, want = port_g.cypher(q), jax_g.cypher(q)
    assert ops_and_strategies(got) == ops_and_strategies(want)
    assert got.metrics["operators"][0]["op"] == "CountPattern"
    assert got.records.to_maps() == [{"c": 200}]


def test_count_pushdown_routes_to_cascade_on_selective_seed():
    """A hyper-selective seed on a chain the sketch prices as huge (the
    sketch scaled by 400): both engines keep the join cascade and log
    ``chosen=cascade``; with the honest sketch both push the count down.
    Counts stay exact throughout."""
    q = "MATCH (a:P)-[:K]->(b) WHERE a.name = $u RETURN count(*) AS c"
    port_g, jax_g = both(*_unique_names_graph())
    with stale_statistics(port_g, 400), \
            faults.stale_statistics(jax_g, scale=400):
        got, want = port_g.cypher(q, {"u": "u17"}), jax_g.cypher(
            q, {"u": "u17"})
        assert "CountPattern" not in [m["op"] for m in
                                      got.metrics["operators"]]
        assert ops_and_strategies(got) == ops_and_strategies(want)
        assert got.records.to_maps() == want.records.to_maps()
        exp = port_g.cypher("EXPLAIN " + q, {"u": "u17"}).plans["cost"]
        assert exp == jax_g.cypher("EXPLAIN " + q,
                                   {"u": "u17"}).plans["cost"]
        assert "count_strategy" in exp and "chosen=cascade" in exp
    port2, jax2 = both(*_unique_names_graph())
    got2 = port2.cypher(q, {"u": "u17"})
    assert ops_and_strategies(got2) == ops_and_strategies(
        jax2.cypher(q, {"u": "u17"}))
    assert got2.metrics["operators"][0]["op"] == "CountPattern"
    assert got2.records.to_maps() == got.records.to_maps()


# -- divergence -> quarantine -> re-plan -------------------------------------


def _replan_run(graph, session, stale, snapshot):
    """The loop of ``tests/test_cost.py::test_replan_loop_end_to_end_
    through_server`` through the session: two diverging executions under
    a distorted sketch, then the re-plan with the honest one."""
    out = {"plans": [], "rows": [], "cache": []}
    with stale(graph):
        for city in ("c3", "c5"):
            res = graph.cypher(CHAIN_Q, {"city": city})
            out["rows"].append(bag(res))
            out["plans"].append(res.plans["relational"])
    out["after_fault"] = {k: snapshot().get(k, 0) for k in (
        "replan.triggered", "plan_cache.quarantined")}
    for city in ("c3", "c5"):
        res = graph.cypher(CHAIN_Q, {"city": city})
        out["rows"].append(bag(res))
        out["plans"].append(res.plans["relational"])
        out["cache"].append(res.metrics["plan_cache"])
    out["end"] = {k: snapshot().get(k, 0) for k in (
        "replan.triggered", "replan.completed", "plan_cache.quarantined")}
    return out


def test_replan_loop_through_the_session_matches_jax():
    port_g, jax_g = both(*skewed_graph())
    events = []
    port_g._session.replan_listeners.append(
        lambda event, info: events.append((event, info)))
    got = _replan_run(port_g, port_g._session,
                      lambda g: stale_statistics(g, 0.001),
                      port_g._session.metrics_snapshot)
    want = _replan_run(jax_g, jax_g._session,
                       lambda g: faults.stale_statistics(g, scale=0.001),
                       jax_g._session.metrics_snapshot)
    assert got == want
    # the distorted prior keeps the written order; the re-plan with the
    # honest sketch re-roots the chain and then serves warm
    assert got["plans"][0].index("Scan(a: CTNode(Person))") \
        < got["plans"][0].index("Scan(c: CTNode(City))")
    assert got["plans"][2].index("Scan(c: CTNode(City))") \
        < got["plans"][2].index("Scan(a: CTNode(Person))")
    assert got["after_fault"] == {"replan.triggered": 1,
                                  "plan_cache.quarantined": 1}
    assert got["cache"] == ["miss", "hit"]
    assert got["end"]["replan.completed"] == 1
    assert [e for e, _ in events] == ["replan.triggered",
                                      "replan.completed"]
    assert events[0][1]["quarantined_plans"] == 1
    oracle = caps_tpu_torch.local_session(
        device="cpu", config=EngineConfig(use_cost_model=False))
    og = graph_from_numpy(oracle, *skewed_graph())
    assert got["rows"] == [bag(og.cypher(CHAIN_Q, {"city": c}))
                           for c in ("c3", "c5", "c3", "c5")]
    fam = port_g._session.op_stats.stats(jax_normalize(CHAIN_Q))
    assert any("est_rows" in v for v in fam.values())


def test_replan_retires_the_fused_recordings():
    """A retired family's fused size streams go with its plans: the
    re-planned query records anew instead of replaying the old plan's
    sizes."""
    port_g, _ = both(*skewed_graph())
    session = port_g._session
    with stale_statistics(port_g, 0.001):
        port_g.cypher(CHAIN_Q, {"city": "c3"})
        port_g.cypher(CHAIN_Q, {"city": "c3"})
        assert session.fused.last_mode == "replay"
    assert session.metrics_snapshot()["replan.triggered"] == 1
    res = port_g.cypher(CHAIN_Q, {"city": "c3"})
    assert res.metrics["plan_cache"] == "miss"
    assert session.fused.last_mode == "record"
    res = port_g.cypher(CHAIN_Q, {"city": "c3"})
    assert session.fused.last_mode == "replay"
    assert res.metrics["size_syncs"] == 0


def test_replan_disabled_never_retires_plans():
    port_g, _ = both(*skewed_graph(n_person=400, n_city=10),
                     port_config=EngineConfig(replan_threshold=0))
    with stale_statistics(port_g, 0.001):
        for c in ("c1", "c2", "c1", "c2"):
            port_g.cypher(CHAIN_Q, {"city": c})
    snap = port_g._session.metrics_snapshot()
    assert snap.get("replan.triggered", 0) == 0
    assert snap.get("plan_cache.quarantined", 0) == 0
