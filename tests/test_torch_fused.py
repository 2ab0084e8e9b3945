"""The port's fused record/replay executor (backends/cuda/fused.py)
against the JAX package's.

One seeded graph — the 2,000-node / 10,000-edge graph of
test_torch_slice.py — goes into a CPU session of the port and into the
JAX package's ``backend="tpu"`` session (on the CPU, fused record/replay
on by default, Pallas kernels in interpret mode).  Every query below runs
the port's ported operators only; each parameter value must give the same
records on both engines, whatever mode (record, exact replay, generic
replay, re-record) the port's executor took."""
import collections

import numpy as np
import pytest

import caps_tpu
import caps_tpu_torch
from caps_tpu.backends.tpu.fused import _merge_streams as jax_merge_streams
from caps_tpu.okapi.types import CTInteger, CTString
from caps_tpu.relational.entity_tables import (
    NodeMapping, NodeTable, RelationshipMapping, RelationshipTable,
)
from caps_tpu.relational.shapes import ShapeBucketLattice as JaxLattice
from caps_tpu_torch.backends.cuda.fused import _merge_streams
from caps_tpu_torch.interop import graph_from_numpy
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.relational.session import degraded_execution
from caps_tpu_torch.relational.shapes import ShapeBucketLattice

N_PERSONS, N_EDGES, N_CITIES = 2000, 10000, 50

TWO_HOP = ("MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) WHERE a.age = $age ")
GROUPED = (TWO_HOP + "RETURN c.city AS city, count(*) AS n "
           "ORDER BY n DESC, city LIMIT 20")

# (query, parameter name, values in the order they run, ordered)
QUERIES = {
    # filter + join + group + order
    "grouped_2hop": (GROUPED, "age", [30, 31, 30, 45, 31], True),
    "distinct_1hop": ("MATCH (a:Person)-[:KNOWS]->(b:Person) "
                      "WHERE a.age < $age RETURN DISTINCT b.city AS city",
                      "age", [25, 20, 25], False),
    "order_skip_limit": ("MATCH (a:Person) WHERE a.age > $age "
                         "RETURN a.age AS age, a.city AS city, id(a) AS id "
                         "ORDER BY age DESC, city, id SKIP 5 LIMIT 30",
                         "age", [80, 85, 60, 80], True),
    "min_max_by_city": ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age < $age "
                        "RETURN b.city AS city, count(*) AS n, "
                        "min(b.age) AS lo, max(b.age) AS hi",
                        "age", [30, 25, 30], False),
    # the dense kernel over a bool key
    "group_by_bool": ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age < $age "
                      "RETURN b.age > 50 AS old, count(*) AS n, "
                      "min(b.age) AS lo ORDER BY old", "age", [40, 30, 40],
                      True),
    # an empty result between non-empty ones
    "empty_result": (TWO_HOP + "RETURN c.city AS city, count(*) AS n",
                     "age", [200, 30, 201, 200], False),
}


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.RandomState(1234)
    cities = np.array([f"city{i:02d}" for i in range(N_CITIES)])
    nodes = {"Person": {
        "_id": np.arange(N_PERSONS, dtype=np.int64),
        "age": rng.randint(18, 90, N_PERSONS).astype(np.int64),
        "city": cities[rng.randint(0, N_CITIES, N_PERSONS)]}}
    rels = {"KNOWS": {
        "_id": np.arange(N_PERSONS, N_PERSONS + N_EDGES, dtype=np.int64),
        "_src": rng.randint(0, N_PERSONS, N_EDGES).astype(np.int64),
        "_tgt": rng.randint(0, N_PERSONS, N_EDGES).astype(np.int64)}}
    return nodes, rels


def _port(arrays, **cfg):
    """A fresh port session (fresh memos) and its graph."""
    session = caps_tpu_torch.local_session(
        device="cpu", config=EngineConfig(**cfg) if cfg else None)
    return session, graph_from_numpy(session, *arrays)


@pytest.fixture(scope="module")
def jax_graph(arrays):
    nodes, rels = arrays
    session = caps_tpu.local_session(backend="tpu")
    assert session.config.use_fused
    f = session.table_factory
    p, k = nodes["Person"], rels["KNOWS"]
    people = NodeTable(
        NodeMapping.on("_id").with_implied_labels("Person")
        .with_property("age").with_property("city"),
        f.from_columns({"_id": p["_id"].tolist(), "age": p["age"].tolist(),
                        "city": p["city"].tolist()},
                       {"_id": CTInteger, "age": CTInteger,
                        "city": CTString}))
    knows = RelationshipTable(
        RelationshipMapping.on("KNOWS"),
        f.from_columns({c: k[c].tolist() for c in ("_id", "_src", "_tgt")},
                       {c: CTInteger for c in ("_id", "_src", "_tgt")}))
    return session.create_graph([people], [knows])


def _bag(rows):
    return collections.Counter(tuple(sorted(r.items())) for r in rows)


def _same(got, want, ordered):
    if ordered:
        assert got == want
    else:
        assert _bag(got) == _bag(want)


@pytest.mark.parametrize("name", list(QUERIES))
def test_rotating_parameters_match_jax(name, arrays, jax_graph):
    query, pname, values, ordered = QUERIES[name]
    session, graph = _port(arrays)
    modes = []
    for v in values:
        got = graph.cypher(query, {pname: v}).records.to_maps()
        modes.append(session.fused.last_mode)
        want = jax_graph.cypher(query, {pname: v}).records.to_maps()
        _same(got, want, ordered)
    assert modes[0] == "record"
    # a repeated value replays exactly or generically, never re-plans
    assert set(modes) <= {"record", "replay", "replay_gen"}
    assert session.fused.replays + session.fused.generic_replays >= 1


def test_steady_state_sync_collapse(arrays):
    session, graph = _port(arrays)
    syncs = []
    for age in (30, 31, 45, 60, 77, 19, 52, 33, 41, 66):
        result = graph.cypher(GROUPED, {"age": age})
        rows = result.records.to_maps()
        syncs.append(result.metrics["size_syncs"])
        with degraded_execution(no_plan_cache=True, no_fused=True):
            assert rows == graph.cypher(GROUPED,
                                        {"age": age}).records.to_maps()
    assert syncs[0] >= 2
    assert all(s <= 1 for s in syncs[-3:]), syncs
    assert session.fused.generic_replays >= 1


def test_exact_replay_reads_no_sizes(arrays, jax_graph):
    session, graph = _port(arrays)
    first = graph.cypher(GROUPED, {"age": 30})
    assert first.metrics["size_syncs"] >= 2
    assert session.fused.last_mode == "record"
    again = graph.cypher(GROUPED, {"age": 30})
    assert session.fused.last_mode == "replay"
    assert again.metrics["size_syncs"] == 0
    assert again.metrics["plan_cache"] == "hit"
    assert again.metrics["fused_generic_replays"] == 0
    want = jax_graph.cypher(GROUPED, {"age": 30}).records.to_maps()
    assert first.records.to_maps() == again.records.to_maps() == want


def test_violation_rerecords_exactly(arrays, jax_graph):
    """Record at a high threshold (few rows), then query a low one: the
    generic replay's served row counts are too small, the device check
    trips, and the query re-records with exact results."""
    q = ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age > $min "
         "RETURN b.city AS city, count(*) AS n")
    session, graph = _port(arrays)
    graph.cypher(q, {"min": 88}).records.to_maps()
    result = graph.cypher(q, {"min": 20})
    assert session.fused.mismatches == 1
    assert session.fused.last_mode == "record"
    assert result.metrics["size_syncs"] > 1
    want = jax_graph.cypher(q, {"min": 20}).records.to_maps()
    assert _bag(result.records.to_maps()) == _bag(want)
    # the merged stream now covers both: a value in between replays
    mid = graph.cypher(q, {"min": 50})
    assert session.fused.last_mode == "replay_gen"
    assert _bag(mid.records.to_maps()) == _bag(
        jax_graph.cypher(q, {"min": 50}).records.to_maps())


@pytest.mark.parametrize("poison", ["truncated", "surplus"])
def test_poisoned_memo_recovers(poison, arrays):
    session, graph = _port(arrays)
    first = graph.cypher(GROUPED, {"age": 30}).records.to_maps()
    (key, (plen, sizes, deps)), = session.fused._memo.items()
    assert sizes
    session.fused._memo[key] = (plen, sizes[:1] if poison == "truncated"
                                else list(sizes) + [("rows", 7)], deps)
    assert graph.cypher(GROUPED, {"age": 30}).records.to_maps() == first
    assert session.fused.mismatches == 1
    # re-recorded: replays work again
    assert graph.cypher(GROUPED, {"age": 30}).records.to_maps() == first
    assert session.fused.last_mode == "replay"


def test_determinism_check_rides_replay(arrays, jax_graph):
    session, graph = _port(arrays, determinism_check=True)
    result = graph.cypher(GROUPED, {"age": 30})
    assert "determinism_digest" in result.metrics
    assert session.fused.replays >= 1
    assert result.records.to_maps() == jax_graph.cypher(
        GROUPED, {"age": 30}).records.to_maps()


def test_fused_off_by_config(arrays, jax_graph):
    session, graph = _port(arrays, use_fused=False)
    for age in (30, 30):
        result = graph.cypher(GROUPED, {"age": age})
        assert result.metrics["size_syncs"] >= 2
        assert "fused_generic_replays" not in result.metrics
        assert result.records.to_maps() == jax_graph.cypher(
            GROUPED, {"age": age}).records.to_maps()
    assert session.fused.recordings == 0 and session.fused.replays == 0
    assert session.fused.last_mode is None


def test_catalog_store_never_replays_stale_sizes():
    """Storing a new graph under a catalog name changes the sizes a
    FROM GRAPH query sees; an exact replay must not serve the sizes
    recorded for the old graph.  (The JAX package's fused executor keys
    its exact memo without the catalog and returns the old graph's row
    count here — ROADMAP Queue 3.)"""
    session = caps_tpu_torch.local_session(device="cpu")

    def graph(ages):
        return graph_from_numpy(
            session, {"Person": {"_id": np.arange(len(ages), dtype=np.int64),
                                 "age": np.array(ages, dtype=np.int64)}}, {})

    q = ("FROM GRAPH session.g MATCH (n:Person) WHERE n.age > 0 "
         "RETURN n.age AS a")
    session.catalog.store("g", graph([1]))
    assert session.cypher(q).records.to_maps() == [{"a": 1}]
    session.catalog.store("g", graph([1, 2]))
    assert sorted(r["a"] for r in session.cypher(q).records.to_maps()) \
        == [1, 2]
    assert session.cypher(q).records.to_maps() != [{"a": 1}]
    assert session.fused.last_mode == "replay"


def test_catalog_store_never_answers_from_stale_count_closures():
    """Storing a new graph under a catalog name must not be answered
    from the old graph's count closures or static arrays (they key on
    the graph object's epoch, never on its name or ``id()``)."""
    import gc
    from tests.test_torch_count_pushdown import edges, op_strategy
    session = caps_tpu_torch.local_session(device="cpu")
    q = "MATCH (a:P)-[:K]->(b)-[:K]->(c) RETURN count(*) AS c"
    nodes = {"P": {"_id": np.arange(4, dtype=np.int64)}}
    session.catalog.store("g", graph_from_numpy(
        session, nodes, {"K": edges([(0, 1), (1, 2)])}))
    for mode in ("record", "replay"):
        res = session.catalog.graph("g").cypher(q)
        assert res.records.to_maps() == [{"c": 1}]
        assert session.fused.last_mode == mode
    session.catalog.store("g", graph_from_numpy(
        session, nodes, {"K": edges([(0, 1), (1, 2), (1, 3), (2, 3)])}))
    gc.collect()
    res = session.catalog.graph("g").cypher(q)
    assert res.records.to_maps() == [{"c": 3}]
    assert op_strategy(res, "CountPattern") == "fused-spmv"
    assert len(session.backend.fused_count_static) == 2
    # the FROM GRAPH form (the matcher leaves it on the cascade) agrees
    assert session.cypher("FROM GRAPH session.g " + q).records.to_maps() \
        == [{"c": 3}]


def test_unrelated_catalog_store_keeps_exact_replays(arrays):
    """Catalog staleness is scoped as the plan cache scopes it: storing
    a graph no query read leaves every exact replay in place, while a
    FROM GRAPH query's memo goes with the graph its name held."""
    session, graph = _port(arrays)
    graph.cypher(GROUPED, {"age": 30}).records.to_maps()
    other = graph_from_numpy(session, {"Person": {
        "_id": np.arange(3, dtype=np.int64),
        "age": np.array([5, 6, 7], dtype=np.int64)}}, {})
    session.catalog.store("other", other)
    q = ("FROM GRAPH session.other MATCH (n:Person) WHERE n.age > 5 "
         "RETURN n.age AS a ORDER BY a")
    assert session.cypher(q).records.to_maps() == [{"a": 6}, {"a": 7}]
    assert len(session.fused._memo) == 2
    session.catalog.store("unrelated", other)
    assert len(session.fused._memo) == 2
    again = graph.cypher(GROUPED, {"age": 30})
    assert session.fused.last_mode == "replay"
    assert again.metrics["size_syncs"] == 0
    session.catalog.delete("other")
    assert len(session.fused._memo) == 1
    assert session.fused.evict_dependents(None) == 0


def _lattice_buckets(which):
    return (ShapeBucketLattice() if which == "port" else JaxLattice()).bucket


# (merged so far, new recording): the merge rules of param-generic replay
MERGE_CASES = {
    "tag_mismatch": ([("rows", 5)], [("size", 5, "exact")]),
    "length_mismatch": ([("rows", 5)], [("rows", 5), ("rows", 1)]),
    "rows_widen_to_bucket": ([("rows", 100), ("rows", 40)],
                             [("rows", 300), ("rows", 20)]),
    "rows_past_last_bucket": ([("rows", 5)], [("rows", 3_000_000)]),
    "cap_takes_max": ([("size", 10, "cap")], [("size", 30, "cap")]),
    "lo_takes_min": ([("size", 10, "lo")], [("size", 3, "lo")]),
    "stat_takes_latest": ([("size", 10, "stat")], [("size", 2, "stat")]),
    "exact_agree": ([("size", 4, "exact")], [("size", 4, "exact")]),
    "exact_disagree": ([("size", 4, "exact")], [("size", 5, "exact")]),
    "relation_mismatch": ([("size", 4, "cap")], [("size", 4, "lo")]),
    "rows_keep_max": ([("rows", 900), ("size", 2, "stat")],
                      [("rows", 30), ("size", 7, "stat")]),
}


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_streams_matches_jax(case):
    merged, rec = MERGE_CASES[case]
    got = _merge_streams(list(merged), list(rec),
                         widen_rows=_lattice_buckets("port"))
    want = jax_merge_streams(list(merged), list(rec),
                             widen_rows=_lattice_buckets("jax"))
    assert got == want
    assert (got is None) == (case in ("tag_mismatch", "length_mismatch",
                                      "exact_disagree", "relation_mismatch"))
    if case == "rows_widen_to_bucket":
        assert got == [("rows", 1024), ("rows", 40)]
    if case == "rows_keep_max":
        assert got == [("rows", 900), ("size", 7, "stat")]


# -- the consume relations, call by call, against the JAX backend ------------

# one query's data-dependent reads: (call, value at record time, relation)
RECORDED = [("count", 5, "exact"), ("rows", 100, None), ("count", 7, "cap"),
            ("count", 3, "lo"), ("pred", True, None), ("count", 9, "stat")]

# actual values under a later generic replay, and whether a served value
# is then wrong for its relation
GENERIC = {
    "within_bounds": ([5, 60, 7, 4, True, 1], False),
    "rows_exceed": ([5, 101, 7, 3, True, 9], True),
    "cap_exceed": ([5, 100, 8, 3, True, 9], True),
    "lo_below": ([5, 100, 7, 2, True, 9], True),
    "exact_differs": ([6, 100, 7, 3, True, 9], True),
    "branch_differs": ([5, 100, 7, 3, False, 9], True),
    "stat_differs": ([5, 100, 7, 3, True, 0], False),
}


def _drive(backend, values, scalar):
    """Run RECORDED's calls with the given actual values; returns what
    each call handed back."""
    out = []
    for (call, _v, relation), actual in zip(RECORDED, values):
        if call == "count":
            out.append(backend.consume_count(scalar(actual), relation))
        elif call == "rows":
            n, live = backend.consume_rows(scalar(actual))
            out.append((n, None if live is None else int(live)))
        else:
            out.append(backend.consume_pred(
                bool(RECORDED[4][1]), lambda: scalar(actual)))
    return out


def _backends():
    import jax.numpy as jnp
    import torch
    from caps_tpu.backends.tpu.table import DeviceBackend as JaxBackend
    from caps_tpu.okapi.config import EngineConfig as JaxConfig
    from caps_tpu_torch.backends.cuda.table import DeviceBackend
    return ((JaxBackend(JaxConfig()), jnp.asarray),
            (DeviceBackend(EngineConfig(), torch.device("cpu")),
             torch.tensor))


@pytest.mark.parametrize("case", list(GENERIC))
def test_consume_relations_match_jax(case):
    actual, violated = GENERIC[case]
    recorded = [v for _c, v, _r in RECORDED]
    results = []
    for backend, scalar in _backends():
        entries = []
        backend.count_mode = ("record", entries)
        rec_out = _drive(backend, recorded, scalar)
        backend.count_mode = ("replay", entries, [0])
        syncs = backend.syncs
        replay_out = _drive(backend, actual, scalar)
        assert backend.syncs == syncs   # replay reads nothing
        backend.count_mode = ("replay_gen", entries, [0])
        backend._replay_viol = None
        gen_out = _drive(backend, actual, scalar)
        backend.count_mode = None
        results.append((entries, rec_out, replay_out, gen_out,
                        bool(backend._replay_viol)))
    assert results[0] == results[1]
    assert results[1][4] == violated


def test_generic_replay_reads_once_and_primes_materialization(arrays):
    session, graph = _port(arrays)
    graph.cypher(GROUPED, {"age": 30}).records.to_maps()
    result = graph.cypher(GROUPED, {"age": 31})
    if session.fused.last_mode != "replay_gen":   # a violation re-recorded
        result = graph.cypher(GROUPED, {"age": 45})
    assert session.fused.last_mode == "replay_gen"
    assert result.metrics["size_syncs"] == 1
    assert result.metrics["fused_generic_replays"] == 1
    syncs = session.backend.syncs
    rows = result.records.to_maps()
    assert session.backend.syncs == syncs   # the count was read with the flag
    assert result.records.size() == len(rows)


def test_degraded_no_fused_leaves_the_memo_alone(arrays):
    session, graph = _port(arrays)
    res = session.cypher_degraded(graph, GROUPED, {"age": 30},
                                  no_fused=True)
    assert res.metrics["size_syncs"] >= 2
    assert "fused_generic_replays" not in res.metrics
    assert session.fused.recordings == 0 and not session.fused._memo


def test_transient_device_error_during_replay_keeps_the_memo(arrays,
                                                             monkeypatch):
    """A device out-of-memory error says nothing about the recording: it
    propagates for the caller to retry, the memo stays and counts no
    mismatch, and the retry replays."""
    import torch
    from caps_tpu_torch.serve.failure import FATAL, TRANSIENT, classify
    session, graph = _port(arrays)
    first = graph.cypher(GROUPED, {"age": 30}).records.to_maps()
    real = session.backend.consume_rows

    def oom_once(dev_scalar):
        monkeypatch.setattr(session.backend, "consume_rows", real)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(session.backend, "consume_rows", oom_once)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        graph.cypher(GROUPED, {"age": 30})
    assert session.fused.mismatches == 0 and len(session.fused._memo) == 1
    assert graph.cypher(GROUPED, {"age": 30}).records.to_maps() == first
    assert session.fused.last_mode == "replay"
    assert classify(torch.cuda.OutOfMemoryError("x")) == TRANSIENT
    assert classify(KeyError("missing parameter $age")) == FATAL


def test_forget_drops_exact_and_generic_memos(arrays):
    """``FusedExecutor.forget(graph, query)``: both memo levels of that
    (graph, query) go, so its next run records; another query's memo and
    another graph's stay."""
    session, graph = _port(arrays)
    _, other = _port(arrays)
    q1 = QUERIES["min_max_by_city"][0]
    q2 = "MATCH (a:Person) WHERE a.age = $age RETURN count(*) AS c"
    for age in (30, 31):
        graph.cypher(q1, {"age": age})
    graph.cypher(q2, {"age": 30})
    fused = session.fused
    assert fused.forget(other, q1) == 0         # never ran there
    assert fused.forget(graph, q1) == 3         # two exact, one generic
    assert fused.forget(graph, q1) == 0
    graph.cypher(q1, {"age": 30})
    assert fused.last_mode == "record"
    graph.cypher(q2, {"age": 30})
    assert fused.last_mode == "replay"
