"""The port's prepared statements and session-level LRU plan cache
(caps_tpu_torch/relational/plan_cache.py) — the cases of
tests/test_plan_cache.py that touch ported features, with results held
against the JAX package on the same graph.

Contract: a cached plan executed with new parameter bindings returns the
records a fresh cold-path run returns; catalog mutations evict dependent
entries; eviction is LRU at ``plan_cache_size``."""
import numpy as np
import pytest

import caps_tpu
import caps_tpu_torch
from caps_tpu.okapi.types import CTInteger, CTString
from caps_tpu.relational.entity_tables import (
    NodeMapping, NodeTable, RelationshipMapping, RelationshipTable,
)
from caps_tpu.relational.plan_cache import \
    param_signature as jax_param_signature
from caps_tpu_torch.interop import graph_from_numpy
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.relational.plan_cache import param_signature
from caps_tpu_torch.relational.session import degraded_execution

# Alice 33, Bob 44, Carol 27; Alice->Bob, Bob->Carol, Alice->Carol
NODES = {"Person": {"_id": np.array([1, 2, 3], dtype=np.int64),
                    "name": ["Alice", "Bob", "Carol"],
                    "age": np.array([33, 44, 27], dtype=np.int64)}}
RELS = {"KNOWS": {"_id": np.array([10, 11, 12], dtype=np.int64),
                  "_src": np.array([1, 2, 1], dtype=np.int64),
                  "_tgt": np.array([2, 3, 3], dtype=np.int64),
                  "since": np.array([2011, 2015, 2019], dtype=np.int64)}}


def _session(**cfg):
    return caps_tpu_torch.local_session(
        device="cpu", config=EngineConfig(**cfg) if cfg else None)


def _social(session):
    return graph_from_numpy(session, NODES, RELS)


@pytest.fixture(scope="module")
def jax_social():
    session = caps_tpu.local_session(backend="local")
    f = session.table_factory
    p, k = NODES["Person"], RELS["KNOWS"]
    people = NodeTable(
        NodeMapping.on("_id").with_implied_labels("Person")
        .with_property("name").with_property("age"),
        f.from_columns({"_id": p["_id"].tolist(), "name": p["name"],
                        "age": p["age"].tolist()},
                       {"_id": CTInteger, "name": CTString,
                        "age": CTInteger}))
    knows = RelationshipTable(
        RelationshipMapping.on("KNOWS").with_property("since"),
        f.from_columns({c: k[c].tolist() for c in k},
                       {c: CTInteger for c in k}))
    return session.create_graph([people], [knows])


def _rows(result):
    return result.records.to_maps()


def _bag(rows):
    return sorted(sorted(r.items()) for r in rows)


def _graph_of(ages, session):
    return graph_from_numpy(
        session, {"Person": {"_id": np.arange(len(ages), dtype=np.int64),
                             "age": np.array(ages, dtype=np.int64)}}, {})


# -- cached results == cold-path results == the JAX package's ----------------

def test_cached_plan_matches_cold_run_and_jax_per_binding(jax_social):
    session = _session()
    graph = _social(session)
    q = ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age > $min "
         "RETURN a.name AS a, b.name AS b")
    for min_age in (30, 40, 20, 50, 30):
        got = graph.cypher(q, {"min": min_age})
        with degraded_execution(no_plan_cache=True):
            cold = graph.cypher(q, {"min": min_age})
        assert cold.metrics["plan_cache"] == "off"
        want = jax_social.cypher(q, {"min": min_age})
        assert _bag(_rows(got)) == _bag(_rows(cold)) == _bag(_rows(want))
    stats = session.plan_cache.stats()
    assert stats["hits"] >= 4 and stats["misses"] == 1


def test_hit_skips_every_planning_phase(jax_social):
    session = _session()
    graph = _social(session)
    q = "MATCH (p:Person) WHERE p.age > $x RETURN p.name AS n ORDER BY n"
    miss = graph.cypher(q, {"x": 30})
    assert miss.metrics["plan_cache"] == "miss"
    assert miss.metrics["plan_s"] > 0
    hit = graph.cypher(q, {"x": 40})
    assert hit.metrics["plan_cache"] == "hit"
    assert (hit.metrics["parse_s"] + hit.metrics["ir_s"]
            + hit.metrics["plan_s"] + hit.metrics["relational_s"]) == 0.0
    assert hit.metrics["plan_cache_saved_s"] > 0
    assert _rows(hit) == _rows(jax_social.cypher(q, {"x": 40})) \
        == [{"n": "Bob"}]
    # explain still renders from the cached plans
    assert "=== RELATIONAL ===" in hit.explain()


def test_runtime_bound_limit(jax_social):
    session = _session()
    graph = _social(session)
    lim = "MATCH (p:Person) RETURN p.name AS n ORDER BY n LIMIT $k"
    assert [r["n"] for r in _rows(graph.cypher(lim, {"k": 1}))] == ["Alice"]
    res = graph.cypher(lim, {"k": 2})
    assert res.metrics["plan_cache"] == "hit"
    assert _rows(res) == _rows(jax_social.cypher(lim, {"k": 2})) \
        == [{"n": "Alice"}, {"n": "Bob"}]


@pytest.mark.parametrize("value", [
    1, -7, "a", "", 1.5, True, False, None, [1, 2], [], ["a", "b"],
    [1, "a"], {"k": 1}, {"a": [1], "b": "x"}, [[1], [2]],
], ids=repr)
def test_param_signature_agrees_with_jax(value):
    params = {"x": value, "y": 3}
    assert param_signature(params) == jax_param_signature(params)


def test_param_signature_keys_by_coarse_type():
    session = _session()
    q = "RETURN $x AS x"
    assert _rows(session.cypher(q, {"x": 1})) == [{"x": 1}]
    assert _rows(session.cypher(q, {"x": "a"})) == [{"x": "a"}]
    assert _rows(session.cypher(q, {"x": 2})) == [{"x": 2}]
    stats = session.plan_cache.stats()
    # int and string signatures plan separately; the second int hits
    assert stats["misses"] == 2 and stats["hits"] == 1
    assert stats["entries"] == 2


# -- normalization ---------------------------------------------------------

def test_whitespace_and_comments_normalize_to_one_entry():
    session = _session()
    graph = _social(session)
    r1 = graph.cypher("MATCH (p:Person) RETURN count(*) AS c")
    r2 = graph.cypher(
        "MATCH  (p:Person)  // comment\n   RETURN count(*)   AS c")
    assert r2.metrics["plan_cache"] == "hit"
    assert _rows(r1) == _rows(r2) == [{"c": 3}]
    assert session.plan_cache.stats()["entries"] == 1


def test_string_literals_do_not_falsely_normalize():
    session = _session()
    assert _rows(session.cypher("RETURN 'a b' AS s")) == [{"s": "a b"}]
    assert _rows(session.cypher("RETURN 'a  b' AS s")) == [{"s": "a  b"}]
    assert session.plan_cache.stats()["entries"] == 2


# -- invalidation ----------------------------------------------------------

def test_catalog_store_and_delete_evict_dependents():
    session = _session()
    session.catalog.store("g", _graph_of([1], session))
    q = "FROM GRAPH session.g MATCH (n:Person) RETURN count(*) AS c"
    assert _rows(session.cypher(q)) == [{"c": 1}]
    assert session.cypher(q).metrics["plan_cache"] == "hit"
    before = session.plan_cache.stats()

    # replacing the stored graph evicts its dependents
    session.catalog.store("g", _graph_of([1, 2], session))
    after = session.plan_cache.stats()
    assert after["invalidations"] > before["invalidations"]
    assert after["entries"] == before["entries"] - 1
    res = session.cypher(q)
    assert res.metrics["plan_cache"] == "miss"
    assert _rows(res) == [{"c": 2}]

    # CATALOG DELETE through the query surface also evicts
    session.cypher("CATALOG DELETE GRAPH session.g")
    assert session.plan_cache.stats()["invalidations"] \
        > after["invalidations"]
    with pytest.raises(Exception):
        session.cypher(q)


def test_catalog_eviction_is_scoped():
    """Storing an UNRELATED graph leaves another name's dependents
    cached; mutating the referenced name evicts them."""
    session = _session()
    session.catalog.store("base", _graph_of([5], session))
    q = "FROM GRAPH session.base MATCH (n) RETURN count(*) AS c"
    assert _rows(session.cypher(q)) == [{"c": 1}]
    entries = session.plan_cache.stats()["entries"]
    session.catalog.store("other", _graph_of([1, 2, 3], session))
    assert session.plan_cache.stats()["entries"] == entries
    res = session.cypher(q)
    assert res.metrics["plan_cache"] == "hit"
    assert _rows(res) == [{"c": 1}]
    session.catalog.store("base", _graph_of([5, 6], session))
    res = session.cypher(q)
    assert res.metrics["plan_cache"] == "miss"
    assert _rows(res) == [{"c": 2}]


# -- LRU -------------------------------------------------------------------

def test_lru_eviction_at_plan_cache_size():
    session = _session(plan_cache_size=2)
    graph = _social(session)
    q1 = "MATCH (n:Person) RETURN count(*) AS c"
    q2 = "MATCH (n:Person) WHERE n.age > 30 RETURN count(*) AS c"
    q3 = "MATCH (n:Person) WHERE n.age < 30 RETURN count(*) AS c"
    graph.cypher(q1)
    graph.cypher(q2)
    graph.cypher(q3)  # evicts q1 (LRU)
    stats = session.plan_cache.stats()
    assert stats["entries"] == 2 and stats["evictions"] == 1
    assert graph.cypher(q3).metrics["plan_cache"] == "hit"
    assert graph.cypher(q1).metrics["plan_cache"] == "miss"
    assert _rows(graph.cypher(q1)) == [{"c": 3}]


# -- degraded execution / config toggles -----------------------------------

def test_degraded_execution_bypasses_the_cache_both_ways():
    session = _session()
    graph = _social(session)
    q = "MATCH (n:Person) WHERE n.age > $a RETURN count(*) AS c"
    res = session.cypher_degraded(graph, q, {"a": 30})
    assert res.metrics["plan_cache"] == "off"
    assert session.plan_cache.stats()["entries"] == 0   # nothing stored
    assert graph.cypher(q, {"a": 30}).metrics["plan_cache"] == "miss"
    with degraded_execution():
        assert graph.cypher(q, {"a": 40}).metrics["plan_cache"] == "off"
    assert _rows(graph.cypher(q, {"a": 40})) == [{"c": 1}]


def test_plan_cache_off_by_config():
    session = _session(use_plan_cache=False)
    graph = _social(session)
    q = "MATCH (n:Person) RETURN count(*) AS c"
    assert graph.cypher(q).metrics["plan_cache"] == "off"
    assert graph.cypher(q).metrics["plan_cache"] == "off"
    assert session.plan_cache.stats()["hits"] == 0
    assert session.plan_cache.stats()["entries"] == 0


def test_both_flags_default_on():
    cfg = EngineConfig()
    assert cfg.use_fused and cfg.use_plan_cache
    assert "use_fused" not in cfg.UNPORTED_FLAGS
    assert "use_plan_cache" not in cfg.UNPORTED_FLAGS


# -- prepared statement API ------------------------------------------------

def test_prepared_query_api(jax_social):
    session = _session()
    graph = _social(session)
    text = ("MATCH (p:Person) WHERE p.age >= $min "
            "RETURN p.name AS n ORDER BY n")
    prep = graph.prepare(text)
    assert [r["n"] for r in _rows(prep.run({"min": 40}))] == ["Bob"]
    res = prep.run({"min": 30})
    assert res.metrics["plan_cache"] == "hit"
    assert _rows(res) == _rows(jax_social.cypher(text, {"min": 30})) \
        == [{"n": "Alice"}, {"n": "Bob"}]
    # session.prepare on the ambient graph
    p2 = session.prepare("RETURN $v AS v")
    assert _rows(p2.run({"v": 7})) == [{"v": 7}]
    assert _rows(p2.run({"v": 8})) == [{"v": 8}]


def test_prepare_validates_syntax_eagerly():
    session = _session()
    with pytest.raises(Exception):
        session.prepare("MATCH (n RETURN n")


def test_stats_shape():
    session = _session()
    stats = session.plan_cache.stats()
    assert set(stats) >= {"entries", "hits", "misses", "evictions",
                          "invalidations", "hit_rate",
                          "bytes", "saved_s"}
    snap = session.metrics_snapshot()
    assert snap["plan_cache.entries"] == 0
    assert {"backend.syncs", "fused.recordings", "fused.replays",
            "fused.generic_replays", "fused.mismatches"} <= set(snap)


@pytest.mark.parametrize("value", [
    1, "a", 1.5, True, None, b"x", [1, 2], list(range(300)), (1,),
    {1, 2}, {"k": 1, "a": 2}, object(),
], ids=lambda v: type(v).__name__ + str(len(v) if hasattr(v, "__len__")
                                         else ""))
def test_param_shape_signature_agrees_with_jax(value):
    from caps_tpu.relational.shapes import (
        ShapeBucketLattice as JaxLattice, param_shape_signature as jax_sig,
        signature_text as jax_text)
    from caps_tpu_torch.relational.shapes import (
        ShapeBucketLattice, param_shape_signature, signature_text)
    params = {"v": value, "n": 3}
    got = param_shape_signature(params, lattice=ShapeBucketLattice())
    want = jax_sig(params, lattice=JaxLattice())
    assert got == want
    assert signature_text(got) == jax_text(want)


def test_shape_lattice_is_the_padding_ladder():
    session = _session()
    assert session.backend.shapes is session.shape_lattice
    assert session.backend.bucket(300) == 1024
    assert session.shape_lattice.seed([300, 5000]) == 2
    assert session.backend.bucket(300) == 512
    assert session.shape_lattice.seed([300]) == 0


def test_evict_family_drops_every_plan_of_one_query_text():
    """``PlanCache.evict_family`` (the re-plan loop's retirement): every
    cached plan whose normalized text is the family goes — under any
    parameter signature — and is counted as quarantined; other families
    stay cached and hit."""
    session = _session()
    g = _social(session)
    q1 = "MATCH (a:Person) WHERE a.age > $x RETURN a.name AS n"
    q2 = "MATCH (a:Person) RETURN a.name AS n"
    g.cypher(q1, {"x": 30})
    g.cypher(q1, {"x": "thirty"})      # a second parameter signature
    g.cypher(q2)
    assert session.plan_cache.stats()["entries"] == 3
    from caps_tpu_torch.frontend.parser import normalize_query
    dropped = session.plan_cache.evict_family(normalize_query(q1))
    assert len(dropped) == 2
    assert {p.query_text for p in dropped} == {q1}
    stats = session.plan_cache.stats()
    assert stats["entries"] == 1 and stats["quarantined"] == 2
    assert session.plan_cache.evict_family(normalize_query(q1)) == []
    assert g.cypher(q1, {"x": 30}).metrics["plan_cache"] == "miss"
    assert g.cypher(q2).metrics["plan_cache"] == "hit"
