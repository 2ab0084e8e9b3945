"""Graph-algorithm procedures of the port (``CALL algo.*``,
caps_tpu_torch/algo/) against the JAX package.

One counterpart for each test of ``tests/test_algo.py``: the same
seeded graphs go into a CPU session of the port
(``local_session(device="cpu")``, which runs the torch fixpoint on CPU
tensors) and into the JAX package's device backend and its local
(NumPy-oracle) backend, and the rows must be equal — float scores after
the 9-decimal quantization both packages apply — with equal iteration
counts and ``converged``.  The port has no degraded host fallback: an
injected device fault raises, and under ``QueryServer`` the retry
ladder answers it on a later execution.

Module-level tests hold the port's ``algo/fixpoint.py`` programs to the
JAX ``build_program`` / ``build_dense_program`` on random graphs, both
layouts, with exact equality of the quantized outputs and of the
iteration counts, at ``max_iterations`` cut-offs, and with the state
frozen on the device after ``done``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caps_tpu_torch
from caps_tpu.algo import fixpoint as JF
from caps_tpu.algo import registry as jax_registry
from caps_tpu.backends.local.session import LocalCypherSession
from caps_tpu.backends.tpu.session import TPUCypherSession
from caps_tpu.relational.session import result_digest as jax_digest
from caps_tpu_torch.algo import fixpoint as F
from caps_tpu_torch.algo import kernels, registry
from caps_tpu_torch.frontend.semantic import CypherSemanticError
from caps_tpu_torch.obs.metrics import global_registry
from caps_tpu_torch.okapi.types import CTInteger, from_python, join_all
from caps_tpu_torch.relational.entity_tables import (
    NodeMapping, NodeTable, RelationshipMapping, RelationshipTable,
)
from caps_tpu_torch.relational.session import result_digest
from caps_tpu_torch.testing import faults
from tests.util import make_graph as jax_make_graph


def _infer_types(rows: List[Mapping[str, Any]]):
    keys = sorted({k for r in rows for k in r})
    out = {}
    for k in keys:
        vals = [r.get(k) for r in rows]
        t = join_all(from_python(v) for v in vals if v is not None)
        if any(v is None or k not in r for v, r in zip(vals, rows)):
            t = t.nullable
        out[k] = t
    return out


def port_make_graph(session, nodes: Mapping[Tuple[str, ...], List[dict]],
                    rels: Mapping[str, List[Tuple[int, int, dict]]],
                    start_rel_id: int = 1000):
    """``tests/util.py make_graph`` on the port's classes: the same
    tables from the same rows, relationship ids from 1000 in order."""
    factory = session.table_factory
    node_tables = []
    for labels, rows in nodes.items():
        props = _infer_types([{k: v for k, v in r.items() if k != "_id"}
                              for r in rows])
        data = {"_id": [r["_id"] for r in rows]}
        for k in props:
            data[k] = [r.get(k) for r in rows]
        table = factory.from_columns(data, {"_id": CTInteger, **props})
        mapping = NodeMapping.on("_id").with_implied_labels(*labels)
        for k in props:
            mapping = mapping.with_property(k)
        node_tables.append(NodeTable(mapping, table))
    rel_tables = []
    rid = start_rel_id
    for rel_type, edges in rels.items():
        props = _infer_types([e[2] for e in edges])
        data: Dict[str, list] = {"_id": [], "_src": [], "_tgt": []}
        for k in props:
            data[k] = []
        for src, tgt, p in edges:
            data["_id"].append(rid)
            rid += 1
            data["_src"].append(src)
            data["_tgt"].append(tgt)
            for k in props:
                data[k].append(p.get(k))
        types = {"_id": CTInteger, "_src": CTInteger, "_tgt": CTInteger,
                 **props}
        mapping = RelationshipMapping.on(rel_type)
        for k in props:
            mapping = mapping.with_property(k)
        rel_tables.append(RelationshipTable(
            mapping, factory.from_columns(data, types)))
    return session.create_graph(node_tables, rel_tables)


def port_session():
    return caps_tpu_torch.local_session(device="cpu")


# the three engines of every parity test: the port, the JAX device
# backend, the JAX local (NumPy-oracle) backend
def three(build):
    return (build(port_session(), port_make_graph),
            build(TPUCypherSession(), jax_make_graph),
            build(LocalCypherSession(), jax_make_graph))


def _random_graph(session, make, n=60, e=240, seed=7, self_loops=True,
                  weighted=True):
    rng = np.random.RandomState(seed)
    nodes = {("P",): [{"_id": i, "name": f"n{i % 11}"} for i in range(n)]}
    edges = [(int(rng.randint(n)), int(rng.randint(n)),
              ({"w": float(1 + (i % 5))} if weighted else {}))
             for i in range(e)]
    if not self_loops:
        edges = [(a, b, p) for a, b, p in edges if a != b]
    return make(session, nodes, {"K": edges})


def _two_islands(session, make):
    """Two disconnected components (0-1-2 and 3-4), plus an isolate."""
    nodes = {("P",): [{"_id": i} for i in range(6)]}
    edges = [(0, 1, {}), (1, 2, {}), (3, 4, {})]
    return make(session, nodes, {"K": edges})


PROCEDURE_QUERIES = [
    "CALL algo.degree() YIELD node, degree "
    "RETURN node, degree ORDER BY node",
    "CALL algo.pagerank() YIELD node, score "
    "RETURN node, score ORDER BY node",
    "CALL algo.wcc() YIELD node, component "
    "RETURN node, component ORDER BY node",
    "CALL algo.bfs(0) YIELD node, dist RETURN node, dist ORDER BY node",
    "CALL algo.sssp(0, 'w') YIELD node, dist "
    "RETURN node, dist ORDER BY node",
]


def _algo_op(result):
    return [m for m in result.metrics["operators"]
            if m["op"] == "AlgoProcedure"]


def _stats(result):
    (op,) = _algo_op(result)
    return {k: op[k] for k in ("strategy", "layout", "iterations",
                               "converged", "procedure")}


def rows_of(graph, query, params=None):
    return graph.cypher(query, params or {}).records.to_maps()


def assert_same(graphs, query):
    """Rows equal across the three engines, and the port's PROFILE
    statistics equal the JAX device backend's."""
    port, dev, local = graphs
    want = rows_of(local, query)
    assert rows_of(dev, query) == want, query
    assert rows_of(port, query) == want, query
    assert _stats(port.cypher("PROFILE " + query)) == \
        _stats(dev.cypher("PROFILE " + query)), query


# -- cross-backend parity (the oracle contract) ----------------------------

@pytest.mark.parametrize("query", PROCEDURE_QUERIES)
def test_device_matches_local_oracle(query):
    assert_same(three(_random_graph), query)


@pytest.mark.parametrize("query", PROCEDURE_QUERIES)
def test_empty_graph(query):
    s = port_session()
    g = port_make_graph(s, {("P",): []}, {"K": []})
    assert rows_of(g, query) == []
    jg = jax_make_graph(TPUCypherSession(), {("P",): []}, {"K": []})
    assert rows_of(jg, query) == []
    assert _stats(g.cypher("PROFILE " + query))["strategy"] == "host"


def test_self_loops_and_parallel_edges_parity():
    nodes = {("P",): [{"_id": i} for i in range(4)]}
    edges = [(0, 0, {}), (0, 1, {}), (0, 1, {}), (2, 3, {}), (3, 2, {})]
    graphs = three(lambda s, make: make(s, nodes, {"K": edges}))
    for q in PROCEDURE_QUERIES:
        assert_same(graphs, q)
    deg = {r["node"]: r["degree"]
           for r in rows_of(graphs[0], PROCEDURE_QUERIES[0])}
    # node 0: self-loop (1 out + 1 in) + 2 parallel out-edges = 4
    assert deg[0] == 4 and deg[1] == 2 and deg[2] == 2


def _dense(session, make, n=64, m=8192, seed=5):
    rng = np.random.RandomState(seed)
    nodes = {("P",): [{"_id": i} for i in range(n)]}
    edges = [(int(s), int(t), {"w": float(w)}) for s, t, w in
             zip(rng.randint(0, n, m), rng.randint(0, n, m),
                 np.round(rng.rand(m) * 9 + 1, 3))]
    return make(session, nodes, {"K": edges})


def test_dense_tile_layout_parity():
    """A graph dense enough to approach the full capacity tile routes to
    the matrix-product (dense-tile) programs, as in the JAX package,
    and the rows stay the NumPy oracle's."""
    graphs = three(_dense)
    for q in PROCEDURE_QUERIES:
        profiled = graphs[0].cypher("PROFILE " + q)
        (op,) = _algo_op(profiled)
        assert op["strategy"] == "device-fixpoint", q
        assert op["layout"] == "dense-tile", q
        assert_same(graphs, q)
    sparse = _random_graph(port_session(), port_make_graph)
    (op,) = _algo_op(sparse.cypher("PROFILE " + PROCEDURE_QUERIES[1]))
    assert op["layout"] == "edge-list"


def test_sparse_id_space_parity():
    """Node ids far apart (span >> n): the port maps endpoints by binary
    search on the card for every id space — same rows as the JAX
    package's lookup-table and binary-search paths."""
    ids = [0, 70_000, 140_000, 999_999]
    nodes = {("P",): [{"_id": i} for i in ids]}
    edges = [(ids[0], ids[1], {"w": 2.0}), (ids[1], ids[2], {"w": 3.0}),
             (ids[2], ids[3], {"w": 1.0}), (ids[3], ids[0], {"w": 4.0})]
    graphs = three(lambda s, make: make(s, nodes, {"K": edges}))
    for q in PROCEDURE_QUERIES:
        assert_same(graphs, q)
    bfs = ("CALL algo.bfs(0) YIELD node, dist "
           "RETURN node, dist ORDER BY node")
    assert rows_of(graphs[0], bfs) == [
        {"node": 0, "dist": 0}, {"node": 70_000, "dist": 1},
        {"node": 140_000, "dist": 2}, {"node": 999_999, "dist": 3}]


def test_disconnected_components():
    graphs = three(_two_islands)
    q = ("CALL algo.wcc() YIELD node, component "
         "RETURN node, component ORDER BY node")
    assert_same(graphs, q)
    comp = {r["node"]: r["component"] for r in rows_of(graphs[0], q)}
    assert comp[0] == comp[1] == comp[2] == 0
    assert comp[3] == comp[4] == 3
    assert comp[5] == 5  # the isolate is its own component
    bq = "CALL algo.bfs(0) YIELD node, dist RETURN node, dist ORDER BY node"
    assert_same(graphs, bq)
    brows = rows_of(graphs[0], bq)
    assert [r["node"] for r in brows] == [0, 1, 2]
    assert [r["dist"] for r in brows] == [0, 1, 2]


def test_sssp_weighted_vs_unit():
    nodes = {("P",): [{"_id": i} for i in range(4)]}
    edges = [(0, 3, {"w": 10.0}), (0, 1, {"w": 1.0}),
             (1, 2, {"w": 1.0}), (2, 3, {"w": 1.0})]
    port, dev, local = three(lambda s, make: make(s, nodes, {"K": edges}))
    q = ("CALL algo.sssp(0, 'w') YIELD node, dist "
         "RETURN node, dist ORDER BY node")
    q_unit = ("CALL algo.sssp(0, 'nope') YIELD node, dist "
              "RETURN node, dist ORDER BY node")
    for g in (port, dev, local):
        assert [r["dist"] for r in rows_of(g, q)] == [0.0, 1.0, 2.0, 3.0]
        assert [r["dist"] for r in rows_of(g, q_unit)] == \
            [0.0, 1.0, 2.0, 1.0]  # the direct hop 0->3 wins unweighted


def test_bfs_absent_source_yields_nothing():
    for g in three(_two_islands):
        assert rows_of(g, "CALL algo.bfs(999) YIELD node, dist "
                          "RETURN node, dist") == []


def test_degree_directions():
    nodes = {("P",): [{"_id": i} for i in range(3)]}
    edges = [(0, 1, {}), (0, 2, {}), (1, 2, {})]
    graphs = three(lambda s, make: make(s, nodes, {"K": edges}))
    for direction, want in (("out", [2, 1, 0]), ("in", [0, 1, 2]),
                            ("both", [2, 2, 2])):
        q = (f"CALL algo.degree('{direction}') YIELD node, degree "
             "RETURN node, degree ORDER BY node")
        assert_same(graphs, q)
        assert [r["degree"] for r in rows_of(graphs[0], q)] == want


def test_pagerank_scores_sum_to_one():
    for g in three(_random_graph):
        rows = rows_of(g, PROCEDURE_QUERIES[1])
        assert abs(sum(r["score"] for r in rows) - 1.0) < 1e-6


# -- delta overlay: live writes visible through the snapshot seam ----------

def test_delta_overlay_parity_after_live_writes():
    """The bridge written between two islands shows in the next CALL,
    with the same digest as the JAX package's; an exact replay of the
    query on the snapshot before the write keeps that snapshot's
    answer, and the query on the new snapshot is recorded anew — a
    fixpoint recorded on the old snapshot is never served."""
    from caps_tpu.relational.updates import versioned as jax_versioned
    from caps_tpu_torch.relational.updates import versioned
    nodes = {("P",): [{"_id": i, "name": f"n{i}"} for i in range(5)]}
    edges = [(0, 1, {}), (1, 2, {})]
    q = ("CALL algo.wcc() YIELD node, component "
         "RETURN node, component ORDER BY node")
    bridge = ["MATCH (a:P), (b:P) WHERE a.name = 'n2' AND b.name = 'n4' "
              "CREATE (a)-[:K]->(b)",
              "MATCH (a:P), (b:P) WHERE a.name = 'n4' AND b.name = 'n3' "
              "CREATE (a)-[:K]->(b)"]
    digests = []
    for make_session, make, vers, digest in (
            (port_session, port_make_graph, versioned, result_digest),
            (TPUCypherSession, jax_make_graph, jax_versioned, jax_digest),
            (LocalCypherSession, jax_make_graph, jax_versioned,
             jax_digest)):
        s = make_session()
        vg = vers(s, make(s, nodes, {"K": edges}))
        before_snap = vg.current() if make is port_make_graph else None
        before = s.cypher_on_graph(vg, q).records.to_maps()
        comp = {r["node"]: r["component"] for r in before}
        assert comp[3] == 3 and comp[4] == 4  # islands before the write
        if before_snap is not None:
            s.cypher_on_graph(before_snap, q)  # recorded on the old one
        for w in bridge:
            s.cypher_on_graph(vg, w)
        after = s.cypher_on_graph(vg, q)
        assert all(r["component"] == 0 for r in after.records.to_maps())
        if before_snap is not None:
            assert s.fused.last_mode == "record"
            again = s.cypher_on_graph(vg, q)
            assert s.fused.last_mode == "replay"
            assert again.records.to_maps() == after.records.to_maps()
            old = s.cypher_on_graph(before_snap, q)
            assert s.fused.last_mode == "replay"
            assert old.records.to_maps() == before
        digests.append(digest(after))
    assert digests[0] == digests[1] == digests[2]


# -- convergence & iteration bounds ----------------------------------------

def test_pagerank_converges_within_bound():
    port, dev, _local = three(_random_graph)
    q = ("PROFILE CALL algo.pagerank(0.85, 60) YIELD node, score "
         "RETURN node, score")
    st = _stats(port.cypher(q))
    assert st["converged"] is True
    assert 0 < st["iterations"] <= 60
    assert st == _stats(dev.cypher(q))


def test_pagerank_max_iteration_cutoff():
    port, dev, local = three(_random_graph)
    r = port.cypher("PROFILE CALL algo.pagerank(0.85, 2, 0.0) "
                    "YIELD node, score RETURN node, score")
    st = _stats(r)
    assert st["iterations"] == 2 and st["converged"] is False
    q = ("CALL algo.pagerank(0.85, 2, 0.0) YIELD node, score "
         "RETURN node, score ORDER BY node")
    assert_same((port, dev, local), q)


# -- composition: YIELD into the relational pipeline -----------------------

def test_yield_composes_with_return_pipeline():
    q = ("CALL algo.wcc() YIELD node, component "
         "WHERE component = 0 "
         "RETURN component, count(*) AS size")
    for g in three(_two_islands):
        assert rows_of(g, q) == [{"component": 0, "size": 3}]


def test_call_after_match_joins_on_yield():
    q = ("MATCH (p:P) CALL algo.degree() YIELD node, degree "
         "WHERE id(p) = node AND degree > 0 "
         "RETURN p.name AS name, degree ORDER BY node")
    graphs = three(lambda s, make: _random_graph(s, make, n=12, e=30))
    rows = rows_of(graphs[0], q)
    assert rows and all(r["degree"] > 0 for r in rows)
    assert rows == rows_of(graphs[1], q) == rows_of(graphs[2], q)


def test_yield_aliases_avoid_rebinding():
    q = ("MATCH (node:P) CALL algo.degree() "
         "YIELD node AS nid, degree AS d "
         "WHERE id(node) = nid RETURN id(node) AS i, d ORDER BY i")
    graphs = three(_two_islands)
    rows = rows_of(graphs[0], q)
    assert [r["i"] for r in rows] == list(range(6))
    assert rows == rows_of(graphs[2], q)


# -- typed semantic errors: the same classes and messages -------------------

def _error_pair(query, port_cls, jax_cls):
    g = _two_islands(port_session(), port_make_graph)
    jg = _two_islands(LocalCypherSession(), jax_make_graph)
    with pytest.raises(port_cls) as pe:
        g.cypher(query)
    with pytest.raises(jax_cls) as je:
        jg.cypher(query)
    assert type(pe.value).__name__ == type(je.value).__name__
    assert str(pe.value) == str(je.value)
    return str(pe.value)


def test_unknown_procedure_names_registered_signatures():
    msg = _error_pair("CALL algo.nope() YIELD node RETURN node",
                      registry.UnknownProcedureError,
                      jax_registry.UnknownProcedureError)
    assert "algo.nope" in msg and "algo.pagerank" in msg
    assert "damping" in msg  # renders full signatures, not just names


def test_arity_mismatch_is_typed_and_names_signature():
    msg = _error_pair("CALL algo.degree('out', 1, 2) YIELD node RETURN node",
                      registry.ProcedureArgumentError,
                      jax_registry.ProcedureArgumentError)
    assert "algo.degree" in msg and "0..1" in msg
    _error_pair("CALL algo.bfs() YIELD node, dist RETURN node",
                registry.ProcedureArgumentError,
                jax_registry.ProcedureArgumentError)


def test_argument_type_mismatch_is_typed():
    msg = _error_pair("CALL algo.bfs('zero') YIELD node, dist RETURN node",
                      registry.ProcedureArgumentError,
                      jax_registry.ProcedureArgumentError)
    assert "algo.bfs" in msg and "INTEGER" in msg and "source" in msg


def test_bad_yield_column_and_rebind_are_typed():
    _error_pair("CALL algo.degree() YIELD node, rank RETURN rank",
                registry.ProcedureYieldError,
                jax_registry.ProcedureYieldError)
    msg = _error_pair("MATCH (node:P) CALL algo.degree() YIELD node, degree "
                      "RETURN degree", CypherSemanticError, Exception)
    assert "alias them with AS" in msg
    assert issubclass(registry.UnknownProcedureError, CypherSemanticError)


# -- compile ledger: once per first-seen shape, then zero ------------------

def test_compile_ledger_once_then_zero():
    s = port_session()
    g = _random_graph(s, port_make_graph)
    q = PROCEDURE_QUERIES[1]  # pagerank: priced onto the device path
    r1 = g.cypher(q)
    charges = [c for c in r1.metrics.get("compile_charges", ())
               if c["kind"] == "algo"]
    assert charges and charges[0]["seconds"] > 0.0
    assert _algo_op(r1)[0]["strategy"] == "device-fixpoint"
    r2 = g.cypher(q)
    assert r2.metrics["compile_s_charged"] == 0.0
    # a second graph landing in the same shape buckets reuses the program
    g2 = _random_graph(s, port_make_graph, seed=11)
    r3 = g2.cypher(q)
    assert [c for c in r3.metrics.get("compile_charges", ())
            if c["kind"] == "algo"] == []


def test_cost_model_note_and_explain_render():
    g = _random_graph(port_session(), port_make_graph)
    jg = _random_graph(TPUCypherSession(), jax_make_graph)
    r = g.cypher("EXPLAIN " + PROCEDURE_QUERIES[1])
    assert "AlgoProcedure(algo.pagerank() YIELD node, score)" \
        in r.plans["relational"]
    assert "algo_strategy: procedure=algo.pagerank, " \
        "chosen=device-fixpoint" in r.plans["cost"]
    note = [ln for ln in r.plans["cost"].splitlines() if "algo_strategy" in ln]
    jnote = [ln for ln in jg.cypher("EXPLAIN " + PROCEDURE_QUERIES[1])
             .plans["cost"].splitlines() if "algo_strategy" in ln]
    assert note == jnote  # same pricing, same launch constant
    tiny = _two_islands(port_session(), port_make_graph)
    rt = tiny.cypher("EXPLAIN " + PROCEDURE_QUERIES[1])
    assert "chosen=host" in rt.plans["cost"]


# -- fault injection: the fault raises, the server retries -----------------

def test_injected_fault_raises_and_is_not_answered_by_the_host():
    """The JAX package answers a device fault from its NumPy kernels
    (``fallback-host``); the port does not: the fault reaches the
    caller, nothing is counted as a fallback, and the next execution
    takes the device path again with the clean rows."""
    s = port_session()
    g = _random_graph(s, port_make_graph)
    q = PROCEDURE_QUERIES[1]
    clean_rows = rows_of(g, q)
    inj0 = global_registry().snapshot().get("faults.injected.algo", 0)
    with faults.failing_algo(n_times=1) as budget:
        with pytest.raises(Exception) as ei:
            g.cypher("PROFILE " + q)
        assert budget.injected == 1
    assert getattr(ei.value, "caps_algo_fault", False) is True
    assert s.metrics_registry.snapshot().get("algo.fallbacks", 0) == 0
    assert global_registry().snapshot()["faults.injected.algo"] == inj0 + 1
    healed = g.cypher("PROFILE " + q)
    assert _algo_op(healed)[0]["strategy"] == "device-fixpoint"
    assert healed.records.to_maps() == clean_rows
    # under the server the retry ladder answers it on a later execution
    from caps_tpu_torch.serve.server import QueryServer, ServerConfig
    with faults.failing_algo(n_times=1) as budget:
        with QueryServer(s, graph=g, config=ServerConfig(workers=1)) as srv:
            handle = srv.submit(q)
            assert handle.rows(timeout=60) == clean_rows
        assert budget.injected == 1


def test_fault_marker_is_stamped():
    class Boom(RuntimeError):
        pass
    s = port_session()
    g = _random_graph(s, port_make_graph)
    with faults.failing_algo(exc=Boom, n_times=1):
        with pytest.raises(Boom) as ei:
            g.cypher(PROCEDURE_QUERIES[1])
    assert ei.value.caps_algo_fault is True
    lg = _random_graph(LocalCypherSession(), jax_make_graph)
    assert rows_of(g, PROCEDURE_QUERIES[1]) == \
        rows_of(lg, PROCEDURE_QUERIES[1])


# -- serve tier: warmed families & snapshot-keyed result cache -------------

def test_server_warmed_algo_family_charges_zero():
    from caps_tpu_torch.relational.result_cache import ResultCacheConfig
    from caps_tpu_torch.serve.server import QueryServer, ServerConfig
    s = port_session()
    g = _random_graph(s, port_make_graph)
    q = PROCEDURE_QUERIES[1]
    cfg = ServerConfig(workers=1,
                       result_cache=ResultCacheConfig(enabled=True))
    with QueryServer(s, graph=g, config=cfg) as server:
        h1 = server.submit(q)
        rows1 = h1.rows(timeout=60)
        assert h1.info["ledger"]["compile_s"] > 0.0
        h2 = server.submit(q)
        assert h2.rows(timeout=60) == rows1
        assert h2.info["ledger"]["compile_s"] == 0.0
        rep = server.warmup_report()
        assert rep["cold_families"] == []
        assert rep["compiled_hot_families"] == rep["hot_families"] == 1
        dump = server.dump_flight_recorder()
        assert dump["records"][-1]["outcome"] == "cache_hit"
        assert h2.info.get("cache") is not None
    lg = _random_graph(LocalCypherSession(), jax_make_graph)
    assert rows1 == rows_of(lg, q)


# -- host kernels as their own oracle (unit level) -------------------------

def test_host_kernels_unit_oracle():
    from caps_tpu.algo import kernels as jax_kernels
    src = np.array([0, 1, 2, 0], dtype=np.int64)
    tgt = np.array([1, 2, 0, 2], dtype=np.int64)
    deg, it, done = kernels.degree(4, src, tgt, "both")
    assert deg.tolist() == [3, 2, 3, 0] and done
    labels, _, done = kernels.wcc(4, src, tgt, 100)
    assert labels.tolist() == [0, 0, 0, 3] and done
    dist, _, done = kernels.bfs(4, src, tgt, 0, -1)
    assert dist[:3].tolist() == [0, 1, 1] and done
    assert dist[3] == kernels.UNREACHED
    r, it, done = kernels.pagerank(4, src, tgt, 0.85, 50, 1e-9)
    assert done and abs(r.sum() - 1.0) < 1e-6
    assert np.array_equal(r, np.round(r, kernels.SCORE_DECIMALS))
    jr, jit_, jdone = jax_kernels.pagerank(4, src, tgt, 0.85, 50, 1e-9)
    assert np.array_equal(r, jr) and (it, done) == (jit_, jdone)


# -- the fixpoint programs against the JAX package's -----------------------

BOUND = {
    "algo.degree": [{"direction": d} for d in ("out", "in", "both")],
    "algo.pagerank": [
        {"damping": 0.85, "max_iterations": 20, "tolerance": 1e-6},
        {"damping": 0.5, "max_iterations": 60, "tolerance": 1e-9}],
    "algo.wcc": [{"max_iterations": 100}],
    "algo.bfs": [{"source_index": 0, "max_depth": -1},
                 {"source_index": 3, "max_depth": -1},
                 {"source_index": -1, "max_depth": -1}],
    "algo.sssp": [{"source_index": 0, "max_iterations": -1},
                  {"source_index": 5, "max_iterations": -1}],
}
# (procedure, bound) cases whose cut-off stops the loop early
CUTOFFS = ([("algo.pagerank", {"damping": 0.85, "max_iterations": k,
                               "tolerance": 0.0}) for k in (0, 1, 2, 5)]
           + [("algo.bfs", {"source_index": 0, "max_depth": k})
              for k in (0, 1, 2)]
           + [("algo.sssp", {"source_index": 0, "max_iterations": k})
              for k in (1, 2)]
           + [("algo.wcc", {"max_iterations": 1})])


def random_arrays(n, e, n_pad, e_pad, seed):
    """Padded edge-list operands as numpy: live lanes first, weights
    with a few negatives (clamped to 0 by both packages)."""
    rng = np.random.RandomState(seed)
    node_mask = np.zeros(n_pad, bool)
    node_mask[:n] = True
    src = np.zeros(e_pad, np.int64)
    tgt = np.zeros(e_pad, np.int64)
    edge_mask = np.zeros(e_pad, bool)
    w = np.zeros(e_pad, np.float64)
    src[:e] = rng.randint(0, n, e)
    tgt[:e] = rng.randint(0, n, e)
    edge_mask[:e] = True
    w[:e] = np.round(rng.rand(e) * 9 - 0.5, 3)
    return node_mask, src, tgt, edge_mask, w


def _quantized(out):
    out = np.asarray(out)
    return np.round(out, kernels.SCORE_DECIMALS) if out.dtype.kind == "f" \
        else out


def run_both(name, bound, n, arrays, dense=False):
    """(port (out, it, done), JAX (out, it, done)) on the same arrays,
    outputs quantized as both operators do."""
    node_mask, src, tgt, edge_mask, w = arrays
    n_pad, e_pad = node_mask.shape[0], src.shape[0]
    jsc = JF.scalar_values(name, bound, n)
    psc = F.scalar_values(name, bound, n)
    t = [torch.from_numpy(a) for a in arrays]
    if dense:
        live = edge_mask
        flat = src[live] * n_pad + tgt[live]
        A = np.bincount(flat, minlength=n_pad * n_pad).reshape(
            n_pad, n_pad).astype(np.float64)
        W = np.full(n_pad * n_pad, np.inf)
        np.minimum.at(W, flat, np.maximum(w[live], 0.0))
        W = W.reshape(n_pad, n_pad)
        jout = JF.build_dense_program(name, n_pad)(
            jnp.asarray(node_mask), jnp.asarray(A), jnp.asarray(W), *jsc)
        pA, pW = F.densify(n_pad, t[1], t[2], t[3], t[4], True)
        assert np.array_equal(pA.numpy(), A)
        assert np.array_equal(pW.numpy(), W)
        pout = F.build_dense_program(name, n_pad)(t[0], pA, pW, *psc)
    else:
        jout = JF.build_program(name, n_pad, e_pad)(
            *[jnp.asarray(a) for a in arrays], *jsc)
        pout = F.build_program(name, n_pad, e_pad)(*t, *psc)
    port = (_quantized(pout[0].numpy()), int(pout[1]), bool(pout[2]))
    ref = (_quantized(jout[0]), int(jout[1]), bool(jout[2]))
    return port, ref


def _cases():
    for name, bounds in BOUND.items():
        for i, bound in enumerate(bounds):
            yield pytest.param(name, bound, id=f"{name}-{i}")


@pytest.mark.parametrize("name,bound", list(_cases()))
@pytest.mark.parametrize("layout", ["edge-list", "dense-tile"])
def test_fixpoint_matches_jax_program(name, bound, layout):
    dense = layout == "dense-tile"
    for seed in (1, 2):
        if dense:
            n, e, n_pad, e_pad = 50, 600, 64, 1024
            assert F.dense_eligible(n_pad, e)
        else:
            n, e, n_pad, e_pad = 90, 300, 256, 1024
            assert not F.dense_eligible(n_pad, e)
        arrays = random_arrays(n, e, n_pad, e_pad, seed)
        port, ref = run_both(name, dict(bound), n, arrays, dense)
        assert port[1:] == ref[1:], (name, bound, seed)
        assert np.array_equal(port[0], ref[0]), (name, bound, seed)


@pytest.mark.parametrize("name,bound", CUTOFFS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CUTOFFS)])
def test_fixpoint_cutoffs_match_jax(name, bound):
    arrays = random_arrays(200, 300, 256, 1024, 3)
    port, ref = run_both(name, dict(bound), 200, arrays)
    assert port[1:] == ref[1:]
    assert np.array_equal(port[0], ref[0])
    cap = bound.get("max_iterations", bound.get("max_depth"))
    if cap >= 0:
        assert port[1] <= cap


@pytest.mark.parametrize("name", ["algo.pagerank", "algo.wcc", "algo.bfs",
                                  "algo.sssp"])
def test_state_frozen_after_done(name):
    """Steps past convergence change nothing: a loop given more steps
    than it needs returns the outputs, iteration count and ``done`` of
    the reading loop, and reads nothing; one given fewer reports one
    more iteration than it ran (the generic-replay check's signal)."""
    bound = dict(BOUND[name][0])
    if name == "algo.pagerank":
        bound["max_iterations"] = 200
    arrays = random_arrays(120, 400, 256, 1024, 4)
    t = [torch.from_numpy(a) for a in arrays]
    prog = F.build_program(name, 256, 1024)
    sc = F.scalar_values(name, bound, 120)
    reads = [0]
    out, it, done = prog(*t, *sc, reads=reads)
    k = int(it)
    assert bool(done) and k > 1
    assert reads[0] == -(-k // F.CHECK_EVERY)  # once every CHECK_EVERY
    more = [0]
    out2, it2, done2 = prog(*t, *sc, steps=k + 7, reads=more)
    assert more[0] == 0
    assert torch.equal(out2, out) and int(it2) == k and bool(done2)
    out3, it3, done3 = prog(*t, *sc, steps=k - 1)
    assert int(it3) == k and not bool(done3)


def test_degree_dense_and_sparse_agree_with_oracle():
    arrays = random_arrays(50, 600, 64, 1024, 9)
    node_mask, src, tgt, edge_mask, w = arrays
    want, _, _ = kernels.degree(50, src[:600], tgt[:600], "both")
    for dense in (False, True):
        port, _ref = run_both("algo.degree", {"direction": "both"}, 50,
                              arrays, dense)
        assert np.array_equal(port[0][:50], want)


@pytest.mark.parametrize("name", sorted(BOUND))
def test_live_prefix_equals_the_masked_program(name):
    """``n_edges`` (the operator's live edge count) leaves the dead tail
    out of every edge pass: the same outputs, bit for bit, and the same
    iteration counts as the program over all masked lanes."""
    arrays = random_arrays(150, 500, 256, 1024, 6)
    t = [torch.from_numpy(a) for a in arrays]
    prog = F.build_program(name, 256, 1024)
    for bound in BOUND[name]:
        sc = F.scalar_values(name, dict(bound), 150)
        full = prog(*t, *sc)
        live = prog(*t, *sc, n_edges=500)
        assert torch.equal(full[0], live[0])
        assert (int(full[1]), bool(full[2])) == (int(live[1]),
                                                 bool(live[2]))
