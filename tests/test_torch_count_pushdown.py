"""Count pushdown (relational/count_pattern.py) of the port against the
JAX package.

Seeded graphs (numpy, a few hundred nodes) go into a CPU session of the
port and into the JAX package's device backend, both with the cost model
off (``EngineConfig(use_cost_model=False)``; on the CPU, Pallas in
interpret mode).  Each count-only pattern query must plan to the same
operator (``CountPattern`` / ``CountCycle``) with the same ``strategy``
on both engines, and return the same count exactly.  The query lists
are the single-device cases of ``tests/test_count_pushdown.py``."""
import numpy as np
import pytest

import caps_tpu_torch
from caps_tpu.backends.tpu.session import TPUCypherSession
from caps_tpu.okapi.config import EngineConfig as JaxConfig
from caps_tpu.okapi.types import CTInteger as JaxInt, CTString as JaxStr
from caps_tpu.relational.entity_tables import (
    NodeMapping, NodeTable, RelationshipMapping, RelationshipTable,
)
from caps_tpu_torch.interop import graph_from_numpy
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.relational import count_pattern as CP


# -- graphs on both engines ---------------------------------------------------

def jax_graph(session, nodes, rels):
    """The arrays ``graph_from_numpy`` takes, as a JAX package graph."""
    f = session.table_factory

    def types_of(cols):
        return {k: JaxStr if not isinstance(v, np.ndarray)
                or v.dtype.kind in "USO" else JaxInt
                for k, v in cols.items()}

    def data_of(cols):
        return {k: list(v) if not isinstance(v, np.ndarray)
                else v.tolist() for k, v in cols.items()}

    node_tables = []
    for label, cols in nodes.items():
        m = NodeMapping.on("_id").with_implied_labels(label)
        for k in cols:
            if k != "_id":
                m = m.with_property(k)
        node_tables.append(NodeTable(m, f.from_columns(data_of(cols),
                                                       types_of(cols))))
    rel_tables = [RelationshipTable(RelationshipMapping.on(t),
                                    f.from_columns(data_of(c), types_of(c)))
                  for t, c in rels.items()]
    return session.create_graph(node_tables, rel_tables)


def both(nodes, rels, port_config=None, jax_config=None):
    """(port graph, JAX graph) over the same arrays; both sessions plan
    with the cost model off unless a config says otherwise."""
    port = caps_tpu_torch.local_session(
        device="cpu",
        config=port_config or EngineConfig(use_cost_model=False))
    ref = TPUCypherSession(config=jax_config
                           or JaxConfig(use_cost_model=False))
    return (graph_from_numpy(port, nodes, rels),
            jax_graph(ref, nodes, rels))


def edges(pairs, start_id=10_000):
    """{"_id", "_src", "_tgt"} arrays of a list of (src, tgt)."""
    a = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    return {"_id": np.arange(start_id, start_id + len(a), dtype=np.int64),
            "_src": a[:, 0].copy(), "_tgt": a[:, 1].copy()}


def person_nodes(n, names=13):
    return {"P": {"_id": np.arange(n, dtype=np.int64),
                  "name": [f"n{i % names}" for i in range(n)]}}


def random_graph(self_loops=True, n=200, e=800, seed=7):
    rng = np.random.RandomState(seed)
    pairs = rng.randint(0, n, size=(e, 2))
    if self_loops:
        pairs = np.concatenate([pairs, [[5, 5], [5, 5], [9, 9]]])
    else:
        # genuinely loop-free (the cycle-probe plan requires it)
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return person_nodes(n), {"K": edges(pairs)}


def multi_type_graph(n=200, seed=3):
    """Several rel types with overlapping self-loops and parallel edges —
    the shapes that stress the 3-hop edge-reuse corrections."""
    rng = np.random.RandomState(seed)

    def draw(e):
        return rng.randint(0, n, size=(e, 2))
    k = np.concatenate([draw(500), [[4, 4], [4, 4], [9, 9]]])
    l_ = np.concatenate([draw(250), [[4, 4]]])
    return (person_nodes(n, names=7),
            {"K": edges(k, 10_000), "L": edges(l_, 20_000),
             "M": edges(draw(150), 30_000)})


@pytest.fixture(scope="module")
def loops_graphs():
    return both(*random_graph(self_loops=True))


@pytest.fixture(scope="module")
def clean_graphs():
    return both(*random_graph(self_loops=False))


@pytest.fixture(scope="module")
def multi_graphs():
    return both(*multi_type_graph())


def op_strategy(result, op):
    """The ``strategy`` of the first operator named ``op`` (None if the
    plan has none)."""
    for m in result.metrics["operators"]:
        if m["op"] == op:
            return m["strategy"]
    return None


def ops(result):
    return [m["op"] for m in result.metrics["operators"]]


def check_same(graphs, query, params=None, op="CountPattern"):
    """Equal records, and the same strategy for ``op`` on both engines;
    returns the port's result."""
    port_g, jax_g = graphs
    got = port_g.cypher(query, params)
    want = jax_g.cypher(query, params)
    assert got.records.to_maps() == want.records.to_maps(), query
    assert op_strategy(got, op) == op_strategy(want, op), (
        query, got.plans["relational"], want.plans["relational"])
    return got


# -- the matcher and both paths ------------------------------------------------

PUSHDOWN_QUERIES = [
    "MATCH (a:P)-[:K]->(b) RETURN count(*) AS c",
    "MATCH (a:P)-[:K]->(b)-[:K]->(c) WHERE a.name = 'n5' RETURN count(*) AS c",
    "MATCH (a:P)-[:K]->(b)-[:K]->(c) RETURN count(*) AS c",
    "MATCH (a:P)<-[:K]-(b) WHERE a.name = 'n3' RETURN count(*) AS c",
    "MATCH (a:P)-[:K]->(b)<-[:K]-(c) WHERE a.name = 'n5' RETURN count(*) AS c",
    "MATCH (a:P)<-[:K]-(b)-[:K]->(c) WHERE a.name = 'n5' RETURN count(*) AS c",
    "MATCH (a:P)-[:K*1..2]->(b) WHERE a.name = 'n1' RETURN count(*) AS c",
    "MATCH (a:P)-[:K*0..1]->(b) RETURN count(*) AS c",
    "MATCH (a:P)-[:K*2..2]->(b) WHERE a.name = 'n5' RETURN count(*) AS c",
    "MATCH (a:P)-[:K]->(b) WHERE a.name = 'n5' AND b.name = 'n3' "
    "RETURN count(*) AS c",
    "MATCH (a:P)-[:K]->(b)-[:K]->(c) WHERE a.name = 'n5' AND b.name = 'n2' "
    "AND c.name = 'n7' RETURN count(*) AS c",
]


@pytest.mark.parametrize("query", PUSHDOWN_QUERIES)
def test_pushdown_matches_jax(query, loops_graphs):
    got = check_same(loops_graphs, query)
    assert op_strategy(got, "CountPattern") == "fused-spmv"


@pytest.mark.parametrize("query", PUSHDOWN_QUERIES)
def test_eager_pushdown_matches_jax(query):
    """The eager path (no cached closure) on both engines: the same
    counts, strategy "spmv", the id domain read through the size
    stream."""
    graphs = both(*random_graph(),
                  port_config=EngineConfig(use_cost_model=False,
                                           use_fused_count=False),
                  jax_config=JaxConfig(use_cost_model=False,
                                       use_fused_count=False))
    got = check_same(graphs, query)
    assert op_strategy(got, "CountPattern") == "spmv"


THREE_HOP_QUERIES = [
    # uniform type, all outgoing (full P = {12,23,13})
    "MATCH (a:P)-[:K]->(b)-[:K]->(c)-[:K]->(d) RETURN count(*) AS c",
    "MATCH (a:P)-[:K]->(b)-[:K]->(c)-[:K]->(d) WHERE a.name = 'n5' "
    "RETURN count(*) AS c",
    # mixed directions: go-and-return edge reuse in every pair position
    "MATCH (a:P)-[:K]->(b)<-[:K]-(c)-[:K]->(d) RETURN count(*) AS c",
    "MATCH (a:P)<-[:K]-(b)-[:K]->(c)<-[:K]-(d) RETURN count(*) AS c",
    "MATCH (a:P)-[:K]->(b)-[:K]->(c)<-[:K]-(d) RETURN count(*) AS c",
    # untyped middle hop: A13 counts hop-2 multiplicity between reused
    # endpoints over the full edge scan
    "MATCH (a:P)-[:K]->(b)-[r2]->(c)-[:K]->(d) RETURN count(*) AS c",
    # overlapping vs disjoint type combos shrink P's effective terms
    "MATCH (a:P)-[:K]->(b)-[:L]->(c)-[:K]->(d) RETURN count(*) AS c",
    "MATCH (a:P)-[:K]->(b)-[:L]->(c)-[:M]->(d) RETURN count(*) AS c",
    "MATCH (a:P)-[:L]->(b)-[:L]->(c)-[:L]->(d) RETURN count(*) AS c",
    # node predicates at inner and end positions
    "MATCH (a:P)-[:K]->(b)-[:K]->(c)-[:K]->(d) WHERE b.name = 'n2' "
    "AND d.name = 'n3' RETURN count(*) AS c",
    # var-length up to 3 (isomorphism within every length)
    "MATCH (a:P)-[:K*1..3]->(b) RETURN count(*) AS c",
    "MATCH (a:P)-[:K*3..3]->(b) WHERE a.name = 'n5' RETURN count(*) AS c",
    "MATCH (a:P)-[:K*0..3]->(b) WHERE b.name = 'n1' RETURN count(*) AS c",
    "MATCH (a:P)-[:L*2..3]->(b) RETURN count(*) AS c",
]


@pytest.mark.parametrize("query", THREE_HOP_QUERIES)
def test_three_hop_pushdown_matches_jax(query, multi_graphs):
    got = check_same(multi_graphs, query)
    assert op_strategy(got, "CountPattern") == "fused-spmv"


NOT_LOWERED = [
    # 4 fixed hops: beyond the inclusion–exclusion correction's reach
    "MATCH (a:P)-[:K]->(b)-[:K]->(c)-[:K]->(d)-[:K]->(e) "
    "RETURN count(*) AS c",
    # grouped aggregation
    "MATCH (a:P)-[:K]->(b) RETURN a.name AS n, count(*) AS c",
    # materializing query
    "MATCH (a:P)-[:K]->(b) WHERE a.name = 'n5' RETURN b.name AS n",
    # var-length upper > 3
    "MATCH (a:P)-[:K*1..4]->(b) WHERE a.name = 'n5' RETURN count(*) AS c",
    # undirected hop
    "MATCH (a:P)-[:K]-(b) RETURN count(*) AS c",
]


@pytest.mark.parametrize("query", NOT_LOWERED)
def test_unsupported_shapes_stay_on_join_path(query, loops_graphs):
    port_g, jax_g = loops_graphs
    got = port_g.cypher(query)
    assert "CountPattern" not in ops(got)
    rows = got.records.to_maps()
    want = jax_g.cypher(query).records.to_maps()
    assert sorted(map(repr, rows)) == sorted(map(repr, want))


def test_pushdown_disabled_by_config():
    port_g, _ = both(*random_graph(),
                     port_config=EngineConfig(use_count_pushdown=False))
    res = port_g.cypher("MATCH (a:P)-[:K]->(b) RETURN count(*) AS c")
    assert "CountPattern" not in ops(res)


def test_pushdown_does_not_execute_fallback_join_plan(loops_graphs):
    res = loops_graphs[0].cypher(
        "MATCH (a:P)-[:K]->(b)-[:K]->(c) RETURN count(*) AS c")
    assert "CountPattern" in ops(res)
    assert "Join" not in ops(res), ops(res)


@pytest.mark.parametrize("rels", [
    # one self loop: walks 0-0-0-0 exist, matches need 3 distinct edges
    [(0, 0)],
    # two parallel self loops: 3 distinct-edge walks impossible (2 edges)
    [(0, 0), (0, 0)],
    # three parallel self loops: 3! orderings match
    [(0, 0), (0, 0), (0, 0)],
    # triangle plus chord
    [(0, 1), (1, 2), (2, 0), (0, 2)],
    # go-return pair between two nodes
    [(0, 1), (1, 0)],
    # parallel edges both directions
    [(0, 1), (0, 1), (1, 0), (1, 0)],
], ids=["loop", "two_loops", "three_loops", "triangle_chord", "go_return",
        "parallel_both_ways"])
@pytest.mark.parametrize("query", [
    "MATCH (a:P)-[:K]->(b)-[:K]->(c)-[:K]->(d) RETURN count(*) AS c",
    "MATCH (a:P)-[:K]->(b)<-[:K]-(c)-[:K]->(d) RETURN count(*) AS c",
    "MATCH (a:P)-[:K*1..3]->(b) RETURN count(*) AS c",
], ids=["chain3", "mixed3", "varlen3"])
def test_three_hop_tiny_adversarial_shapes(rels, query):
    """Hand-checkable graphs where walks and matches diverge most."""
    nodes = {"P": {"_id": np.arange(4, dtype=np.int64)}}
    check_same(both(nodes, {"K": edges(rels)}), query)


@pytest.mark.parametrize("query", [
    "MATCH (a:P)-[r1]->(b)<-[r2:K]-(c) RETURN count(*) AS c",
    "MATCH (a:P)-[r1:K]->(b)<-[r2]-(c) RETURN count(*) AS c",
    "MATCH (a:P)-[r1]->(b)<-[r2]-(c) RETURN count(*) AS c",
])
def test_untyped_and_typed_hops_edge_reuse_correction(query):
    """An untyped hop scans every edge, so a typed hop's edges overlap
    it: the r1 <> r2 correction must iterate the intersection scan."""
    nodes = {"P": {"_id": np.array([1, 2, 3], dtype=np.int64)}}
    graphs = both(nodes, {"K": edges([(1, 2), (2, 3)])})
    got = check_same(graphs, query)
    assert "CountPattern" in ops(got)


def test_star_pattern_not_miscounted_as_chain(loops_graphs):
    """(a)->(b), (a)->(c) type-checks as 2 hops over 3 node vars but is
    NOT a chain."""
    q = "MATCH (a:P)-[r:K]->(b), (a)-[s:K]->(c) RETURN count(*) AS c"
    got = check_same(loops_graphs, q)
    assert got.records.to_maps()[0]["c"] > 0


@pytest.mark.parametrize("query", [
    "MATCH (a:P)-[:K]->(b) RETURN count(*) AS c",
    "MATCH (a:P)-[:K]->(b)-[:K]->(c) RETURN count(*) AS c",
    "MATCH (a:P)-[:K*1..2]->(b) RETURN count(*) AS c",
    "MATCH (a:P)-[:K*2..2]->(b) RETURN count(*) AS c",
    "MATCH (a:P)-[:K]->(b:P) RETURN count(*) AS c",
])
def test_dangling_edges_contribute_nothing(query):
    """Edges to ids with no node row match nothing: the lowering masks by
    node existence at every hop of a fixed chain."""
    nodes = {"P": {"_id": np.array([1, 2], dtype=np.int64)}}
    got = check_same(both(nodes, {"K": edges([(1, 2), (1, 77), (77, 2),
                                              (2, 77)])}), query)
    assert "CountPattern" in ops(got)


# -- the cycle count ----------------------------------------------------------

TRIANGLE_QUERIES = [
    # canonical oriented triangle (benchmark config 4 shape)
    "MATCH (a:P)-[:K]->(b)-[:K]->(c), (a)-[:K]->(c) RETURN count(*) AS c",
    # closing edge written in the reverse orientation
    "MATCH (a:P)-[:K]->(b)-[:K]->(c), (c)-[:K]->(a) RETURN count(*) AS c",
    # closing edge written as an incoming pattern on a
    "MATCH (a:P)-[:K]->(b)-[:K]->(c), (a)<-[:K]-(c) RETURN count(*) AS c",
    # seed predicate + mixed chain directions
    "MATCH (a:P)-[:K]->(b)<-[:K]-(c), (a)-[:K]->(c) "
    "WHERE a.name = 'n5' RETURN count(*) AS c",
]


@pytest.mark.parametrize("query", TRIANGLE_QUERIES)
@pytest.mark.parametrize("self_loops", [False, True],
                         ids=["clean", "self-loops"])
def test_cycle_count_matches_jax(query, self_loops, clean_graphs,
                                 loops_graphs):
    """The cycle-probe plan; graphs WITH self-loops fall back to the
    join plan (rel-instance coincidences become possible)."""
    graphs = loops_graphs if self_loops else clean_graphs
    got = check_same(graphs, query, op="CountCycle")
    strat = op_strategy(got, "CountCycle")
    assert strat == ("fallback-join" if self_loops else "cycle-probe")
    if not self_loops:
        assert "Join" not in ops(got)


def op_metric(result, op):
    return next(m for m in result.metrics["operators"] if m["op"] == op)


@pytest.mark.parametrize("query,fused,op", [
    (PUSHDOWN_QUERIES[1], True, "CountPattern"),
    (PUSHDOWN_QUERIES[1], False, "CountPattern"),
    (TRIANGLE_QUERIES[0], True, "CountCycle"),
], ids=["fused", "eager", "cycle"])
def test_pushdown_bytes_in_matches_jax(query, fused, op):
    """What a pushdown operator reports it read: its closure's inputs,
    0 on the eager path (the fallback plan never ran), as in the JAX
    package."""
    graphs = both(*random_graph(self_loops=False),
                  port_config=EngineConfig(use_cost_model=False,
                                           use_fused_count=fused),
                  jax_config=JaxConfig(use_cost_model=False,
                                       use_fused_count=fused))
    got = op_metric(graphs[0].cypher(query), op)
    want = op_metric(graphs[1].cypher(query), op)
    assert got["strategy"] == want["strategy"]
    assert got["bytes_in"] == want["bytes_in"]
    assert (got["bytes_in"] > 0) == fused


def test_fallback_join_reports_what_it_read(loops_graphs):
    """A cycle count that falls back runs its join plan: its
    ``bytes_in`` is that plan's output, not 0."""
    m = op_metric(loops_graphs[0].cypher(TRIANGLE_QUERIES[0]), "CountCycle")
    assert m["strategy"] == "fallback-join"
    assert m["bytes_in"] > 0


def test_cycle_count_parallel_closing_edges():
    """Parallel closing edges each produce a distinct match (the probe
    returns key multiplicity)."""
    nodes = {"P": {"_id": np.arange(3, dtype=np.int64)}}
    graphs = both(nodes, {"K": edges([(0, 1), (1, 2), (0, 2), (0, 2)])})
    q = "MATCH (a:P)-[:K]->(b)-[:K]->(c), (a)-[:K]->(c) RETURN count(*) AS c"
    got = check_same(graphs, q, op="CountCycle")
    assert got.records.to_maps() == [{"c": 2}]


def test_cycle_count_spans_batches(clean_graphs, monkeypatch):
    """More 2-paths than one batch: the loop over batches counts each
    path once."""
    monkeypatch.setattr(CP.CountCycleOp, "_BATCH", 64)
    port = caps_tpu_torch.local_session(device="cpu")
    g = graph_from_numpy(port, *random_graph(self_loops=False))
    q = TRIANGLE_QUERIES[0]
    got = g.cypher(q)
    assert op_strategy(got, "CountCycle") == "cycle-probe"
    assert got.records.to_maps() == \
        clean_graphs[1].cypher(q).records.to_maps()


# -- record / replay and cached state ------------------------------------------

PARAM_QUERIES = {
    "two_hop": "MATCH (a:P)-[:K]->(b)-[:K]->(c) WHERE a.name = $name "
               "RETURN count(*) AS c",
    "three_hop": "MATCH (a:P)-[:K]->(b)-[:K]->(c)-[:K]->(d) "
                 "WHERE a.name = $name RETURN count(*) AS c",
    "varlen": "MATCH (a:P)-[:K*1..2]->(b) WHERE a.name = $name "
              "RETURN count(*) AS c",
}


@pytest.mark.parametrize("name", list(PARAM_QUERIES))
def test_fused_count_replays_make_no_size_reads(name):
    """A count query's closure path needs no size: every exact replay
    and every generic replay (a new binding) makes 0 size reads, and
    each binding's count equals the JAX package's."""
    port_g, jax_g = both(*random_graph())
    session = port_g.session
    q = PARAM_QUERIES[name]
    modes = []
    for value in ["n5", "n5", "n5", "n3", "n7", "n5", "n1"]:
        res = port_g.cypher(q, {"name": value})
        modes.append(session.fused.last_mode)
        assert res.records.to_maps() == \
            jax_g.cypher(q, {"name": value}).records.to_maps(), value
        assert op_strategy(res, "CountPattern") == "fused-spmv"
        if modes[-1] != "record":
            assert res.metrics["size_syncs"] == 0, (value, modes)
    assert modes[:3] == ["record", "replay", "replay"]
    assert "replay_gen" in modes
    # one closure per shape, however many bindings
    assert session.backend.count_builds == 1


def test_static_state_keeps_at_most_sixteen_graphs():
    """Discarded graphs' static arrays are evicted oldest first, their
    closures with them."""
    session = caps_tpu_torch.local_session(device="cpu")
    nodes = {"P": {"_id": np.arange(3, dtype=np.int64)}}
    q = "MATCH (a:P)-[:K]->(b) RETURN count(*) AS c"
    graphs = []
    for i in range(CP._MAX_STATIC_GRAPHS + 2):
        g = graph_from_numpy(session, nodes,
                             {"K": edges([(0, 1)] * (i + 1))})
        graphs.append(g)
        assert g.cypher(q).records.to_maps() == [{"c": i + 1}]
    backend = session.backend
    assert len(backend.fused_count_static) == CP._MAX_STATIC_GRAPHS
    live = set(backend.fused_count_static)
    assert all(k[0] in live for k in backend.fused_count_fns)
    # the first graph rebuilds its closure and still counts right
    assert graphs[0].cypher(q).records.to_maps() == [{"c": 1}]


# -- the sorted-key probe -------------------------------------------------------

def test_wcoj_keys_and_multiplicity_match_jax():
    import jax.numpy as jnp
    import torch
    from caps_tpu.ops import wcoj as JW
    from caps_tpu_torch.ops import wcoj as TW
    rng = np.random.RandomState(5)
    n = 50
    frm = rng.randint(-2, n + 2, 400)
    to = rng.randint(-2, n + 2, 400)
    ok = rng.rand(400) < 0.9
    want = np.asarray(JW.edge_keys(jnp.asarray(frm), jnp.asarray(to),
                                   jnp.asarray(ok), jnp.int64(n)))
    got = TW.edge_keys(torch.from_numpy(frm), torch.from_numpy(to),
                       torch.from_numpy(ok), n).numpy()
    np.testing.assert_array_equal(got, want)
    keys = np.sort(want)
    q = np.concatenate([keys[::3], rng.randint(0, n * n, 100)])
    np.testing.assert_array_equal(
        TW.multiplicity(torch.from_numpy(keys), torch.from_numpy(q)).numpy(),
        np.asarray(JW.multiplicity(jnp.asarray(keys), jnp.asarray(q))))
