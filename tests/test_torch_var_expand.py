"""Bounded variable-length expand (relational/var_expand.py) of the port
against the JAX package.

Seeded graphs go into a CPU session of the port and into the JAX
package's device backend with the cost model off (on the CPU, Pallas in
interpret mode).  Every var-length query must take the same strategy
("matrix" or "join") on both engines and return the same records: in
order where the ORDER BY is total, as bags otherwise.  The matrix
functions (``parallel/ring.py``) and the table operations the join form
needs (``union_all``, ``pack_list``) are held to the JAX package's on the
same arrays, exactly."""
import collections

import numpy as np
import pytest
import torch

import caps_tpu_torch
from caps_tpu_torch.interop import graph_from_numpy
from caps_tpu_torch.okapi.config import EngineConfig
from tests.test_torch_count_pushdown import (
    both, edges, op_strategy, random_graph,
)

N, E, CITIES = 400, 2000, 20


def social_graph(seed=11, n=N, e=E):
    """:Person {age, city, name} and :KNOWS edges, self-loops included."""
    rng = np.random.RandomState(seed)
    cities = np.array([f"city{i:02d}" for i in range(CITIES)])
    nodes = {"Person": {
        "_id": np.arange(n, dtype=np.int64),
        "age": rng.randint(18, 40, n).astype(np.int64),
        "city": cities[rng.randint(0, CITIES, n)].tolist(),
        "name": [f"p{i}" for i in range(n)]}}
    pairs = np.concatenate([rng.randint(0, n, size=(e, 2)),
                            [[3, 3], [7, 7]]])
    return nodes, {"KNOWS": edges(pairs)}


@pytest.fixture(scope="module")
def graphs():
    return both(*social_graph())


def _bag(rows):
    return collections.Counter(repr(sorted(r.items())) for r in rows)


GROUPED = ("MATCH (a:Person)-[:KNOWS*1..2]->(c) WHERE a.age = $age "
           "RETURN c.city AS city, count(*) AS n ORDER BY n DESC, city "
           "LIMIT 20")

# (query, params, ordered, strategy)
QUERIES = {
    # the grouped query of chip_smoke.py's patterns phase
    "grouped": (GROUPED, {"age": 30}, True, "matrix"),
    "grouped_few_seeds": (
        "MATCH (a:Person)-[:KNOWS*1..2]->(c) WHERE a.age = $age AND "
        "a.city = $city RETURN c.city AS city, count(*) AS n "
        "ORDER BY n DESC, city LIMIT 20", {"age": 30, "city": "city03"},
        True, "matrix"),
    "pairs": ("MATCH (a:Person)-[:KNOWS*1..2]->(b) WHERE a.age = 25 "
              "RETURN a.name AS a, b.name AS b", {}, False, "matrix"),
    "undirected": ("MATCH (a:Person)-[:KNOWS*1..2]-(b) WHERE a.age = 25 "
                   "RETURN a.name AS a, b.name AS b", {}, False, "matrix"),
    "incoming": ("MATCH (a:Person)<-[:KNOWS*1..2]-(b) WHERE a.age = 25 "
                 "RETURN a.name AS a, b.name AS b", {}, False, "matrix"),
    "size_r": ("MATCH (a:Person)-[r:KNOWS*1..2]->(b) WHERE a.age = 25 "
               "RETURN size(r) AS n, count(*) AS c ORDER BY n", {}, True,
               "matrix"),
    "length_r": ("MATCH (a:Person)-[r:KNOWS*1..3]->(b) WHERE a.age = 22 "
                 "RETURN length(r) AS n, count(*) AS c ORDER BY n", {},
                 True, "matrix"),
    "three_hops": ("MATCH (a:Person)-[:KNOWS*1..3]->(b) WHERE a.age = 21 "
                   "RETURN b.city AS city, count(*) AS n ORDER BY n DESC, "
                   "city", {}, True, "matrix"),
    "three_hops_undirected": (
        "MATCH (a:Person)-[:KNOWS*1..3]-(b) WHERE a.age = 21 "
        "RETURN b.city AS city, count(*) AS n ORDER BY n DESC, city", {},
        True, "matrix"),
    "zero_lower": ("MATCH (a:Person)-[:KNOWS*0..2]->(b) WHERE a.age = 24 "
                   "RETURN b.name AS b", {}, False, "matrix"),
    "no_seed": ("MATCH (a:Person)-[:KNOWS*1..2]->(b) WHERE a.age = 99 "
                "RETURN b.name AS b", {}, False, "matrix"),
    # the relationship list is read: the join form
    "rel_list": ("MATCH (a:Person)-[r:KNOWS*1..2]->(b) WHERE a.age = 25 "
                 "RETURN a.name AS a, r AS r, b.name AS b", {}, False,
                 "join"),
    "rel_list_undirected": (
        "MATCH (a:Person)-[r:KNOWS*1..2]-(b) WHERE a.age = 25 "
        "RETURN a.name AS a, r AS r, b.name AS b", {}, False, "join"),
    "join_1_3": ("MATCH (a:Person)-[r:KNOWS*1..3]->(b) WHERE a.age = 19 "
                 "RETURN a.name AS a, size(r) AS n, r AS r, b.name AS b",
                 {}, False, "join"),
    # upper > 3: the join form
    "join_1_4": ("MATCH (a:Person)-[:KNOWS*1..4]->(b) WHERE a.age = 19 "
                 "RETURN b.city AS city, count(*) AS n ORDER BY n DESC, "
                 "city", {}, True, "join"),
    # a fixed hop beside a var-length one: the uniqueness filter tests
    # the hop's id against the path's list (IN over a list column)
    "var_then_fixed": ("MATCH (a:Person)-[:KNOWS*1..2]->(b)-[:KNOWS]->(c) "
                       "WHERE a.age = 25 RETURN c.city AS city, count(*) "
                       "AS n ORDER BY n DESC, city", {}, True, "join"),
    "fixed_then_var": ("MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS*1..2]->(c) "
                       "WHERE a.age = 25 RETURN c.name AS c", {}, False,
                       "join"),
    # both endpoints bound
    "into": ("MATCH (a:Person)-[:KNOWS]->(b), (a)-[:KNOWS*1..2]->(b) "
             "WHERE a.age < 30 RETURN a.name AS a, b.name AS b", {}, False,
             "join"),
    "labeled_target": ("MATCH (a:Person)-[:KNOWS*1..2]->(b:Person) "
                       "WHERE a.age = 25 AND b.age < 30 RETURN b.name AS b",
                       {}, False, "matrix"),
    "distinct": ("MATCH (a:Person)-[:KNOWS*1..2]->(b) WHERE a.age = 25 "
                 "RETURN DISTINCT b.city AS city", {}, False, "matrix"),
    "path_length": ("MATCH p = (a:Person)-[:KNOWS*1..2]->(b) "
                    "WHERE a.age = 25 RETURN length(p) AS l, count(*) AS c "
                    "ORDER BY l", {}, True, "matrix"),
}


@pytest.mark.parametrize("name", list(QUERIES))
def test_var_expand_matches_jax(name, graphs):
    query, params, ordered, strategy = QUERIES[name]
    port_g, jax_g = graphs
    got = port_g.cypher(query, params)
    want = jax_g.cypher(query, params)
    assert op_strategy(got, "VarExpand") == strategy
    assert op_strategy(want, "VarExpand") == strategy
    rows, want_rows = got.records.to_maps(), want.records.to_maps()
    if ordered:
        assert rows == want_rows
    else:
        assert _bag(rows) == _bag(want_rows)


def test_matrix_form_off_takes_joins(graphs):
    """``use_ring=False``: the same query on the join form, the same
    rows."""
    port_g, _ = both(*social_graph(),
                     port_config=EngineConfig(use_ring=False))
    got = port_g.cypher(GROUPED, {"age": 30})
    assert op_strategy(got, "VarExpand") == "join"
    assert got.records.to_maps() == \
        graphs[0].cypher(GROUPED, {"age": 30}).records.to_maps()


def test_too_many_seed_chunks_take_joins(monkeypatch):
    """More than 64 seed chunks: the join form, as in the JAX package
    (the matrix budget shrunk so a small graph reaches the refusal)."""
    from caps_tpu.relational.var_expand import VarExpandOp as JaxVarExpand
    from caps_tpu_torch.relational.var_expand import VarExpandOp
    for cls in (VarExpandOp, JaxVarExpand):
        monkeypatch.setattr(cls, "_RING_MAX_MATRIX", 2 * E)
    port_g, jax_g = both(*social_graph())
    q = ("MATCH (a:Person)-[:KNOWS*1..2]->(b) WHERE a.age < 30 "
         "RETURN b.city AS city, count(*) AS n ORDER BY n DESC, city")
    got, want = port_g.cypher(q), jax_g.cypher(q)
    assert op_strategy(got, "VarExpand") == "join"
    assert op_strategy(want, "VarExpand") == "join"
    assert got.records.to_maps() == want.records.to_maps()


@pytest.mark.parametrize("use_ring,strategy", [
    (True, "matrix"), (False, "join")], ids=["matrix", "join"])
def test_grouped_var_expand_replays(graphs, use_ring, strategy):
    """The grouped var-expand query rides record / replay in both forms:
    each binding equals the JAX package's, and an exact replay reads no
    size (the matrix form's seed sizes go through the size stream)."""
    port = caps_tpu_torch.local_session(
        device="cpu", config=EngineConfig(use_ring=use_ring))
    g = graph_from_numpy(port, *social_graph())
    jax_g = graphs[1]
    for age, mode in [(30, "record"), (30, "replay"), (31, None),
                      (30, "replay"), (32, None), (31, None)]:
        res = g.cypher(GROUPED, {"age": age})
        assert res.records.to_maps() == \
            jax_g.cypher(GROUPED, {"age": age}).records.to_maps()
        assert op_strategy(res, "VarExpand") == strategy
        if mode is not None:
            assert port.fused.last_mode == mode
        if mode == "replay":
            assert res.metrics["size_syncs"] == 0


def test_var_length_no_longer_raises():
    """A var-length pattern plans and runs."""
    s = caps_tpu_torch.local_session(device="cpu")
    g = graph_from_numpy(
        s, {"Person": {"_id": np.arange(3, dtype=np.int64),
                       "age": np.arange(3, dtype=np.int64)}},
        {"KNOWS": {"_id": np.arange(3, 5, dtype=np.int64),
                   "_src": np.array([0, 1], dtype=np.int64),
                   "_tgt": np.array([1, 2], dtype=np.int64)}})
    res = g.cypher("MATCH (a:Person)-[:KNOWS*1..2]->(b) RETURN count(*) AS c")
    assert res.records.to_maps() == [{"c": 3}]


def test_var_expand_count_plans_count_pattern(graphs):
    q = ("MATCH (a:Person)-[:KNOWS*1..2]->(c) WHERE a.age = $age "
         "RETURN count(*) AS n")
    port_g, jax_g = graphs
    got = port_g.cypher(q, {"age": 30})
    assert got.records.to_maps() == \
        jax_g.cypher(q, {"age": 30}).records.to_maps()
    assert op_strategy(got, "CountPattern") == "fused-spmv"


# -- the matrix functions --------------------------------------------------------

def _edge_arrays(seed=4, n=30, e=120, loops=3):
    rng = np.random.RandomState(seed)
    src = np.concatenate([rng.randint(0, n, e), np.arange(loops)])
    dst = np.concatenate([rng.randint(0, n, e), np.arange(loops)])
    ok = rng.rand(src.shape[0]) < 0.9
    f0 = np.zeros((4, n), dtype=np.int64)
    f0[np.arange(4), [0, 1, 5, 9]] = 1
    tmask = (rng.rand(n) < 0.7).astype(np.int64)
    return n, src.astype(np.int32), dst.astype(np.int32), ok, f0, tmask


@pytest.mark.parametrize("lengths", [(1,), (2,), (1, 2), (0, 1, 2)])
@pytest.mark.parametrize("correction", ["loops", "degree"])
def test_ring_varexpand_matches_jax(lengths, correction):
    import jax.numpy as jnp
    from caps_tpu.parallel import ring as JR
    from caps_tpu_torch.parallel import ring as TR
    n, src, dst, ok, f0, tmask = _edge_arrays()
    want = np.asarray(JR.ring_varexpand_single(lengths, correction)(
        *(jnp.asarray(x) for x in (f0, src, dst, ok, tmask))))
    t = [torch.from_numpy(x) for x in (f0, src, dst, ok, tmask)]
    got = TR.ring_varexpand_reference(*t, lengths, correction)
    np.testing.assert_array_equal(got.numpy(), want)
    # the correction vector built once per graph, as the matrix form does
    r2 = TR.r2_vector(*t[1:4], n, torch.int64, correction)
    got = TR.ring_varexpand_reference(*t, lengths, correction, r2=r2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lengths", [(3,), (1, 2, 3), (0, 1, 2, 3)])
@pytest.mark.parametrize("undirected", [False, True],
                         ids=["directed", "undirected"])
def test_ring_varexpand3_and_iso3_sparse_match_jax(lengths, undirected):
    import jax.numpy as jnp
    from caps_tpu.parallel import ring as JR
    from caps_tpu_torch.parallel import ring as TR
    n, src, dst, ok, f0, tmask = _edge_arrays(seed=8)
    rid = np.arange(src.shape[0], dtype=np.int64) + 100
    a, b, live_rid = src[ok], dst[ok], rid[ok]
    if undirected:
        nonloop = a != b
        a, b = (np.concatenate([a, b[nonloop]]),
                np.concatenate([b, a[nonloop]]))
        live_rid = np.concatenate([live_rid, live_rid[nonloop]])
    want_sp = JR.build_iso3_sparse(a, b, live_rid, n)
    got_sp = TR.build_iso3_sparse(a, b, live_rid, n)
    for w_tr, g_tr in zip(want_sp, got_sp):
        for w, g in zip(w_tr, g_tr):
            np.testing.assert_array_equal(g, w)
    okp = np.ones(a.shape[0], dtype=bool)
    correction = "degree" if undirected else "loops"
    args = (f0, a.astype(np.int32), b.astype(np.int32), okp, tmask,
            *want_sp[0], *want_sp[1])
    want = np.asarray(JR.ring_varexpand3_single(lengths, correction)(
        *(jnp.asarray(x) for x in args)))
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in args]
    got = TR.ring_varexpand3_reference(*t[:5], lengths, t[5:8], t[8:],
                                       correction)
    np.testing.assert_array_equal(got.numpy(), want)


def test_explode_expand_matches_jax():
    import jax.numpy as jnp
    from caps_tpu.backends.tpu import kernels as JK
    from caps_tpu_torch.backends.cuda import kernels as TK
    rng = np.random.RandomState(2)
    lens = rng.randint(0, 4, 300).astype(np.int64)
    ok = rng.rand(300) < 0.8
    out_cap = int(np.where(ok, lens, 0).sum()) + 37
    want = JK.explode_expand(jnp.asarray(lens), jnp.asarray(ok), out_cap)
    got = TK.explode_expand(torch.from_numpy(lens), torch.from_numpy(ok),
                            out_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- union_all and pack_list ------------------------------------------------------

def _tables():
    """The same three-column table in the port and in the JAX package."""
    import caps_tpu
    from caps_tpu.okapi.types import CTInteger as JInt
    from caps_tpu_torch.okapi.types import CTInteger as TInt
    cols_a = {"x": [1, 2, None, 4], "y": [10, None, 30, 40],
              "z": [7, 8, 9, 10]}
    cols_b = {"x": [5, None], "y": [50, 60], "z": [None, 12]}
    port = caps_tpu_torch.local_session(device="cpu").table_factory
    ref = caps_tpu.local_session(backend="tpu").table_factory
    out = []
    for f, t in ((port, TInt), (ref, JInt)):
        types = {c: t for c in cols_a}
        out.append((f.from_columns(cols_a, types),
                    f.from_columns(cols_b, types)))
    return out


def _rows(table):
    return [tuple(table.column_values(c)[i] for c in table.columns)
            for i in range(table.size)]


def test_union_all_and_pack_list_match_jax():
    from caps_tpu.okapi.types import CTInteger as JInt, CTList as JList
    from caps_tpu_torch.okapi.types import CTInteger as TInt, CTList as TList
    (pa, pb), (ja, jb) = _tables()
    assert _rows(pa.union_all(pb)) == _rows(ja.union_all(jb))
    for cols in (["x", "y", "z"], ["y"], []):
        p = pa.pack_list(cols, "l", TList(TInt))
        j = ja.pack_list(cols, "l", JList(JInt))
        assert p.column_values("l") == j.column_values("l"), cols
    # list columns of different widths (a 1-hop branch against a 2-hop
    # one) concatenate, the narrower padded
    p = pa.pack_list(["x"], "l", TList(TInt)).union_all(
        pb.pack_list(["x", "y", "z"], "l", TList(TInt)))
    j = ja.pack_list(["x"], "l", JList(JInt)).union_all(
        jb.pack_list(["x", "y", "z"], "l", JList(JInt)))
    assert p.column_values("l") == j.column_values("l")
    assert _rows(p.select(["x", "y", "z"])) == _rows(j.select(["x", "y", "z"]))


def test_union_all_closes_generic_replay_gaps():
    """Under generic replay a table's served row count is only a bound:
    the union must drop the dead rows between the two live prefixes."""
    (pa, pb), _ = _tables()
    from caps_tpu_torch.backends.cuda.table import DeviceTable
    a = DeviceTable(pa.backend, pa._cols, pa.size,
                    live=torch.tensor(2, dtype=torch.int32))
    u = a.union_all(pb)
    assert u.exact_size() == 4
    assert u.column_values("z") == [7, 8, None, 12]


def test_union_all_refuses_kind_mismatch():
    """Entity ids beside strings have no device column: the union
    refuses naming the column.  Integers beside strings union as values
    of mixed types, and so does a list beside a string (the list held
    by its row in the column's child, not copied)."""
    from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice
    from caps_tpu_torch.okapi.types import CTInteger, CTList, CTNode, CTString
    f = caps_tpu_torch.local_session(device="cpu").table_factory
    ids = f.from_columns({"x": [1]}, {"x": CTNode()})
    b = f.from_columns({"x": ["s"]}, {"x": CTString})
    with pytest.raises(UnsupportedOnDevice, match="union_all"):
        ids.union_all(b)
    mixed = f.from_columns({"x": [1]}, {"x": CTInteger}).union_all(b)
    assert mixed.column_values("x") == [1, "s"]
    a = f.from_columns({"x": [[1]]}, {"x": CTList(CTInteger)})
    held = a.union_all(b)
    assert held.column_values("x") == [[1], "s"]
    assert held._cols["x"].child is a._cols["x"]


def test_multi_type_scans_union(graphs):
    """A scan over two relationship types unions their tables."""
    nodes, rels = random_graph(n=60, e=200)
    rels["L"] = edges([(1, 2), (2, 3), (3, 1)], start_id=50_000)
    port_g, jax_g = both(nodes, rels)
    q = ("MATCH (a:P)-[:K|L*1..2]->(b) WHERE a.name = 'n1' "
         "RETURN b.name AS b")
    got, want = port_g.cypher(q), jax_g.cypher(q)
    assert op_strategy(got, "VarExpand") == op_strategy(want, "VarExpand")
    assert _bag(got.records.to_maps()) == _bag(want.records.to_maps())


@pytest.mark.parametrize("query", [
    "MATCH (a:Person) WHERE a.age < 20 RETURN a.name AS x UNION ALL "
    "MATCH (a:Person) WHERE a.age > 38 RETURN a.name AS x",
    "MATCH (a:Person) WHERE a.age < 25 RETURN a.city AS x UNION "
    "MATCH (a:Person) WHERE a.age > 35 RETURN a.city AS x",
    "MATCH (a:Person)-[:KNOWS]-(b) WHERE a.age = 20 RETURN b.name AS x",
], ids=["union_all", "union", "undirected_hop"])
def test_union_queries_match_jax(query, graphs):
    """UNION [ALL] and an undirected hop (a union of both orientations)
    run on the union_all the join form needs."""
    port_g, jax_g = graphs
    assert _bag(port_g.cypher(query).records.to_maps()) == \
        _bag(jax_g.cypher(query).records.to_maps())


def _large_id_graph(seed=5, n=80, e=400):
    """80 ``:P`` nodes (a third also ``:Q``) with ids 2^40 + 13i and a
    nullable ``k``, and 400 ``:K`` / ``:L`` edges among them."""
    rng = np.random.RandomState(seed)
    ids = [2 ** 40 + 13 * i for i in range(n)]
    nodes = {}
    for i, nid in enumerate(ids):
        labels = ("P", "Q") if i % 3 == 0 else ("P",)
        k = None if rng.rand() < 0.1 else int(rng.randint(0, 8))
        nodes.setdefault(labels, []).append(
            {"_id": nid, **({} if k is None else {"k": k})})
    rels = {"K": [], "L": []}
    for a, b in rng.randint(0, n, size=(e, 2)):
        rels["K" if rng.rand() < 0.6 else "L"].append((ids[a], ids[b], {}))
    return nodes, rels


@pytest.mark.parametrize("pattern", [
    "(a:P)-[:K*1..2]->(b)", "(a:P)-[:K*1..3]->(b)", "(a:P)-[:K*2..3]-(b)",
    "(a:P)-[:K|L*1..2]->(b)"], ids=["1..2", "1..3", "undirected_2..3",
                                    "two_types_1..2"])
def test_large_ids_refuse_the_matrix_before_allocating(pattern):
    """Ids near 2^40 put the dense id domain far past the matrix budget:
    the var-expand refuses the matrix form before it sizes anything by
    that domain and answers through joins, as the JAX package does."""
    import caps_tpu
    from util import make_graph
    from test_torch_algo import port_make_graph
    nodes, rels = _large_id_graph()
    port = port_make_graph(caps_tpu_torch.local_session(device="cpu"),
                           nodes, rels)
    ref = make_graph(caps_tpu.local_session(backend="local"), nodes, rels)
    q = f"MATCH {pattern} WHERE a.k = $k RETURN count(*) AS c"
    for k in (2, 5):
        got = port.cypher(q, {"k": k})
        assert op_strategy(got, "VarExpand") == "join"
        assert got.records.to_maps() == \
            ref.cypher(q, {"k": k}).records.to_maps()
