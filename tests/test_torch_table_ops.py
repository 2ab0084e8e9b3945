"""The port's UNWIND, cross join, DISTINCT aggregates, collect and
percentiles against the JAX package's ``DeviceTable``.

The same seeded numpy columns (with nulls) go into a ``DeviceTable`` of
each package on the CPU (the JAX one with its Pallas kernels in
interpret mode).  Each case first compacts both tables by the same mask,
so they carry dead rows: padding slots that duplicate a live row and
look valid.  Tolerances: ints, strings, lists and ``percentileDisc``
must be equal; ``percentileCont`` may differ by 2 ulp (it interpolates
in float64, and XLA may fuse the interpolation's multiply and add).

It also holds ``sqrt`` and ``stDev`` bitwise to the JAX package over a
query of 320 seeded rows, an OPTIONAL MATCH, and the string, list and
null expressions the TCK's UNWIND scenarios reach.
"""
import collections
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caps_tpu
import caps_tpu_torch
from caps_tpu.okapi import types as JT
from caps_tpu.relational.table import AggSpec as JaxAggSpec
from caps_tpu.relational.updates import (
    build_node_tables as jax_node_tables, build_rel_tables as jax_rel_tables,
)
from caps_tpu_torch.okapi import types as PT
from caps_tpu_torch.relational.table import AggSpec
from caps_tpu_torch.testing.factory import build_node_tables, build_rel_tables

N = 300
PERCENTILES = (0.0, 0.1, 0.5, 0.9, 1.0)


@pytest.fixture(scope="module")
def sessions():
    return (caps_tpu_torch.local_session(device="cpu"),
            caps_tpu.local_session(backend="tpu"))


def _ctypes(kinds):
    """Column type names → (port types, JAX package types)."""
    def one(mod, kind):
        base = {"int": mod.CTInteger, "float": mod.CTFloat,
                "str": mod.CTString, "ints": mod.CTList(mod.CTInteger),
                "strs": mod.CTList(mod.CTString)}[kind]
        return base.nullable
    return ({c: one(PT, k) for c, k in kinds.items()},
            {c: one(JT, k) for c, k in kinds.items()})


def _columns(seed, n=N):
    """Seeded columns with nulls: an int group key ``g`` (7 values), a
    str key ``s``, int values ``v`` with repeats, float values ``f``,
    and int and str list columns (some null, some empty)."""
    rng = np.random.RandomState(seed)
    words = ["ant", "bee", "cat", "dog", "eel", "fox"]

    def nulls(vals, p=0.1):
        return [None if rng.rand() < p else x for x in vals]

    data = {
        "g": nulls([int(x) for x in rng.randint(0, 7, n)]),
        "s": nulls([words[i] for i in rng.randint(0, 6, n)]),
        "v": nulls([int(x) for x in rng.randint(-20, 20, n)]),
        "f": nulls([float(x) for x in np.round(rng.randn(n) * 10, 1)]),
        "ints": nulls([[int(x) for x in rng.randint(-50, 50,
                                                     rng.randint(0, 5))]
                       for _ in range(n)]),
        "strs": nulls([[words[i] for i in rng.randint(0, 6,
                                                       rng.randint(0, 4))]
                       for _ in range(n)]),
    }
    kinds = {"g": "int", "s": "str", "v": "int", "f": "float",
             "ints": "ints", "strs": "strs"}
    return data, kinds, rng


def _pair(sessions, data, kinds, rng, keep_share=0.8):
    """The same table in both packages, compacted by one seeded mask."""
    port, jax_s = sessions
    pt_types, jt_types = _ctypes(kinds)
    pt = port.table_factory.from_columns(data, pt_types)
    jt = jax_s.table_factory.from_columns(data, jt_types)
    assert pt.capacity == jt.capacity
    keep = rng.rand(pt.capacity) < keep_share
    pt = pt._compact(torch.from_numpy(keep) & pt.row_ok)
    jt = jt._compact(jnp.asarray(keep) & jt.row_ok)
    assert pt.size == jt.size and pt.capacity > pt.size
    return pt, jt


def _rows(table):
    cols = table.columns
    return [dict(zip(cols, r))
            for r in zip(*(table.column_values(c) for c in cols))]


def _aggs(specs, jax):
    """(name, kind, col, distinct, percentile, list of what) → AggSpecs of
    one package."""
    mod, cls = (JT, JaxAggSpec) if jax else (PT, AggSpec)
    out = []
    for name, kind, col, distinct, p, elem in specs:
        rt = None
        if kind == "collect":
            rt = mod.CTList({"int": mod.CTInteger,
                             "str": mod.CTString}[elem])
        out.append(cls(name, kind, col, distinct, p, rt))
    return out


@pytest.mark.parametrize("list_col", ["ints", "strs"])
@pytest.mark.parametrize("seed", [0, 1])
def test_explode_matches_jax(sessions, list_col, seed):
    data, kinds, rng = _columns(seed)
    pt, jt = _pair(sessions, data, kinds, rng)
    elem_p = PT.CTInteger if list_col == "ints" else PT.CTString
    elem_j = JT.CTInteger if list_col == "ints" else JT.CTString
    got = pt.explode(list_col, "x", elem_p)
    want = jt.explode(list_col, "x", elem_j)
    assert not want.is_local
    assert got.size == want.size > 0
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_join_matches_jax(sessions, seed):
    data, kinds, rng = _columns(seed, n=40)
    left = {k: data[k] for k in ("g", "s")}
    right = {"v2": data["v"][:23], "f2": data["f"][:23]}
    pl, jl = _pair(sessions, left, {"g": "int", "s": "str"}, rng)
    pr, jr = _pair(sessions, right, {"v2": "int", "f2": "float"}, rng)
    got = pl.join(pr, "cross", [])
    want = jl.join(jr, "cross", [])
    assert not want.is_local
    assert got.size == want.size == pl.size * pr.size
    assert _rows(got) == _rows(want)


DISTINCT_AGGS = [
    ("n", "count_star", None, False, None, None),
    ("nv", "count", "v", True, None, None),
    ("ns", "count", "s", True, None, None),
    ("sv", "sum", "v", True, None, None),
    ("sf", "sum", "f", True, None, None),
    ("cv", "collect", "v", False, None, "int"),
    ("cdv", "collect", "v", True, None, "int"),
    ("cds", "collect", "s", True, None, "str"),
]


@pytest.mark.parametrize("by", [["g"], ["s"], ["g", "s"], []],
                         ids=["int_key", "str_key", "two_keys", "ungrouped"])
@pytest.mark.parametrize("seed", [0, 1])
def test_distinct_aggregates_and_collect_match_jax(sessions, by, seed):
    data, kinds, rng = _columns(seed)
    pt, jt = _pair(sessions, data, kinds, rng)
    got = pt.group(by, _aggs(DISTINCT_AGGS, jax=False))
    want = jt.group(by, _aggs(DISTINCT_AGGS, jax=True))
    assert not want.is_local
    # sums over float values compare exactly too: both add the same
    # first occurrences in the same order
    assert _rows(got) == _rows(want)


def _close_ulp(a, b, ulps):
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= ulps * math.ulp(max(abs(a), abs(b)))


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["all", "distinct"])
@pytest.mark.parametrize("by", [["g"], []], ids=["grouped", "ungrouped"])
@pytest.mark.parametrize("col", ["v", "f"])
def test_percentiles_match_jax(sessions, col, by, distinct):
    data, kinds, rng = _columns(7)
    pt, jt = _pair(sessions, data, kinds, rng)
    specs = []
    for i, p in enumerate(PERCENTILES):
        specs.append((f"d{i}", "percentile_disc", col, distinct, p, None))
        specs.append((f"c{i}", "percentile_cont", col, distinct, p, None))
    got = _rows(pt.group(by, _aggs(specs, jax=False)))
    jres = jt.group(by, _aggs(specs, jax=True))
    assert not jres.is_local
    want = _rows(jres)
    assert len(got) == len(want) > 0
    for g_row, w_row in zip(got, want):
        for k, w in w_row.items():
            if k.startswith("c"):
                # percentileCont: within 2 ulp (see the module docstring)
                assert _close_ulp(g_row[k], w, 2), (k, g_row[k], w)
            else:
                assert g_row[k] == w, (k, g_row[k], w)


# -- whole queries: sqrt / stDev, OPTIONAL MATCH ------------------------------

def _graphs(sessions, nodes, rels=()):
    """The same graph in both packages from ``(id, labels, props)`` and
    ``(id, src, tgt, type, props)`` records."""
    port, jax_s = sessions
    gp = port.create_graph(build_node_tables(port.table_factory, nodes),
                           build_rel_tables(port.table_factory, rels))
    gj = jax_s.create_graph(jax_node_tables(jax_s.table_factory, nodes),
                            jax_rel_tables(jax_s.table_factory, rels))
    return gp, gj


def _bits(rows):
    """Rows with each float replaced by its IEEE bits."""
    return [{k: (np.float64(v).view(np.int64).item()
                 if isinstance(v, float) else v) for k, v in r.items()}
            for r in rows]


def test_sqrt_and_stdev_bitwise_equal_to_jax(sessions):
    rng = np.random.RandomState(5)
    n = 320
    ages = rng.randint(0, 100_000, n)
    xs = rng.rand(n) * 1000
    nodes = [(i, ("Person",), {"age": int(ages[i]), "x": float(xs[i]),
                                "g": int(i % 9)}) for i in range(n)]
    gp, gj = _graphs(sessions, nodes)
    for q in ("MATCH (a:Person) RETURN sqrt(a.age) AS s, sqrt(a.x) AS t, "
              "id(a) AS i ORDER BY i",
              "MATCH (a:Person) RETURN a.g AS g, stDev(a.x) AS sd, "
              "stDev(a.age) AS sa ORDER BY g"):
        got = gp.cypher(q).records.to_maps()
        want = gj.cypher(q).records.to_maps()
        assert len(got) == len(want) > 0
        assert _bits(got) == _bits(want), q


def test_optional_match_matches_jax(sessions):
    rng = np.random.RandomState(9)
    n_people, n_edges = 60, 90
    nodes = [(i, ("Person",), {"name": f"p{i}", "age": int(a)})
             for i, a in enumerate(rng.randint(18, 60, n_people))]
    src = rng.randint(0, n_people, n_edges)
    tgt = rng.randint(0, n_people, n_edges)
    rels = [(1000 + k, int(s), int(t), "KNOWS", {"w": int(k % 5)})
            for k, (s, t) in enumerate(zip(src, tgt))]
    gp, gj = _graphs(sessions, nodes, rels)
    for q in ("MATCH (a:Person) WHERE a.age < 30 "
              "OPTIONAL MATCH (a)-[r:KNOWS]->(b:Person) WHERE b.age > 40 "
              "RETURN a.name AS a, b.name AS b, r.w AS w",
              "MATCH (a:Person) OPTIONAL MATCH (a)-[:KNOWS]->(b) "
              "RETURN a.name AS a, count(b) AS n"):
        got = gp.cypher(q).records.to_maps()
        want = gj.cypher(q).records.to_maps()
        bag = collections.Counter(tuple(sorted(r.items())) for r in got)
        assert bag == collections.Counter(tuple(sorted(r.items()))
                                          for r in want), q
        assert any(r.get("b") is None or r.get("n") == 0 for r in got)


# -- expressions the slice's scenarios reach (string, list, null) -------------

EXPRESSION_QUERIES = {
    "strings": (
        "MATCH (a:P) RETURN a.s AS s, substring(a.s, 1, 2) AS sub, "
        "substring(a.s, 2) AS sub2, left(a.s, 2) AS l, right(a.s, 2) AS r, "
        "replace(a.s, 'a', 'XY') AS rep, split(a.s, 'a') AS sp, "
        "toInteger(a.s) AS i, toFloat(a.s) AS f, toBoolean(a.s) AS b, "
        "a.s + '!' AS c, '<' + a.s AS d, toString(a.v > 0) AS ts "
        "ORDER BY id(a)"),
    "lists": (
        "MATCH (a:P) WITH a.g AS g, collect(a.v) AS vs "
        "RETURN g, head(vs) AS h, last(vs) AS l, tail(vs) AS t, "
        "reverse(vs) AS r, vs[1..3] AS s1, vs[-2..] AS s2, vs[..1] AS s3, "
        "vs + [7, 8] AS cat, size(vs) AS n ORDER BY g"),
    "nulls": (
        "MATCH (a:P) RETURN CASE WHEN a.v > 3 THEN null ELSE a.v END AS c, "
        "coalesce(a.missing, a.v) AS co, a.v < 'x' AS cmp, "
        "a.missing + 1 AS m, toUpper(a.missing) AS u, "
        "null IN [1, 2] AS i1, null IN [] AS i2 ORDER BY id(a)"),
    "null_beside_bool": (
        "MATCH (a:P) RETURN toString(coalesce(null, a.v > 0)) AS t, "
        "coalesce(null, a.v > 0) IN [true] AS i, "
        "toBoolean(CASE WHEN a.v > 3 THEN null ELSE a.v > 0 END) AS b, "
        "toString(coalesce(a.v > 2, null)) AS t2 ORDER BY id(a)"),
    "constants": (
        "MATCH (a:P) WHERE a.g = 0 RETURN range(5, 1, -2) AS r, "
        "range(1, 4) AS r2, [1, 2, 3, 4][1..3] AS s, head([]) AS h, "
        "toString(7) AS t, 'foo' + 'bar' AS c LIMIT 1"),
}


@pytest.mark.parametrize("name", list(EXPRESSION_QUERIES))
def test_expressions_match_jax(sessions, name):
    rng = np.random.RandomState(3)
    words = ["banana", "42", "3.5", "x", "true", "FALSE", "", "a", "1e3",
             "-7", "alpha"]
    nodes = [(i, ("P",), {"s": words[rng.randint(len(words))],
                           "v": int(rng.randint(-5, 10)),
                           "g": int(rng.randint(0, 4))})
             for i in range(40)]
    gp, gj = _graphs(sessions, nodes)
    q = EXPRESSION_QUERIES[name]
    got = gp.cypher(q).records.to_maps()
    want = gj.cypher(q).records.to_maps()
    assert len(got) == len(want) > 0
    assert got == want


def test_collect_unwind_generic_replay_matches_eager():
    """collect then UNWIND under rotating parameters whose longest list
    grows by one each time: every run equals the eager path, and the
    runs settle into param-generic replays (the list width is rounded
    up to a power of two, so a longer list still fits; an exact width
    would re-record every time and stop generic replay after three)."""
    from caps_tpu_torch.interop import graph_from_numpy
    from caps_tpu_torch.relational.session import degraded_execution
    # person i (age 20 + i) knows 9 + i others; the rest know one each
    n, seeds = 200, 6
    src = np.concatenate([np.full(9 + i, i) for i in range(seeds)]
                         + [np.arange(seeds, n)])
    rng = np.random.RandomState(21)
    tgt = rng.randint(0, n, len(src))
    cities = np.array([f"c{i:02d}" for i in range(7)])
    nodes = {"Person": {"_id": np.arange(n, dtype=np.int64),
                        "age": np.where(np.arange(n) < seeds,
                                        20 + np.arange(n), 99),
                        "city": cities[rng.randint(0, 7, n)]}}
    rels = {"KNOWS": {"_id": np.arange(n, n + len(src), dtype=np.int64),
                      "_src": src.astype(np.int64),
                      "_tgt": tgt.astype(np.int64)}}
    session = caps_tpu_torch.local_session(device="cpu")
    graph = graph_from_numpy(session, nodes, rels)
    q = ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age = $age "
         "WITH a, collect(b.city) AS cs UNWIND cs AS c "
         "RETURN c AS city, count(*) AS n ORDER BY n DESC, city")
    modes = []
    for age in range(20, 20 + seeds):
        got = graph.cypher(q, {"age": age}).records.to_maps()
        modes.append(session.fused.last_mode)
        with degraded_execution(no_plan_cache=True, no_fused=True):
            want = graph.cypher(q, {"age": age}).records.to_maps()
        assert got == want, age
        assert sum(r["n"] for r in got) == 9 + age - 20
    # the first ages re-record as the row counts' served bounds widen to
    # their buckets; the list width must not hold the replays back
    assert modes[-3:] == ["replay_gen"] * 3, modes


@pytest.mark.parametrize("query", [
    "MATCH (a:P) RETURN a.s + '!' AS c ORDER BY id(a)",
    "MATCH (a:P) RETURN '<' + replace(substring(a.s, 1), 'a', 'aa') AS c, "
    "split(a.s, 'a') AS sp ORDER BY id(a)",
])
def test_string_functions_leave_the_pool_alone_when_run_again(query):
    """A string function that makes new strings adds them to the pool
    once: running the query again adds nothing, so it replays and the
    answer stays the same (a table over the whole pool would map the
    last run's results as well, on every run)."""
    session = caps_tpu_torch.local_session(device="cpu")
    words = ["banana", "x", "", "alpha", "java"]
    graph = session.create_graph(build_node_tables(
        session.table_factory,
        [(i, ("P",), {"s": words[i % len(words)]}) for i in range(12)]),
        [])
    first = graph.cypher(query).records.to_maps()
    size = len(session.backend.pool)
    modes = []
    for _ in range(3):
        assert graph.cypher(query).records.to_maps() == first
        modes.append(session.fused.last_mode)
        assert len(session.backend.pool) == size
    assert modes == ["replay"] * 3, modes
