"""Nested list columns on the port's device backend: lists of lists at any
depth, of ints, of mixed values and of maps, held as a list of child rows
(``caps_tpu_torch/backends/cuda/column.py``: a list of lists' ``data``
holds each element's row in ``child``, a list column of the inner lists).

Each case runs on three engines over one seeded graph, the graph of
``tests/test_torch_lists.py arrays()`` with list-of-lists properties added
to every ``:Person`` (``visits`` of ints and ``deep`` of three levels, with
null rows, null and empty inner lists and null elements; ``mixed``, lists
of mixed values; ``places``, lists of maps; ``groups``, lists of lists of
maps) and to every ``:City`` (``hours``), and the three must answer the
same bag of rows (the ordered list, for an ORDER BY):

* the port's ``local_session(device="cpu")``, whose device backend runs
  the same torch code as on the card;
* the JAX package's ``local_session(backend="tpu")`` on the CPU, which
  keeps such properties as host objects and answers through its host
  fallback;
* the port's own oracle, ``local_session(backend="local")``.

Values compare exactly, floats to 1e-12 relative; maps compare as dicts.
The ingest is also held through ``io/fs.py``: a graph stored by the
port and loaded back reads as the JAX package reads the same files.
"""
import numpy as np
import pytest
import torch

import caps_tpu
import caps_tpu_torch
from caps_tpu.io.fs import FSGraphSource as JaxFS
from caps_tpu.okapi.graph import Namespace as JaxNamespace
from caps_tpu_torch.backends.cuda.column import make_column
from caps_tpu_torch.io.fs import FSGraphSource
from caps_tpu_torch.okapi.graph import Namespace
from caps_tpu_torch.okapi.types import (
    CTAny, CTBoolean, CTFloat, CTInteger, CTList, CTMap,
)
from test_torch_algo import port_make_graph
from test_torch_expr_gaps import close, rows_of
from test_torch_lists import arrays
from util import make_graph

P = "MATCH (a:Person) "
KNOWS = "MATCH (a:Person)-[:KNOWS]->(b:Person) "


def nested_arrays(with_values: bool = True):
    """``arrays()`` with list-of-lists properties drawn from a seed;
    ``with_values`` False keeps those Arrow can store (lists of lists of
    ints)."""
    nodes, rels = arrays()
    rng = np.random.RandomState(29)

    def maybe(v, p):
        return None if rng.rand() < p else v

    def ints(k):
        return [maybe(int(x), 0.15) for x in rng.randint(-3, 6, size=k)]

    def inner():
        return maybe(ints(rng.randint(0, 4)), 0.1)

    for row in nodes[("Person",)]:
        visits = maybe([inner() for _ in range(rng.randint(0, 5))], 0.1)
        if visits is not None:
            row["visits"] = visits
        deep = maybe([maybe([inner() for _ in range(rng.randint(0, 3))], 0.1)
                      for _ in range(rng.randint(0, 4))], 0.15)
        if deep is not None:
            row["deep"] = deep
        if not with_values:
            continue
        choices = [lambda: int(rng.randint(0, 9)),
                   lambda: f"s{rng.randint(0, 4)}",
                   lambda: float(rng.randint(0, 8)) / 4,
                   lambda: bool(rng.randint(0, 2)), lambda: None]
        row["mixed"] = maybe([maybe([choices[rng.randint(0, 5)]()
                                     for _ in range(rng.randint(0, 4))], 0.1)
                              for _ in range(rng.randint(0, 4))], 0.15)
        row["places"] = maybe([maybe({"k": int(rng.randint(0, 5)),
                                      "n": f"n{rng.randint(0, 3)}"}, 0.1)
                               if rng.rand() < 0.8 else
                               {"k": int(rng.randint(0, 5))}
                               for _ in range(rng.randint(0, 4))], 0.15)
        row["groups"] = maybe([maybe([{"k": int(rng.randint(0, 3))}
                                      for _ in range(rng.randint(0, 3))], 0.1)
                               for _ in range(rng.randint(0, 3))], 0.15)
    for row in nodes[("City",)]:
        row["hours"] = maybe([[int(rng.randint(6, 12)),
                               int(rng.randint(14, 22))]
                              for _ in range(rng.randint(1, 3))], 0.2)
    return nodes, rels


@pytest.fixture(scope="module")
def engines():
    nodes, rels = nested_arrays()
    port = port_make_graph(caps_tpu_torch.local_session(device="cpu"),
                           nodes, rels)
    ref = make_graph(caps_tpu.local_session(backend="tpu"), nodes, rels)
    own = port_make_graph(caps_tpu_torch.local_session(backend="local"),
                          nodes, rels)
    return port, ref, own


CASES = {
    # ingest: the properties read back as they were given
    "read_back": P + "RETURN a.name AS n, a.visits AS v, a.deep AS d",
    "read_back_values": P + "RETURN a.name AS n, a.mixed AS m, "
                            "a.places AS p, a.groups AS g",
    "read_back_city": "MATCH (c:City) RETURN c.name AS n, c.hours AS h",
    # UNWIND at depth
    "unwind_twice": P + "UNWIND a.visits AS v UNWIND v AS x "
                        "RETURN a.name AS n, x",
    "unwind_three_times": P + "UNWIND a.deep AS d UNWIND d AS e UNWIND e AS x "
                              "RETURN x, count(*) AS c",
    "unwind_mixed": P + "UNWIND a.mixed AS m UNWIND m AS x "
                        "RETURN a.name AS n, x",
    "unwind_groups": P + "UNWIND a.groups AS g UNWIND g AS m "
                         "RETURN m.k AS k, count(*) AS c",
    # index, slice and size at depth
    "index_at_depth": P + "RETURN a.visits[0] AS f, a.visits[-1][0] AS g, "
                          "a.deep[0][0][-1] AS d, a.deep[1][0] AS e",
    "slice_at_depth": P + "RETURN a.visits[1..] AS s, a.visits[0][1..] AS t, "
                          "a.deep[..1] AS u, a.deep[0][-1..] AS w",
    "size_at_depth": P + "RETURN size(a.visits) AS n, size(a.visits[0]) AS m, "
                         "size(a.deep[0]) AS d, head(a.deep) AS h, "
                         "last(a.visits) AS l, tail(a.deep) AS t, "
                         "reverse(a.visits) AS r",
    # comprehensions, quantifiers, reduce
    "comprehension_over_inner_lists": P + (
        "RETURN [v IN a.visits WHERE size(v) > 1 | "
        "[x IN v WHERE x IS NOT NULL | x * 2]] AS v"),
    "comprehension_three_levels": P + (
        "RETURN [d IN a.deep | [e IN d | size(e)]] AS v, "
        "[d IN a.deep WHERE d IS NOT NULL] AS w"),
    "comprehension_mixed_values": P + (
        "RETURN [v IN a.visits WHERE size(v) > 2 | "
        "[x IN v WHERE x IS NOT NULL | [x, a.name]]] AS v"),
    "quantifiers": P + (
        "RETURN any(v IN a.visits WHERE v IS NULL) AS a, "
        "all(v IN a.visits WHERE size(v) > 0) AS b, "
        "none(v IN a.visits WHERE 1 IN v) AS c, "
        "single(d IN a.deep WHERE size(d) = 1) AS d"),
    "reduce_over_inner_lists": P + (
        "RETURN reduce(s = 0, v IN a.visits | s + size(v)) AS s, "
        "reduce(l = [], v IN a.visits | l + [size(v)]) AS l, "
        "reduce(l = [], v IN a.visits | l + [v]) AS m"),
    # equality and IN
    "equality": KNOWS + "RETURN a.visits = b.visits AS e, "
                        "a.visits[0] = b.visits[0] AS f, "
                        "a.deep <> b.deep AS g",
    "in_lists": KNOWS + "RETURN a.visits[0] IN b.visits AS i, "
                        "[1] IN a.visits AS j, [[1]] IN a.deep AS k",
    # ORDER BY, DISTINCT, group keys, collect
    "order_by_asc": P + "RETURN a.name AS n, a.visits AS v "
                        "ORDER BY a.visits, n",
    "order_by_desc": P + "RETURN a.name AS n, a.deep AS d "
                         "ORDER BY a.deep DESC, n",
    "order_by_mixed": P + "RETURN a.name AS n ORDER BY a.mixed, n",
    "distinct": P + "RETURN DISTINCT a.visits[0] AS v",
    "distinct_three_levels": P + "RETURN DISTINCT a.deep[..1] AS v",
    "group_key": P + "RETURN a.visits[..1] AS v, count(*) AS c",
    "group_key_three_levels": P + "RETURN a.deep AS d, count(*) AS c",
    "group_key_maps": P + "RETURN a.groups AS g, count(*) AS c",
    "collect": P + "WITH a.age % 3 AS g, a.visits AS v "
                   "RETURN g, collect(v) AS c",
    "collect_distinct": P + "RETURN collect(DISTINCT a.visits[0]) AS c",
    "collect_three_levels": P + "RETURN collect(a.deep) AS c",
    "collect_distinct_nested": P + "RETURN collect(DISTINCT a.visits) AS c",
    "min_max": P + "WITH a.age % 3 AS g, a RETURN g, min(a.visits) AS lo, "
                   "max(a.deep) AS hi",
    # null rows of an OPTIONAL MATCH, entity access in a lambda (the
    # graph's node index), properties() and coalesce
    "optional_match": "MATCH (c:City) OPTIONAL MATCH (a:Person)-[:LIVES]->(c) "
                      "WHERE a.age > 60 RETURN c.name AS n, a.visits AS v",
    "lambda_over_entities": KNOWS + (
        "WITH a, collect(b) AS bs RETURN a.name AS n, "
        "[x IN bs | x.visits] AS v, [x IN bs | x.groups[0]] AS g"),
    "properties": P + "RETURN properties(a) AS p",
    "coalesce": P + "RETURN coalesce(a.visits, [[0]]) AS c, "
                    "a.deep IS NULL AS n",
    # UNION and CASE
    "union_all": P + "RETURN a.visits AS v UNION ALL "
                     "MATCH (c:City) RETURN c.hours AS v",
    "union": P + "RETURN a.visits[..1] AS v UNION "
                 "MATCH (c:City) RETURN c.hours AS v",
    "union_three_levels": P + "RETURN a.deep AS v UNION ALL "
                              "RETURN [[[1, 'a']], null] AS v",
    "case": P + "RETURN CASE WHEN a.age > 30 THEN a.visits "
                "ELSE [[a.age], null] END AS v",
    "case_three_levels": P + "RETURN CASE WHEN a.age > 30 THEN a.deep "
                             "ELSE [[[1, 2]], []] END AS v",
    "concatenation": P + "RETURN a.visits + [[1]] AS v, "
                         "a.deep + a.deep AS w",
    # built lists of lists
    "three_levels_literal": P + "RETURN [[[a.age]]] AS v",
    "collect_of_lists_of_lists": P + "RETURN collect([[a.age]]) AS v",
    "collect_read_at_depth": P + "RETURN size(collect([[a.age]])) AS s, "
                                 "collect([[a.age, 1]])[1][0][1] AS v",
    "lists_of_mixed_values": "RETURN [[1, 'a']] AS v, [[1], ['a', 2.5]] AS w",
    "lists_of_lists_of_maps": P + "RETURN [[{k: a.age}]] AS v",
    "four_levels": P + "RETURN [[[[a.age, 1]], [[2], null]]] AS v",
    "temporal_and_float_inner_lists": P + (
        "WHERE a.age IS NOT NULL RETURN [[duration({days: a.age})], null] "
        "AS d, [[date('2020-01-01'), null], [a.score]] AS t, "
        "[[a.score, 1.5], [a.name]] AS f ORDER BY f DESC, d"),
    "distinct_unwound": P + "UNWIND a.visits AS v WITH v WHERE v IS NOT NULL "
                            "RETURN DISTINCT v ORDER BY v",
    "mixed_values_read": P + "RETURN a.mixed[0] AS f, "
                             "[m IN a.mixed | size(m)] AS s, "
                             "a.mixed[0][0] AS e",
    "maps_read": P + "RETURN a.places[0].k AS k, [p IN a.places | p.n] AS n, "
                     "a.groups[0][0].k AS g, a.places[0] AS p",
    "folded": P + "WITH [v IN a.visits WHERE size(v) > 2 | "
                  "[x IN v WHERE x IS NOT NULL | [x, a.name]]] AS l "
                  "RETURN count(*) AS c, sum(size(l)) AS s",
}


@pytest.mark.parametrize("name", list(CASES))
def test_answers_as_the_reference(engines, name):
    query = CASES[name]
    ordered = "ORDER BY" in query
    port, ref, own = (rows_of(g, query, ordered) for g in engines)
    for what, other in (("JAX package", ref), ("port oracle", own)):
        assert len(port) == len(other) and all(
            close(a, b) for a, b in zip(port, other)), \
            f"{what} differs on {query!r}:\n{port[:5]}\n{other[:5]}"


@pytest.mark.parametrize("name", ["unwind_twice", "order_by_desc",
                                  "collect_of_lists_of_lists", "case",
                                  "comprehension_mixed_values"])
def test_an_exact_replay_reads_no_size(engines, name):
    """A recorded query over nested lists replays with 0 size reads and
    the recorded rows."""
    port = engines[0]
    query = CASES[name]
    first = port.cypher(query)
    again = port.cypher(query)
    assert port._session.fused.last_mode == "replay"
    assert again.metrics["size_syncs"] == 0
    assert again.records.to_maps() == first.records.to_maps()


def test_a_generic_replay_answers_as_the_eager_path(engines):
    """A nested query recorded at one ``$x`` replays for others
    (param-generic replay, at most one size read) with the eager path's
    rows."""
    from caps_tpu_torch.relational.session import degraded_execution
    port = engines[0]
    query = P + ("WHERE a.age > $x UNWIND a.deep AS d "
                 "RETURN collect([d, [[a.age]]]) AS c, count(*) AS n")
    port.cypher(query, {"x": 20}).records.to_maps()
    for x in (30, 45, 60):
        got = port.cypher(query, {"x": x})
        assert port._session.fused.last_mode == "replay_gen"
        assert got.metrics["size_syncs"] <= 1
        with degraded_execution(no_plan_cache=True, no_fused=True):
            want = port.cypher(query, {"x": x}).records.to_maps()
        assert got.records.to_maps() == want


def _random_values(seed: int, depth: int):
    """40 seeded values of one depth: null rows, null and empty lists at
    every level, null and repeated leaves (so that ties, prefixes and
    nulls meet in every comparison)."""
    rng = np.random.RandomState(seed)

    def value(level):
        if rng.rand() < 0.12:
            return None
        if level == 0:
            return int(rng.randint(0, 3))
        return [value(level - 1) for _ in range(rng.randint(0, 3))]
    return [value(depth) for _ in range(40)]


@pytest.mark.parametrize("seed,depth", [(1, 2), (2, 2), (3, 3), (4, 3),
                                        (5, 4)])
def test_seeded_nested_values_order_group_and_compare(seed, depth):
    """Seeded lists of depth 2–4 on 40 nodes: ORDER BY both ways,
    DISTINCT, grouping, ``=`` across a cross product and UNWIND as the
    port's oracle and the JAX package answer."""
    values = _random_values(seed, depth)
    nodes = {("N",): [dict({"_id": i, "i": i}, **({} if v is None
                                                  else {"v": v}))
                      for i, v in enumerate(values)]}
    graphs = (port_make_graph(caps_tpu_torch.local_session(device="cpu"),
                              nodes, {}),
              make_graph(caps_tpu.local_session(backend="tpu"), nodes, {}),
              port_make_graph(caps_tpu_torch.local_session(backend="local"),
                              nodes, {}))
    queries = [
        "MATCH (n:N) RETURN n.v AS v, n.i AS i ORDER BY v, i",
        "MATCH (n:N) RETURN n.v AS v, n.i AS i ORDER BY v DESC, i",
        "MATCH (n:N) RETURN DISTINCT n.v AS v",
        "MATCH (n:N) RETURN n.v[0] AS v, count(*) AS c",
        "MATCH (n:N), (m:N) WHERE n.i < m.i RETURN n.i AS a, m.i AS b, "
        "n.v = m.v AS e, n.v[0] = m.v[-1] AS f",
        "MATCH (n:N) UNWIND n.v AS x RETURN n.i AS i, x, size(x) AS s",
    ]
    for query in queries:
        ordered = "ORDER BY" in query
        port, ref, own = (rows_of(g, query, ordered) for g in graphs)
        for what, other in (("JAX package", ref), ("port oracle", own)):
            assert len(port) == len(other) and all(
                close(a, b) for a, b in zip(port, other)), \
                f"{what} differs on {query!r}:\n{port[:5]}\n{other[:5]}"


def test_representation_is_one_level_per_child():
    """A list of lists holds its inner lists as the rows of a child
    column: memory is the sum over levels, and a three-level column is a
    chain of two children (no field for one depth)."""
    s = caps_tpu_torch.local_session(device="cpu")
    be = s.table_factory.backend
    values = [[[[1, 2], None], None, []], None, [[[3]]]]
    col = make_column(values, CTList(CTList(CTList(CTInteger))), 4,
                      be.pool, be.device)
    assert col.depth == 3 and col.child.depth == 2
    assert col.data.shape == (4, 3) and col.child.capacity == 4
    assert col.child.child.capacity == 3
    assert not hasattr(col, "inner_lens")
    from caps_tpu_torch.backends.cuda.column import column_to_host
    assert column_to_host(col, 3, be.pool) == values
    gathered = col.take(col.data.new_tensor([2, 0]))
    assert gathered.child is col.child
    assert column_to_host(gathered, 2, be.pool) == [values[2], values[0]]


def test_from_columns_ingests_lists_of_lists():
    """``from_columns`` takes a list-of-lists column (and lists of maps
    and of mixed values) to the device, as the JAX package ingests it."""
    s = caps_tpu_torch.local_session(device="cpu")
    cols = {"x": [[[1, 2], [3]], None, [None, []]],
            "m": [[{"k": 1}, None], None, [{"k": 2, "n": "a"}]],
            "y": [[["a", 1]], [[None]], []]}
    types = {"x": CTList(CTList(CTInteger)), "m": CTList(CTMap),
             "y": CTList(CTList(CTAny))}
    table = s.table_factory.from_columns(cols, types)
    for c, want in cols.items():
        assert table.column_values(c) == want
    jax = caps_tpu.local_session(backend="tpu").table_factory.from_columns(
        {"x": cols["x"]}, {"x": caps_tpu.okapi.types.CTList(
            caps_tpu.okapi.types.CTList(caps_tpu.okapi.types.CTInteger))})
    assert jax.column_values("x") == table.column_values("x")
    assert table._cols["x"].nested and table._cols["y"].child.tags is not None


@pytest.mark.parametrize("ctype,rows", [
    (CTInteger, [[1, None, 3], None, [], [4, 2 ** 40]]),
    (CTFloat, [[1.5, None], None, [-0.0, 2.0, 3.25]]),
    (CTBoolean, [[True, None, False], [], None]),
], ids=["int", "float", "bool"])
def test_lists_ingest_in_bulk_as_in_a_loop(monkeypatch, ctype, rows):
    """Lists of ints, floats and booleans take the native runtime's bulk
    path; opted out, the per-element loop gives the same column."""
    from caps_tpu_torch import native
    s = caps_tpu_torch.local_session(device="cpu")
    be = s.table_factory.backend
    bulk = make_column(rows, CTList(ctype), 5, be.pool, be.device)
    monkeypatch.setenv(native.OPT_OUT_ENV, "1")
    loop = make_column(rows, CTList(ctype), 5, be.pool, be.device)
    for t in ("data", "valid", "lens", "elem_valid"):
        assert torch.equal(getattr(bulk, t), getattr(loop, t)), t
    assert loop.elem_valid is not None


def test_radix_joins_carry_nested_columns(engines):
    """On a 4-shard mesh whose joins are radix exchanges, the rows of a
    list of lists travel and their inner lists stay whole on the lead
    device: the rows equal the JAX package's."""
    from caps_tpu_torch.okapi.config import EngineConfig
    nodes, rels = nested_arrays()
    session = caps_tpu_torch.local_session(device="cpu", config=EngineConfig(
        mesh_shape=(4,), use_csr=False, broadcast_join_threshold=0))
    mesh = port_make_graph(session, nodes, rels)
    query = KNOWS + ("RETURN a.name AS n, b.visits AS v, b.deep AS d, "
                     "a.groups AS g")
    assert mesh.cypher(query).metrics["dist_joins"] > 0
    got, want = rows_of(mesh, query, False), rows_of(engines[1], query,
                                                      False)
    assert len(got) == len(want) and all(
        close(a, b) for a, b in zip(got, want))


def test_writes_and_compaction_keep_nested_values():
    """SET and CREATE of list-of-lists values on a versioned graph, read
    back before and after a compaction, as the port's oracle reads
    them."""
    from caps_tpu_torch.relational.updates import versioned
    nodes, rels = nested_arrays()
    read = (P + "WHERE a.name IN ['p01', 'p02', 'new'] RETURN a.name AS n, "
            "a.visits AS v, a.deep AS d ORDER BY n")
    answers = []
    for session in (caps_tpu_torch.local_session(device="cpu"),
                    caps_tpu_torch.local_session(backend="local")):
        vg = versioned(session, port_make_graph(session, nodes, rels))
        vg.cypher("MATCH (a:Person {name: 'p01'}) "
                  "SET a.visits = [[1, 2], null], a.deep = [[[3]], []]")
        vg.cypher("CREATE (:Person {name: 'new', visits: [[7], []]})")
        before = vg.cypher(read).records.to_maps()
        vg.compact()
        answers.append((before, vg.cypher(read).records.to_maps()))
    assert answers[0] == answers[1]
    assert answers[0][0] == answers[0][1]
    assert answers[0][0][0]["v"] == [[7], []]


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """The graph's storable properties stored by the port in parquet, and
    the directory read by the port and by the JAX package."""
    path = str(tmp_path_factory.mktemp("nested_fs"))
    nodes, rels = nested_arrays(with_values=False)
    session = caps_tpu_torch.local_session(device="cpu")
    session.catalog.register_source(Namespace("fs"),
                                    FSGraphSource(session, path))
    session.catalog.store("fs.g", port_make_graph(session, nodes, rels))
    loaded = session.catalog.graph("fs.g")
    jax = caps_tpu.local_session(backend="tpu")
    jax.catalog.register_source(JaxNamespace("fs"), JaxFS(jax, path))
    return loaded, jax.catalog.graph("fs.g")


@pytest.mark.parametrize("query", [
    P + "RETURN a.name AS n, a.visits AS v, a.deep AS d",
    P + "UNWIND a.deep AS d UNWIND d AS e RETURN a.name AS n, e",
    "MATCH (c:City) RETURN c.name AS n, c.hours AS h ORDER BY c.hours DESC, n",
], ids=["read_back", "unwind", "order_by"])
def test_fs_store_and_load(stored, query):
    ordered = "ORDER BY" in query
    port, ref = (rows_of(g, query, ordered) for g in stored)
    assert len(port) == len(ref) and all(
        close(a, b) for a, b in zip(port, ref)), f"{port[:5]}\n{ref[:5]}"
    assert any(r[-1] for r in port)
