"""List expressions on the port's device backend, held to the JAX package.

Comprehensions, quantifiers, reduce, list literals of columns, entity
access on lambda variables, labels / keys, nodes and relationships of
var-length paths, Disjoint, DISTINCT / ORDER BY / UNWIND over list
columns and collect of int64 and float values run on the port's device
backend (``backends/cuda/lists.py``; on the CPU, the same torch code).
Each query runs on three engines over the same seeded graph and must
answer the same bag of rows (the ordered list, for an ORDER BY):

* the port's ``local_session(device="cpu")``;
* the JAX package's ``TPUCypherSession`` on the CPU, whose host
  fallback gives the reference's answers;
* the port's own oracle, ``local_session(backend="local")``.

Ints, strings and booleans compare exactly, floats to 1e-12 relative.
The graph (numpy ``RandomState(13)``): 40 ``:Person {name, age, score,
xs, big}`` and 20 ``:City {name, pop}`` with some null properties and
ids both large and negative, 200 ``:KNOWS {w}`` and 100 ``:LIVES
{since}`` edges.
"""
import math

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import caps_tpu
import caps_tpu_torch
from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice
from caps_tpu_torch.relational.session import degraded_execution
from test_torch_algo import port_make_graph
from util import make_graph


def arrays():
    rng = np.random.RandomState(13)
    pool = np.concatenate([np.arange(-2_000_000_000, -1_999_999_000, 37),
                           np.arange(-50, 50),
                           np.arange(2_000_000_000, 2_000_001_000, 41)])
    ids = [int(i) for i in rng.choice(pool, size=60, replace=False)]
    people, cities = ids[:40], ids[40:]

    def maybe(v, p=0.15):
        return None if rng.rand() < p else v

    person = []
    for i, nid in enumerate(people):
        row = {"_id": nid, "name": f"p{i:02d}",
               "age": maybe(int(rng.randint(16, 70))),
               "score": maybe(float(np.round(rng.uniform(-5, 5), 3))),
               "big": int(2 ** 40 + rng.randint(0, 1000)) * (1 - 2 * (i % 2))}
        xs = maybe([int(x) for x in rng.randint(-3, 6,
                                                size=rng.randint(0, 5))])
        if xs is not None:
            row["xs"] = xs
        person.append(row)
    city = [{"_id": nid, "name": f"c{i:02d}",
             "pop": maybe(int(rng.randint(1, 10 ** 6)))}
            for i, nid in enumerate(cities)]
    knows = [(people[a], people[b], {"w": int(rng.randint(1, 10))})
             for a, b in rng.randint(0, 40, size=(200, 2)) if a != b]
    lives = [(people[a], cities[b], {"since": maybe(int(rng.randint(1990,
                                                                     2020)))})
             for a, b in zip(rng.randint(0, 40, 100), rng.randint(0, 20, 100))]
    return ({("Person",): person, ("City",): city},
            {"KNOWS": knows, "LIVES": lives})


@pytest.fixture(scope="module")
def engines():
    nodes, rels = arrays()
    port = port_make_graph(caps_tpu_torch.local_session(device="cpu"),
                           nodes, rels)
    ref = make_graph(caps_tpu.local_session(backend="tpu"), nodes, rels)
    own = port_make_graph(caps_tpu_torch.local_session(backend="local"),
                          nodes, rels)
    return port, ref, own


def norm(v):
    """A value in a form both packages share: entities as (kind, id)."""
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    if hasattr(v, "id") and hasattr(v, "labels"):
        return ("node", v.id)
    if hasattr(v, "id") and hasattr(v, "rel_type"):
        return ("rel", v.id)
    return v


def close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return (isinstance(a, (int, float)) and isinstance(b, (int, float))
                and not isinstance(a, bool) and not isinstance(b, bool)
                and math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _key(row):
    def k(v):
        if isinstance(v, float):
            return f"{v:.9g}"
        if isinstance(v, (list, tuple)):
            return [k(x) for x in v]
        return v
    return repr([k(v) for v in row])


def rows_of(graph, query, params=None, ordered=False):
    maps = graph.cypher(query, params or {}).records.to_maps()
    out = [[norm(m[c]) for c in sorted(m)] for m in maps]
    return out if ordered else sorted(out, key=_key)


def assert_same(engines, query, params=None, ordered=False):
    port, ref, own = (rows_of(g, query, params, ordered) for g in engines)
    for name, other in (("JAX package", ref), ("port oracle", own)):
        assert len(port) == len(other) and all(
            close(a, b) for a, b in zip(port, other)), \
            f"{name} differs on {query!r}:\n{port[:5]}\n{other[:5]}"
    return port


WITH_AGES = ("MATCH (a:Person)-[:KNOWS]->(b:Person) "
             "WITH a, collect(b.age) AS ages ")

COMPREHENSIONS = {
    "filter": "MATCH (a:Person) RETURN a.name AS n, [x IN a.xs WHERE x > 1] "
              "AS r",
    "project": WITH_AGES + "RETURN a.name AS n, [x IN ages | x * 2] AS r",
    "filter_project": WITH_AGES + "RETURN a.name AS n, "
                                  "[x IN ages WHERE x > 30 | x - a.age] AS r",
    "nested": "MATCH (a:Person) RETURN a.name AS n, "
              "[x IN [1, 2] | [y IN [10, a.age] | x * y]] AS r",
    "nested_sees_outer": "MATCH (a:Person) WHERE a.xs IS NOT NULL "
                         "RETURN a.name AS n, [x IN a.xs | "
                         "size([y IN a.xs WHERE y < x])] AS r",
    "over_lists_of_lists": "MATCH (a:Person) RETURN a.name AS n, "
                           "[y IN [x IN a.xs | [x, a.age]] WHERE y[1] > 30 "
                           "| size(y) + y[0]] AS r, "
                           "reduce(s = 0, y IN [[1, a.age], [2]] | "
                           "s + size(y)) AS t",
    "shadowing": "MATCH (a:Person)-[:KNOWS]->(b:Person) "
                 "RETURN a.name AS n, b.name AS m, [a IN [b] | a.name] AS r",
    "null_list": "MATCH (a:Person) RETURN a.name AS n, "
                 "[x IN a.xs | x + 1] AS r, size([x IN a.xs | x]) AS s",
    "empty_list": "MATCH (a:City) RETURN a.name AS n, [x IN [] | x] AS r, "
                  "[x IN [a.pop] WHERE false] AS e",
    "null_elements": "MATCH (a:Person) RETURN a.name AS n, "
                     "[x IN [a.age, null, a.pop, 3] | x] AS r, "
                     "[x IN [a.age, null, 3] WHERE x IS NULL | 0] AS z",
    "float_elements": "MATCH (a:Person)-[:KNOWS]->(b:Person) "
                      "WITH a, collect(b.score) AS s RETURN a.name AS n, "
                      "[x IN s WHERE x > 0.5 | x * 2.0] AS r",
    "bool_elements": WITH_AGES + "RETURN a.name AS n, "
                                 "[x IN ages | x > 40] AS r",
    "string_elements": "MATCH (a:Person)-[:KNOWS]->(b:Person) "
                       "WITH a, collect(b.name) AS ns RETURN a.name AS n, "
                       "[x IN ns WHERE x > 'p2' | x] AS r",
    "division_error_free": WITH_AGES + "RETURN a.name AS n, "
                           "[x IN ages WHERE x <> 0 | 1000 / x] AS r",
}


@pytest.mark.parametrize("query", list(COMPREHENSIONS.values()),
                         ids=list(COMPREHENSIONS))
def test_comprehension(engines, query):
    assert assert_same(engines, query)


QUANT_LISTS = [[1, 2], [1, -1], [1, None], [], [None], [-1, -2],
               [1, 2, None], [-1, None], [2]]


@pytest.mark.parametrize("kind", ["all", "any", "none", "single"])
def test_quantifier_three_valued_table(engines, kind):
    """Every cell of the three-valued table: each list of QUANT_LISTS
    (true, false and null verdicts, the empty list) and a null list."""
    q = (f"UNWIND range(0, {len(QUANT_LISTS)}) AS i "
         f"WITH i, CASE WHEN i < {len(QUANT_LISTS)} THEN $lists[i] END AS l "
         f"RETURN i, {kind}(x IN l WHERE x > 0) AS v")
    rows = assert_same(engines, q, {"lists": QUANT_LISTS})
    assert len(rows) == len(QUANT_LISTS) + 1


QUANTIFIERS = {
    "entities": "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN a.name AS n, "
                "b.name AS m, all(x IN [a, b] WHERE x.age >= 18) AS al, "
                "any(x IN [a, b] WHERE x.age > 60) AS an, "
                "none(x IN [a, b] WHERE x.score > 4) AS no, "
                "single(x IN [a, b] WHERE x.age > 40) AS si",
    "where": "MATCH (a:Person)-[:KNOWS]->(b:Person) "
             "WHERE any(x IN [a, b] WHERE x.age < 20) RETURN a.name AS n, "
             "b.name AS m",
    "collected": WITH_AGES + "RETURN a.name AS n, "
                             "all(x IN ages WHERE x > 20) AS al, "
                             "single(x IN ages WHERE x > 60) AS si",
}


@pytest.mark.parametrize("query", list(QUANTIFIERS.values()),
                         ids=list(QUANTIFIERS))
def test_quantifier(engines, query):
    assert_same(engines, query)


REDUCES = {
    "ints": WITH_AGES + "RETURN a.name AS n, "
                        "reduce(s = 0, x IN ages | s + x) AS r",
    "floats": "MATCH (a:Person)-[:KNOWS]->(b:Person) "
              "WITH a, collect(b.score) AS s RETURN a.name AS n, "
              "reduce(t = 0.25, x IN s | t + x * 0.5) AS r",
    "bools": WITH_AGES + "RETURN a.name AS n, "
                         "reduce(b = true, x IN ages | b AND x > 25) AS r",
    "max": WITH_AGES + "RETURN a.name AS n, reduce(m = 0, x IN ages | "
                       "CASE WHEN x > m THEN x ELSE m END) AS r",
    "null_list": "MATCH (a:Person) RETURN a.name AS n, "
                 "reduce(s = 0, x IN a.xs | s + x) AS r",
    "entities": "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN a.name AS n, "
                "b.name AS m, reduce(s = 0, x IN [a, b] | s + x.age) AS r",
}


@pytest.mark.parametrize("query", list(REDUCES.values()), ids=list(REDUCES))
def test_reduce(engines, query):
    assert_same(engines, query)


ENTITY_ACCESS = {
    "node_props": "MATCH (a:Person)-[:LIVES]->(c:City) RETURN a.name AS n, "
                  "[x IN [a, c] | x.name] AS r, [x IN [a, c] | x.pop] AS p",
    "node_labels_ids": "MATCH (a:Person)-[:LIVES]->(c:City) "
                       "RETURN a.name AS n, [x IN [a, c] | labels(x)] AS l, "
                       "[x IN [a, c] | id(x)] AS i, "
                       "[x IN [a, c] WHERE x:City | x.name] AS h",
    "node_keys": "MATCH (a:Person) RETURN a.name AS n, "
                 "[x IN [a] | keys(x)] AS k",
    "rel_access": "MATCH (a:Person)-[r]->(b) RETURN id(r) AS i, "
                  "[x IN [r] | type(x)] AS t, [x IN [r] | x.w] AS w, "
                  "[x IN [r] | x.since] AS s, "
                  "[x IN [r] | id(startNode(x)) = id(a)] AS st, "
                  "[x IN [r] | id(endNode(x))] AS en",
    "collected_entities": "MATCH (a:Person)-[:KNOWS]->(b:Person) "
                          "WITH a, collect(b) AS fs RETURN a.name AS n, "
                          "[f IN fs WHERE f.age > a.age | f.name] AS r, "
                          "[f IN fs | f] AS e",
    "mixed_literal": "MATCH (a:Person) RETURN a.name AS n, "
                     "[x IN [a, 5] | x.name] AS r",
}


@pytest.mark.parametrize("query", list(ENTITY_ACCESS.values()),
                         ids=list(ENTITY_ACCESS))
def test_lambda_bound_entities(engines, query):
    assert_same(engines, query)


def test_lambda_bound_entities_on_a_snapshot_after_writes(engines):
    """A versioned snapshot's index holds its writes: a created node, a
    changed property and a deleted relationship are seen through a
    lambda variable, as the reference sees them."""
    from caps_tpu.relational import updates as JU
    from caps_tpu_torch.relational import updates as PU
    port, ref, own = engines
    graphs = [PU.versioned(port._session, port),
              JU.versioned(ref._session, ref),
              PU.versioned(own._session, own)]
    writes = ["MATCH (a:Person) WHERE a.name = 'p03' SET a.age = 99",
              "MATCH (a:Person) WHERE a.name = 'p05' "
              "CREATE (a)-[:KNOWS {w: 42}]->(:Person {name: 'new', age: 7})",
              "MATCH (a:Person)-[r:KNOWS]->(b) WHERE a.name = 'p07' "
              "DELETE r"]
    for g in graphs:
        for w in writes:
            g.cypher(w)
    q = ("MATCH (a:Person)-[r:KNOWS]->(b:Person) WITH a, collect(b) AS fs, "
         "collect(r) AS rs RETURN a.name AS n, [f IN fs | f.name] AS f, "
         "[f IN fs | f.age] AS g, [x IN rs | x.w] AS w, "
         "[x IN [a] | x.age] AS own")
    rows = assert_same(graphs, q)
    assert any("new" in r[0] for r in rows)


LITERALS = {
    "columns_with_nulls": "MATCH (a:Person)-[:LIVES]->(c:City) "
                          "RETURN a.name AS n, [a.age, c.pop, null] AS l",
    "entities": "MATCH (a:Person)-[:LIVES]->(c:City) RETURN a.name AS n, "
                "[a, c] AS l",
    "strings": "MATCH (a:Person) RETURN [a.name, 'x', null] AS l",
    "index": "MATCH (a:Person) RETURN a.name AS n, [a.age, 1][0] AS f, "
             "[a.age, 2][$i] AS g",
    "equality": "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN a.name AS n, "
                "b.name AS m, [a.age, 1] = [b.age, 1] AS eq, "
                "a.age IN [b.age, null] AS i",
}


@pytest.mark.parametrize("query", list(LITERALS.values()), ids=list(LITERALS))
def test_list_literal_of_columns(engines, query):
    assert_same(engines, query, {"i": None})


@pytest.mark.parametrize("query", [
    "MATCH (n) RETURN id(n) AS i, labels(n) AS l, keys(n) AS k",
    "MATCH (a:Person)-[r]->(b) RETURN id(r) AS i, keys(r) AS k",
], ids=["nodes", "rels"])
def test_labels_and_keys(engines, query):
    assert_same(engines, query)


PATHS = {
    "nodes": "MATCH p = (a:Person)-[:KNOWS*1..2]->(b:Person) "
             "WHERE a.age < 25 RETURN [n IN nodes(p) | id(n)] AS ns, "
             "[n IN nodes(p) | n.name] AS nm",
    "relationships": "MATCH p = (a:Person)-[:KNOWS*1..2]->(b:Person) "
                     "WHERE a.age < 25 RETURN [r IN relationships(p) | r.w] "
                     "AS ws, size(nodes(p)) AS s",
    "undirected": "MATCH p = (a:Person)-[:KNOWS*2]-(b) WHERE a.age > 60 "
                  "RETURN [n IN nodes(p) | n.name] AS nm",
    "unwind_nodes": "MATCH p = (a:Person)-[:KNOWS*2]->(b) WHERE a.age > 55 "
                    "UNWIND nodes(p) AS n RETURN n.name AS nm",
}


@pytest.mark.parametrize("query", list(PATHS.values()), ids=list(PATHS))
def test_path_nodes_and_relationships(engines, query):
    assert_same(engines, query)


def test_disjoint_through_two_var_length_patterns(engines):
    """Relationship uniqueness between two var-length patterns of one
    MATCH (the planner's Disjoint)."""
    assert_same(engines, "MATCH (a:Person)-[r1:KNOWS*1..2]->(b:Person)"
                         "-[r2:KNOWS*1..2]->(c:Person) WHERE a.age > 60 "
                         "RETURN a.name AS a, b.name AS b, c.name AS c")


SORTING = {
    "distinct": WITH_AGES + "RETURN DISTINCT [x IN ages WHERE x > 50] AS l",
    "order_by": WITH_AGES + "RETURN a.name AS n, ages ORDER BY ages, n",
    "order_by_desc": "MATCH (a:Person)-[:KNOWS]->(b:Person) WITH a, "
                     "collect(b.name) AS ns RETURN a.name AS n, ns "
                     "ORDER BY ns DESC, n",
    "order_by_nulls": "MATCH (a:Person) RETURN a.name AS n, [a.age, 1] AS l "
                      "ORDER BY l, n",
    "order_by_floats": "MATCH (a:Person)-[:KNOWS]->(b:Person) WITH a, "
                       "collect(b.score) AS s RETURN a.name AS n, s "
                       "ORDER BY s DESC, n",
    "group_by_list": "MATCH (a:Person) RETURN [x IN a.xs WHERE x > 2] AS l, "
                     "count(*) AS c",
}


@pytest.mark.parametrize("query", list(SORTING.values()), ids=list(SORTING))
def test_distinct_and_order_by_list_columns(engines, query):
    assert_same(engines, query, ordered="ORDER BY" in query)


@pytest.mark.parametrize("query", [
    "MATCH (a:Person) UNWIND [a.age, null, 1] AS x RETURN a.name AS n, x",
    "UNWIND [[1, null], null, [], [2]] AS l RETURN l",
    "MATCH (a:Person) UNWIND [x IN a.xs | CASE WHEN x > 2 THEN x END] AS y "
    "RETURN a.name AS n, y",
], ids=["column_items", "nested_constant", "comprehension"])
def test_unwind_of_null_elements(engines, query):
    assert_same(engines, query)


@pytest.mark.parametrize("query", [
    "MATCH (a:Person) RETURN collect(a.big) AS c",
    "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN a.name AS n, "
    "collect(b.big) AS c, collect(b.score) AS s",
], ids=["int64", "grouped"])
def test_collect_of_int64_and_float_values(engines, query):
    assert_same(engines, query)


# -- property-based --------------------------------------------------------

_SESSIONS = {}


def _pair():
    if not _SESSIONS:
        _SESSIONS["port"] = caps_tpu_torch.local_session(device="cpu")
        _SESSIONS["own"] = caps_tpu_torch.local_session(backend="local")
        for k in ("port", "own"):
            _SESSIONS[k + "_g"] = _SESSIONS[k].create_graph((), ())
    return _SESSIONS["port_g"], _SESSIONS["own_g"]


@settings(max_examples=40, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.one_of(st.none(), st.lists(
    st.one_of(st.none(), st.integers(-5, 5)), max_size=5)), max_size=6))
def test_random_int_lists_with_nulls(lists):
    """Random int lists with null elements (and null lists) through a
    comprehension, the quantifiers and a reduce: the port's device
    backend answers as its oracle."""
    q = ("UNWIND $ls AS l RETURN l, [x IN l WHERE x > 0 | x * 3] AS c, "
         "any(x IN l WHERE x > 2) AS an, all(x IN l WHERE x < 4) AS al, "
         "none(x IN l WHERE x = 0) AS no, single(x IN l WHERE x < 0) AS si, "
         "reduce(s = 1, x IN l | s + coalesce(x, 10)) AS r")
    port, own = _pair()
    a = port.cypher(q, {"ls": lists}).records.to_maps()
    b = own.cypher(q, {"ls": lists}).records.to_maps()
    assert a == b


# -- fused replay and the causes left out ----------------------------------

def test_exact_replay_of_a_comprehension_reads_nothing(engines):
    """A recorded comprehension query replays with 0 size reads; its
    body's error site (a division) costs one read of the error mask in
    an eager run, however many element rows the body ran over."""
    port = engines[0]
    body = WITH_AGES + "RETURN a.name AS n, [x IN ages WHERE x > {} | {}] AS r"
    safe, risky = body.format(0, "x * 2"), body.format(0, "100 / x")
    first = port.cypher(risky, {})
    again = port.cypher(risky, {})
    assert port._session.fused.last_mode == "replay"
    assert again.metrics["size_syncs"] == 0
    assert again.records.to_maps() == first.records.to_maps()
    with degraded_execution(no_plan_cache=True, no_fused=True):
        eager_safe = port.cypher(safe, {}).metrics["size_syncs"]
        eager_risky = port.cypher(risky, {}).metrics["size_syncs"]
    assert eager_risky == eager_safe + 1


@pytest.mark.parametrize("query,cause", [
    ("MATCH (a:Person) RETURN [[[a.age]], 1] AS l", "list of"),
    ("MATCH (a:Person) RETURN sum(a.xs) AS s", "group: sum over kind list"),
], ids=["three_levels", "sum_of_lists"])
def test_causes_left_out_raise_on_the_device_path(engines, query, cause):
    """Causes still without a device path raise naming themselves: one
    the reference answers (open, ROADMAP Queue 1) and one it refuses
    too (a sum of lists is a TypeError there)."""
    with pytest.raises(UnsupportedOnDevice, match=cause):
        engines[0].cypher(query, {}).records.to_maps()


@pytest.mark.parametrize("query", [
    "MATCH (a:Person)-[r:KNOWS]->(b:Person) "
    "RETURN [x IN [a, r] | 1] AS l, [x IN [a, r] | x.name] AS n",
    "MATCH (a:Person) RETURN [[a.age]] = [[1]] AS e, "
    "[[a.age, 2]] = [[a.age, 2]] AS f",
    "MATCH (a:Person) RETURN substring(a.name, a.age % 3) AS s",
    "MATCH (a:Person) RETURN [duration({days: coalesce(a.age, 0)})][0].days "
    "AS d, size([duration({days: 1}), null]) AS n",
], ids=["nodes_and_relationships", "lists_of_lists_equal",
        "string_function_column_argument", "list_of_durations"])
def test_causes_answered_on_the_device_path(engines, query):
    """Causes that raised on the device path before now answer as the
    JAX package and the port's oracle do."""
    assert_same(engines, query)
