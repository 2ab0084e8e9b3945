"""Lists and maps among values of other types on the port's device backend.

An "any" value holds a list or a map as its row in a side column of the
column (``backends/cuda/anyvalue.py``: ``child`` for the held lists,
``maps`` for the held maps), so CASE, UNION, list literals,
concatenation, ``reduce``, ``collect`` and UNWIND answer where the
values of one column are lists, maps and scalars side by side, and
``toString`` formats maps and lists of any kind.

Each case runs on the three engines of ``tests/test_torch_expr_gaps.py``
over the seeded graph of ``tests/test_torch_lists.py arrays()`` (the
port's ``local_session(device="cpu")``, the JAX package's
``local_session(backend="tpu")`` and the port's ``backend="local"``
oracle), and the three must answer the same bag of rows (the ordered
list, for an ORDER BY).  Values compare exactly, floats to 1e-12
relative; maps compare as dicts, toString's text letter for letter.
"""
import pytest

import caps_tpu
import caps_tpu_torch
from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.okapi.types import CTAny, CTMap
from caps_tpu_torch.relational.header import RecordHeader
from caps_tpu_torch.relational.table import ExprEvalError
from test_torch_algo import port_make_graph
from test_torch_expr_gaps import close, rows_of
from test_torch_lists import arrays
from util import make_graph

P = "MATCH (a:Person) "
LIVES = "MATCH (a:Person)-[:LIVES]->(c:City) "
G = "MATCH (a:Person) WITH coalesce(a.age, 0) AS g "
LIST_OR_NAME = "CASE WHEN a.age > 30 THEN a.xs ELSE a.name END"
MAP_OR_INT = "CASE WHEN a.age > 30 THEN {k: a.age % 3} ELSE a.age % 2 END"

CASES = {
    # the further queries the census's probe found
    "map_in_a_list_literal": P + "RETURN [{k: a.age}, 1] AS v",
    "unwind_lists_strings_and_maps": P + "UNWIND [a.xs, a.name, {k: 1}] "
                                         "AS x RETURN x",
    "collect_lists_or_strings": P + f"RETURN collect({LIST_OR_NAME}) AS v",
    "held_list_equals_a_list": P + "RETURN (CASE WHEN a.age > 30 THEN a.xs "
                                   "ELSE 1 END) = [1] AS v",
    "order_by_lists_or_strings": P + f"RETURN {LIST_OR_NAME} AS v "
                                     f"ORDER BY v",
    "distinct_maps_or_ints": P + f"RETURN DISTINCT {MAP_OR_INT} AS v",
    "to_string_of_nested_maps": P + "RETURN toString({k: [a.age], "
                                    "m: {x: a.name}}) AS v",
    "union_of_maps_and_ints": P + "RETURN {k: a.age} AS v UNION ALL "
                                  "MATCH (c:City) RETURN c.pop AS v",
    "lists_of_two_depths_in_a_literal": P + "RETURN [[1], [[a.age]]] AS v",
    # held values inside nested lists, three levels deep
    "held_lists_three_levels": P + "RETURN [[[a.xs, a.name]]] AS v",
    "held_maps_three_levels": P + "RETURN [[[{k: a.age}, 1]], [[a.name]]] "
                                  "AS v",
    "three_levels_of_two_depths": P + "RETURN [[[1], [[a.age]]], "
                                      "[[a.xs, 'x']]] AS v",
    # null held lists and maps, null values among them
    "null_held_lists_and_maps": P + "RETURN CASE WHEN a.age > 40 THEN a.xs "
        "WHEN a.age > 20 THEN {k: a.score} END AS v, "
        "[a.xs, {k: a.score}, null] AS w",
    "null_elements_compared": P + "RETURN [a.xs, 1] = [a.xs, 1] AS v, "
                                  "[a.xs, 1] = [[1], 1] AS w",
    # what reads a held list or map
    "size_index_slice": P + f"RETURN size({LIST_OR_NAME}) AS s, "
        f"({LIST_OR_NAME})[0] AS i, ({LIST_OR_NAME})[0..2] AS l",
    "entries_of_held_maps": P + "RETURN (CASE WHEN a.age > 30 THEN "
        "{k: a.age} ELSE a.name END).k AS p, (CASE WHEN a.age > 30 THEN "
        "{k: a.age} ELSE a.name END)['k'] AS i",
    "unwind_held_lists": P + f"UNWIND {LIST_OR_NAME} AS x RETURN x",
    "unwind_strings_and_maps": P + "UNWIND a.name AS x WITH x "
        "UNWIND {z: x, a: 1} AS k RETURN x, k",
    "comprehension_over_held_values": P + "RETURN [x IN [a.xs, a.name, "
                                          "{k: 1}] | size(x)] AS v",
    "held_lists_plus_values": P + "RETURN (CASE WHEN a.age > 30 THEN a.xs "
        "ELSE 1 END) + 1 AS v, a.xs + 1 AS w, 1 + a.xs AS x, "
        "a.xs + 'x' AS y",
    "held_lists_ordered": P + "RETURN (CASE WHEN a.age > 30 THEN a.xs "
                              "ELSE 1 END) < [3] AS v",
    "group_by_lists_or_strings": P + f"RETURN {LIST_OR_NAME} AS v, "
                                     f"count(*) AS c ORDER BY v DESC",
    "min_max_of_held_values": G + "RETURN min(CASE WHEN g > 30 THEN [g % 4] "
        "ELSE 'x' END) AS mn, max(CASE WHEN g > 30 THEN {k: g % 4} "
        "ELSE g END) AS mx",
    "in_lists_of_held_values": P + "RETURN a.xs IN [a.xs, 1] AS v, "
        "{k: a.age} IN [{k: 42}, 'x'] AS w",
    "truth_of_held_values": P + f"RETURN NOT ({LIST_OR_NAME}) AS v",
    "grouped_collect_of_held_maps": LIVES + "RETURN c.name AS c, "
        "collect(CASE WHEN a.age > 30 THEN {n: a.name} ELSE a.age END) AS v",
    "to_string_of_lists_of_any_kind": P + "RETURN toString([a.xs, "
        "{k: a.age}, date('2020-01-01'), null, 1.5, 'x', true]) AS v, "
        "toString({z: 1, a: a.age}) AS w, toString([[a.age], []]) AS x, "
        f"toString({LIST_OR_NAME}) AS y",
    "reduce_to_lists_and_maps": P + "RETURN reduce(s = 0, x IN a.xs | "
        "CASE WHEN x > 0 THEN [x] ELSE {k: x} END) AS v",
    "concat_of_lists_of_maps": P + "RETURN [{k: a.age}] + [{j: a.name}] "
                                   "AS v, [{k: 1}] + [[a.age], 'x'] AS w",
    "constant_held_values": "RETURN [[1], 'a', {k: [2]}] AS v",
    "in_held_values": P + f"RETURN 1 IN ({LIST_OR_NAME}) AS v, "
        f"'k' IN {{k: a.age}} AS w, 'p' IN ({LIST_OR_NAME}) AS x",
    "entries_of_maps_and_dates": P + "RETURN (CASE WHEN a.age > 30 THEN "
        "{k: a.age} WHEN a.age > 20 THEN date('2020-01-01') ELSE a.name "
        "END).k AS v, (CASE WHEN a.age > 30 THEN {year: a.age} "
        "ELSE date('2020-01-01') END).year AS y",
    "list_functions_of_held_values": P + f"RETURN head({LIST_OR_NAME}) AS h, "
        f"last({LIST_OR_NAME}) AS l, tail({LIST_OR_NAME}) AS t, "
        f"reverse({LIST_OR_NAME}) AS r",
    "held_values_plus_strings": P + f"RETURN ({LIST_OR_NAME}) + 'x' AS v, "
        "(CASE WHEN a.age > 30 THEN {k: 1} ELSE a.name END) + 'y' AS w",
}


@pytest.fixture(scope="module")
def engines():
    nodes, rels = arrays()
    port = port_make_graph(caps_tpu_torch.local_session(device="cpu"),
                           nodes, rels)
    ref = make_graph(caps_tpu.local_session(backend="tpu"), nodes, rels)
    own = port_make_graph(caps_tpu_torch.local_session(backend="local"),
                          nodes, rels)
    return port, ref, own


@pytest.mark.parametrize("name", list(CASES))
def test_answers_as_the_reference(engines, name):
    query = CASES[name]
    ordered = "ORDER BY" in query
    port, ref, own = (rows_of(g, query, ordered) for g in engines)
    for what, other in (("JAX package", ref), ("port oracle", own)):
        assert len(port) == len(other) and all(
            close(a, b) for a, b in zip(port, other)), \
            f"{what} differs on {query!r}:\n{port[:5]}\n{other[:5]}"


@pytest.mark.parametrize("name", ["map_in_a_list_literal",
                                  "collect_lists_or_strings",
                                  "order_by_lists_or_strings",
                                  "to_string_of_nested_maps",
                                  "union_of_maps_and_ints",
                                  "unwind_held_lists"])
def test_an_exact_replay_reads_no_size(engines, name):
    """A recorded query of the new paths replays with 0 size reads and
    the recorded rows; a query that builds strings reads as many held
    values as the recorded run."""
    port = engines[0]
    query = CASES[name]
    first = port.cypher(query)
    again = port.cypher(query)
    assert port._session.fused.last_mode == "replay"
    assert again.metrics["size_syncs"] == 0
    assert again.records.to_maps() == first.records.to_maps()
    assert again.metrics["held_reads"] == first.metrics["held_reads"]


def test_a_held_list_stays_in_its_child_on_a_filter():
    """An "any" value holding a list or a map keeps it as a row of the
    column's side column: a filter gathers the outer rows and leaves
    the held lists and maps where they are (the same column objects)."""
    s = caps_tpu_torch.local_session(device="cpu")
    values = [[1, 2], "a", None, {"k": [3]}, [[4]], 5.5, {"k": None}]
    table = s.table_factory.from_columns({"x": values}, {"x": CTAny})
    col = table._cols["x"]
    assert col.kind == "any" and col.child.capacity == 2
    assert col.maps.capacity == 2
    header = RecordHeader([(E.Var("x"), "x", CTAny)])
    kept = table.filter(E.IsNotNull(E.Var("x")), header, {})
    out = kept._cols["x"]
    assert out.child is col.child and out.maps is col.maps
    assert kept.column_values("x") == [v for v in values if v is not None]


KEY_ORDERS = {
    "case_of_two_orders": P + "RETURN toString(CASE WHEN a.age > 30 THEN "
        "{b: 1, a: 2} ELSE {a: 3, b: 4} END) AS t",
    "held_maps_of_two_orders": P + "RETURN toString(CASE WHEN a.age > 40 "
        "THEN {b: a.age, a: 2} WHEN a.age > 20 THEN {a: 3, c: [1], b: 4} "
        "ELSE 1 END) AS t",
    "union_of_two_orders": P + "RETURN {b: a.age, a: 1} AS v UNION ALL "
        "MATCH (a:Person) RETURN {a: 2, b: a.age} AS v",
    "list_literal_of_two_orders": P + "UNWIND [{b: a.age, a: 2}, "
        "{a: 3, b: a.age}] AS m RETURN toString(m) AS t, m AS v",
    "slices_of_two_orders": P + "RETURN toString([{b: a.age, a: 1}, "
        "{a: 2, b: 3}][1..]) AS s, toString(reverse([{b: a.age, a: 1}, "
        "{a: 2, b: 3}])) AS r",
    "collect_of_two_orders": LIVES + "RETURN c.name AS c, "
        "toString(collect(CASE WHEN a.age > 30 THEN {b: a.age, a: 1} "
        "ELSE {a: 2, b: 0} END)) AS t",
    "unwind_keys_of_two_orders": P + "UNWIND CASE WHEN a.age > 30 THEN "
        "{b: 1, a: 2} ELSE {a: 3, b: 4} END AS k WITH a, collect(k) AS ks "
        "RETURN a.name AS n, ks",
}


def _in_key_order(graph, query):
    """The rows as text, each map's keys in its own order."""
    return sorted(repr([m[c] for c in sorted(m)])
                  for m in graph.cypher(query).records.to_maps())


@pytest.mark.parametrize("name", list(KEY_ORDERS))
def test_maps_keep_each_rows_key_order(engines, name):
    """A column of maps whose rows hold their keys in orders of their
    own (a CASE, a UNION, a list literal or collect of differently
    ordered maps) prints and iterates each row's keys in its own order,
    as the reference's dicts do."""
    query = KEY_ORDERS[name]
    port, ref, own = (_in_key_order(g, query) for g in engines)
    assert port == ref, f"JAX package differs on {query!r}"
    assert port == own, f"port oracle differs on {query!r}"


def test_ingested_maps_keep_their_key_order():
    """Host dicts of several key orders, ingested as maps or among "any"
    values, come back in their own orders."""
    s = caps_tpu_torch.local_session(device="cpu")
    maps = [{"b": 1, "a": 2}, {"a": 3, "b": 4}, None, {"c": 5, "a": 6}]
    mixed = [{"b": 1, "a": 2}, "x", {"a": 3, "b": [4]}, 7]
    table = s.table_factory.from_columns({"m": maps, "x": mixed},
                                         {"m": CTMap, "x": CTAny})
    assert [None if v is None else list(v.items())
            for v in table.column_values("m")] == \
        [None if v is None else list(v.items()) for v in maps]
    assert [list(v.items()) if isinstance(v, dict) else v
            for v in table.column_values("x")] == \
        [list(v.items()) if isinstance(v, dict) else v for v in mixed]


def test_to_string_reads_its_held_values_once():
    """toString of values nested at any depth reads the distinct values
    to the host in one counted transfer each, and an exact replay reads
    as many and no size."""
    s = caps_tpu_torch.local_session(device="cpu")
    nodes, rels = arrays()
    g = port_make_graph(s, nodes, rels)
    for query, reads in ((CASES["to_string_of_nested_maps"], 1),
                         (KEY_ORDERS["held_maps_of_two_orders"], 1),
                         (CASES["to_string_of_lists_of_any_kind"], 4)):
        first = g.cypher(query)
        assert first.metrics["held_reads"] == reads, query
        again = g.cypher(query)
        assert again.metrics["held_reads"] == reads
        assert again.metrics["size_syncs"] == 0


def test_a_cause_both_packages_refuse_raises_naming_it(engines):
    """``duration({days: a.age})`` of a null age raises in both JAX
    backends (a TypeError), so ``toString`` of a list of such durations
    does; the port raises its row error naming the cause.  Over the rows
    whose age is set, the three answer alike."""
    port, ref, own = engines
    q = P + "RETURN toString([duration({days: a.age})]) AS v"
    for g in (ref, own):
        with pytest.raises(TypeError):
            g.cypher(q).records.to_maps()
    with pytest.raises(ExprEvalError, match="duration"):
        port.cypher(q).records.to_maps()
    q = P + "WHERE a.age IS NOT NULL " + q[len(P):]
    port_rows, ref_rows, own_rows = (rows_of(g, q, False) for g in engines)
    assert port_rows == ref_rows == own_rows
