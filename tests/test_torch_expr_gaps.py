"""Expressions and aggregations the JAX package answers through its host
fallback (``caps_tpu/backends/tpu/table.py _fallback``), answered on the
port's device backend.

Each case runs on three engines over the seeded graph of
``tests/test_torch_lists.py arrays()`` (40 ``:Person {name, age, score,
xs, big}``, 20 ``:City {name, pop}``, ``:KNOWS`` and ``:LIVES``, with
null properties), and the three must answer the same bag of rows (the
ordered list, for an ORDER BY):

* the port's ``local_session(device="cpu")``, whose device backend runs
  the same torch code as on the card;
* the JAX package's ``local_session(backend="tpu")`` on the CPU;
* the port's own oracle, ``local_session(backend="local")``.

Values compare exactly, floats to 1e-12 relative (no transcendental
function is in play); maps compare as dicts and temporal values by
their text.  Each case names the census row (ROADMAP Queue 1) it holds:
string functions and predicates with column arguments and ``range()``
with column bounds (A), aggregations of lists, maps, durations and
strings (B), maps (C), mixed-type values and lists compared element by
element (D), lists of durations and lists of lists (E), and the causes
the census found beyond those, among them lists and maps among values
of other types.
"""
import math

import pytest

import caps_tpu
import caps_tpu_torch
from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice
from test_torch_algo import port_make_graph
from test_torch_lists import arrays
from util import make_graph

P = "MATCH (a:Person) "
Q = "MATCH (a:Person) WHERE a.age IS NOT NULL "
KNOWS = "MATCH (a:Person)-[:KNOWS]->(b:Person) "
KNOWS_R = "MATCH (a:Person)-[r:KNOWS]->(b:Person) "
LIVES = "MATCH (a:Person)-[:LIVES]->(c:City) "
G = "MATCH (a:Person) WITH coalesce(a.age, 0) AS g "

CASES = {
    # A: strings and range() with column arguments
    "substring_column_start": P + "RETURN substring(a.name, a.age % 3) AS v",
    "substring_column_length": P + (
        "RETURN substring(a.name, 1, a.age % 3) AS v"),
    "substring_null_length": P + "RETURN substring(a.name, 1, null) AS v, "
                                 "substring(a.name, a.age, null) AS w",
    "left_right_column": P + "RETURN left(a.name, a.age % 3) AS l, "
                             "right(a.name, a.age % 4) AS r",
    "split_column": P + "RETURN split(a.name, a.name) AS v, "
                        "split(a.name, right(a.name, 1)) AS w",
    "replace_column": P + "RETURN replace(a.name, 'p', a.name) AS v",
    "starts_with_column": KNOWS + "WHERE a.name STARTS WITH left(b.name, 2) "
                                  "RETURN count(*) AS v",
    "string_predicates_column": P + "RETURN a.name ENDS WITH a.name AS e, "
        "a.name CONTAINS right(a.name, 1) AS c, "
        "a.name =~ left(a.name, 1) + '.*' AS r",
    "string_predicate_not_a_string": P + "RETURN a.age STARTS WITH 'x' AS v, "
                                         "a.name STARTS WITH a.age AS w",
    "range_column_bounds": Q + "RETURN range(0, a.age % 5) AS v, "
                               "size(range(a.age, 0, -7)) AS w",
    "range_column_step": Q + "RETURN range(a.age % 3, 5, a.age % 4 + 1) AS v",
    "unwind_range_column": Q + "UNWIND range(0, a.age % 4) AS x "
                               "RETURN x, count(*) AS c",
    # B: aggregations
    "collect_maps": P + "RETURN collect({k: a.age}) AS v",
    "collect_lists": P + "RETURN collect(a.xs) AS v",
    "collect_durations": Q + "RETURN collect(duration({days: a.age})) AS v",
    "collect_distinct_lists": P + "RETURN collect(DISTINCT a.xs) AS v",
    "min_max_lists": P + "RETURN min(a.xs) AS v, max(a.xs) AS w",
    "percentile_disc_strings": P + "RETURN percentileDisc(a.name, 0.5) AS v",
    "percentile_disc_lists": P + "RETURN percentileDisc(a.xs, 0.5) AS v",
    "grouped_aggregations": LIVES + "RETURN c.name AS c, "
        "collect({n: a.name, s: a.score}) AS v, collect(a.xs) AS x, "
        "min(a.xs) AS mn, max({k: a.age}) AS mx, min({k: a.age}) AS mi, "
        "percentileDisc(a.name, 0.3) AS p",
    "grouped_durations": Q + "RETURN a.age % 3 AS g, "
        "collect(duration({days: a.age})) AS v, "
        "min(duration({days: a.age})) AS m",
    # C: maps
    "case_between_maps": P + "RETURN CASE WHEN a.age > 30 THEN {k: 1} "
                             "ELSE {k: a.name} END AS v",
    "case_between_map_keys": P + "RETURN CASE WHEN a.age > 30 THEN "
        "{k: 1, j: [1, 2]} WHEN a.age > 20 THEN {z: a.name} END AS v",
    "coalesce_maps": P + "RETURN coalesce({k: a.age}, {j: 1}) AS v",
    "union_of_maps": P + "RETURN {k: a.age} AS v UNION "
                         "MATCH (c:City) RETURN {k: c.pop} AS v",
    "union_of_map_keys": P + "RETURN {k: a.age, n: a.name} AS v UNION ALL "
                             "MATCH (c:City) RETURN {k: c.name, z: [1]} AS v",
    "union_of_lists_of_maps": P + "RETURN [{k: a.age}] AS v UNION ALL "
        "MATCH (c:City) RETURN [{j: c.pop}, null] AS v",
    "slice_of_maps": P + "RETURN [{k: a.age}, {k: 1}][0..1] AS v, "
                         "[{k: a.age}, {j: 1}][1..] AS w",
    "date_of_map": "WITH {year: 2000, month: 1, day: 1} AS m "
                   "RETURN date(m) AS v",
    "temporal_of_map_column": Q + "WITH {year: 1950 + a.age, "
        "month: a.age % 12 + 1} AS m RETURN date(m) AS d, datetime(m) AS t",
    "duration_of_map_column": Q + "WITH CASE WHEN a.age > 30 THEN "
        "{days: a.age} ELSE {months: 2, hours: a.age} END AS m "
        "RETURN duration(m) AS d",
    "order_by_map_desc": P + "RETURN {k: a.age} AS m ORDER BY m DESC",
    # D: mixed values
    "case_string_or_int": P + "RETURN CASE WHEN a.age > 30 THEN 'x' "
                              "ELSE 2 END AS v",
    "any_plus_int": P + "RETURN (CASE WHEN a.age > 30 THEN 'x' ELSE 2 END) "
                        "+ 1 AS v",
    "any_arithmetic": P + "RETURN (CASE WHEN a.age > 30 THEN a.score "
        "ELSE a.name END) + a.age AS v, "
        "1 + (CASE WHEN a.age > 40 THEN true ELSE a.age END) AS w",
    "any_with_date": P + "RETURN (CASE WHEN a.age > 30 THEN "
                         "date('2020-01-01') ELSE a.age END) + 1 AS v",
    "mixed_lists_equal": P + "RETURN [a.age, a.name] = [1, 'x'] AS v, "
        "[a.age, null] = [a.age, null] AS n, "
        "[a.name, 1] <> [a.name, 1.0] AS w",
    "in_list_of_lists": P + "RETURN [a.age] IN [[1], [2], "
                            "[a.age % 5 + 16]] AS v",
    "in_mixed_lists_and_maps": P + "RETURN a.age IN [a.name, 42, null] AS v, "
                                   "{k: a.age} IN [{k: 42}, {k: 21}] AS w",
    "case_lists_of_kinds": P + "RETURN CASE WHEN a.age > 30 THEN [1] "
                               "ELSE ['x', a.name] END AS v",
    # E: lists
    "list_of_durations": Q + "RETURN [duration({days: a.age}), null, "
                             "duration({months: 1})] AS v",
    "unwind_durations": Q + "UNWIND [duration({days: a.age}), "
                            "duration({months: a.age})] AS d RETURN d",
    "filter_durations": Q + "RETURN [x IN [duration({days: a.age}), "
        "duration({months: 1})] WHERE x.days > 20] AS v",
    "duration_list_functions": "WITH [duration({days: 2}), "
        "duration({hours: 5})] AS l RETURN l, size(l) AS s, l[1] AS e, "
        "reverse(l) AS r, tail(l) AS t",
    "lists_of_lists_equal": P + "RETURN [[a.age]] = [[1]] AS v, "
        "[[a.age, 1]] = [[a.age, 1]] AS w, [{k: a.age}] = [{k: 42}] AS x",
    "durations_equal": Q + "RETURN [duration({days: a.age})] = "
        "[duration({days: 42})] AS v, "
        "duration({days: a.age}) IN [duration({days: 42})] AS w",
    "order_by_lists_of_lists": P + "RETURN a.name AS n ORDER BY [[a.age]], n",
    "order_by_nested_desc": P + "RETURN [[a.age], a.xs] AS v ORDER BY v DESC",
    "distinct_lists_of_lists": P + "RETURN DISTINCT [[a.age % 3]] AS v",
    "group_by_lists_of_maps": P + "RETURN [{k: a.age % 4}] AS v, "
                                  "count(*) AS c",
    "order_by_lists_of_durations": Q + "RETURN [duration({days: a.age % 5})] "
                                       "AS v, count(*) AS c ORDER BY v",
    "union_of_lists": P + "RETURN a.xs AS v UNION ALL "
                          "MATCH (c:City) RETURN [c.name] AS v",
    "union_of_lists_of_lists": P + "RETURN [[a.age]] AS v UNION ALL "
        "MATCH (c:City) RETURN [[c.pop, 1], [null]] AS v",
    "case_lists_of_lists": P + "RETURN CASE WHEN a.age > 30 THEN [[1]] "
                               "ELSE [[a.age, 2], []] END AS v",
    "slice_of_lists_of_lists": P + "RETURN [[a.age], [1, 2]][-1..] AS v",
    "lists_of_lists_of_mixed_values": "RETURN [[1, 'a']] AS v",
    "three_levels": P + "RETURN [[[a.age]]] AS v",
    "collect_of_lists_of_lists": P + "RETURN collect([[a.age]]) AS v",
    # beyond the groups: further causes the census found
    "index_of_a_string": P + "RETURN a.name[0] AS v, a.xs[1.5] AS w",
    "head_last_of_a_string": P + "RETURN head(a.name) AS h, last(a.name) AS l",
    "concat_lists_of_kinds": P + "RETURN a.xs + [a.name] AS v",
    "to_integer_beyond_int64": P + "RETURN toInteger(a.name + "
                                   "'99999999999999999999') AS v",
    "where_not_a_boolean": P + "WHERE a.name RETURN count(*) AS v",
    "comprehension_not_a_boolean": P + "RETURN [x IN a.xs WHERE x | x] AS v",
    "order_a_list_and_a_string": P + "RETURN a.xs < a.name AS v",
    "order_booleans": P + "RETURN (a.age > 30) < true AS v",
    "in_a_string": P + "RETURN null IN a.name AS n, a.age IN a.name AS v, "
                       "left(a.name, 1) IN a.name AS w",
    "in_list_of_other_kinds": P + "RETURN a.xs IN [1, 2] AS v, "
                                  "a.name IN a.xs AS w",
    "conversions_of_other_kinds": P + "RETURN toInteger(a.age > 30) AS i, "
        "toFloat(a.age > 30) AS f, toBoolean(a.age) AS b",
    "reduce_list_accumulator": P + "RETURN reduce(s = [], x IN a.xs | "
                                   "s + [x]) AS v",
    "reduce_changes_kind": P + "RETURN reduce(s = 0, x IN a.xs | "
                               "toString(x)) AS v",
    # D: durations among values of other types
    "duration_among_other_values": P + "RETURN CASE WHEN a.age > 30 THEN "
        "duration({days: 1}) ELSE 1 END AS v",
    "durations_among_dates": "WITH [date('2020-01-01'), "
        "duration({days: 1})] AS l RETURN l AS v",
    "lists_of_durations_or_values": P + "RETURN CASE WHEN a.age > 30 THEN "
        "[duration({days: coalesce(a.age, 0)})] ELSE [1] END AS v",
    "collect_durations_among_values": P + "RETURN collect(CASE WHEN "
        "a.age > 30 THEN duration({days: coalesce(a.age, 0)}) "
        "ELSE a.name END) AS v",
    "group_durations_among_values": G + "RETURN CASE WHEN g > 30 THEN "
        "duration({days: g % 3}) ELSE g % 2 END AS v, count(*) AS c "
        "ORDER BY v",
    "distinct_durations_among_values": G + "RETURN DISTINCT CASE WHEN "
        "g > 30 THEN duration({days: g % 3}) ELSE 'x' END AS v",
    "durations_among_values_compared": P + "RETURN toString(CASE WHEN "
        "a.age > 30 THEN duration({days: 1}) ELSE 1 END) AS t, (CASE WHEN "
        "a.age > 30 THEN duration({days: 1}) ELSE 1 END) = "
        "duration({days: 1}) AS e, (CASE WHEN a.age > 30 THEN "
        "duration({days: 2}) ELSE 1 END).days AS d, (CASE WHEN a.age > 30 "
        "THEN duration({days: 1}) ELSE 1 END) < 3 AS l",
    "arithmetic_on_durations_among_values": G + "RETURN (CASE WHEN g > 30 "
        "THEN duration({days: 1}) ELSE 1 END) + 1 AS n, (CASE WHEN g > 30 "
        "THEN duration({days: g}) ELSE date('2020-01-01') END) + "
        "duration({months: 1}) AS t, date('2020-01-01') - (CASE WHEN g > 40 "
        "THEN duration({days: g}) ELSE 'x' END) AS d",
    "union_of_durations_and_ints": Q + "RETURN duration({days: a.age}) AS v "
        "UNION ALL MATCH (c:City) RETURN c.pop AS v",
    "durations_among_values_in_lists": G + "RETURN [duration({days: 1})] + "
        "[g] AS v, min(CASE WHEN g > 30 THEN duration({days: g}) ELSE 5 END) "
        "AS m, max(CASE WHEN g > 30 THEN duration({days: g}) ELSE 5 END) "
        "AS x, [x IN [duration({days: g}), g, 'a'] | x] AS c, "
        "[duration({days: g}), g] = [duration({days: 40}), 40] AS e",
    "nodes_and_relationships": KNOWS_R + (
        "RETURN size([x IN [a, r] | 1]) AS s, "
        "[x IN [a, r, b] | x.w] AS w, [x IN [a, r] | labels(x)] AS l, "
        "[x IN [r, a] | type(x)] AS t, "
        "[x IN [a, r] WHERE x.age > 30 | x.name] AS f"),
    "nested_lambdas_over_nodes_and_relationships": KNOWS_R + (
        "RETURN [x IN [a, r] | [y IN [b, r] | y.w]] AS n, "
        "any(x IN [a, r] WHERE x.w > 5) AS q, "
        "reduce(s = 0, x IN [a, r] | s + coalesce(x.w, 1)) AS s"),
    "slice_of_a_string": P + "RETURN a.name[0..1] AS v, a.name[1..] AS w, "
        "a.name[..a.age % 3] AS x, a.name[-2..] AS y",
    "to_string_of_lists": P + "RETURN toString(a.xs) AS v, "
        "toString([a.name, null]) AS w, toString([a.score, 1.5]) AS x, "
        "toString([true, a.age > 30]) AS y",
    "quantifiers_not_a_boolean": P + "RETURN any(x IN a.xs WHERE x) AS a, "
        "all(x IN a.xs WHERE x) AS b, none(x IN a.xs WHERE x) AS c, "
        "single(x IN a.xs WHERE x) AS d",
    "truth_of_values": P + "RETURN NOT a.name AS n, a.name AND true AS a, "
        "a.age OR false AS o, NOT a.xs AS l, a.score XOR true AS x",
    "case_condition_not_a_boolean": P + "RETURN CASE WHEN a.name THEN 1 "
                                        "ELSE 2 END AS v",
    "map_entry_of_a_column_key": P + "RETURN {k: a.age, p00: 1}[a.name] AS v",
    "tail_of_a_string": P + "RETURN tail(a.name) AS v",
    "size_of_a_map": P + "RETURN size({k: a.age}) AS v",
    "conversions_of_mixed_values": P + "RETURN toInteger(CASE WHEN a.age > 30 "
        "THEN '5' ELSE 2.5 END) AS i, toFloat(CASE WHEN a.age > 30 THEN '5' "
        "ELSE 2 END) AS f, toBoolean(CASE WHEN a.age > 30 THEN 'true' "
        "ELSE true END) AS b",
    "duration_of_mixed_values": P + "RETURN duration(CASE WHEN a.age > 200 "
        "THEN 5 ELSE 'P1D' END) AS v",
    "temporal_of_mixed_values": P + "RETURN date(CASE WHEN a.age > 30 THEN "
        "'2020-01-01' ELSE date('2021-01-02') END) AS v, datetime(CASE WHEN "
        "a.age > 30 THEN '2020-01-01T10:00' ELSE date('2021-01-02') END) "
        "AS w",
    # lists and maps among values of other types ("any" values that hold
    # a list or a map by its row), and toString of maps and lists
    "map_among_other_values": P + "RETURN CASE WHEN a.age > 30 THEN {k: 1} "
                                  "ELSE 1 END AS v",
    "list_among_other_values": P + "RETURN [a.xs, 1] AS v",
    "union_of_a_list_and_a_string": P + "RETURN a.xs AS v UNION ALL "
                                        "MATCH (c:City) RETURN c.name AS v",
    "lists_of_two_depths": P + "RETURN CASE WHEN a.age > 30 THEN [[1]] "
                               "ELSE [1] END AS v",
    "concat_of_maps_and_values": P + "RETURN [{k: a.age}] + [1] AS v",
    "to_string_of_a_map": P + "RETURN toString({k: a.age}) AS v",
    "to_string_of_temporal_lists": P + "RETURN toString([date('2020-01-01')]) "
                                       "AS v",
    "reduce_to_a_map": P + "RETURN reduce(s = 0, x IN a.xs | {k: x}) AS v",
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


def norm(v):
    """A value in a form both packages share: maps as sorted items,
    temporal values by their text, entities as (kind, id)."""
    if isinstance(v, dict):
        return ("map", sorted((k, norm(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    if hasattr(v, "id") and hasattr(v, "labels"):
        return ("node", v.id)
    if hasattr(v, "id") and hasattr(v, "rel_type"):
        return ("rel", v.id)
    if hasattr(v, "iso"):
        return (type(v).__name__, v.iso())
    return v


def close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return (isinstance(a, (int, float)) and isinstance(b, (int, float))
                and not isinstance(a, bool) and not isinstance(b, bool)
                and math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def rows_of(graph, query, ordered):
    maps = graph.cypher(query).records.to_maps()
    out = [[norm(m[c]) for c in sorted(m)] for m in maps]
    return out if ordered else sorted(out, key=repr)


@pytest.mark.parametrize("name", list(CASES))
def test_answers_as_the_reference(engines, name):
    query = CASES[name]
    ordered = "ORDER BY" in query
    port, ref, own = (rows_of(g, query, ordered) for g in engines)
    for what, other in (("JAX package", ref), ("port oracle", own)):
        assert len(port) == len(other) and all(
            close(a, b) for a, b in zip(port, other)), \
            f"{what} differs on {query!r}:\n{port[:5]}\n{other[:5]}"


@pytest.mark.parametrize("name", ["substring_column_start",
                                  "starts_with_column", "range_column_bounds",
                                  "collect_maps", "case_between_maps",
                                  "mixed_lists_equal"])
def test_an_exact_replay_reads_no_size(engines, name):
    """A recorded query of the new paths replays with 0 size reads and
    the recorded rows; string-making paths read their held values again
    (``held_reads``), outside the size stream."""
    port = engines[0]
    query = CASES[name]
    first = port.cypher(query)
    again = port.cypher(query)
    assert port._session.fused.last_mode == "replay"
    assert again.metrics["size_syncs"] == 0
    assert again.records.to_maps() == first.records.to_maps()
    assert again.metrics["held_reads"] == first.metrics["held_reads"]


def test_a_cause_both_packages_refuse_raises_naming_it(engines):
    """``sum`` of durations is a TypeError in both JAX backends; the
    port's device backend refuses it naming the cause."""
    port, ref, _own = engines
    q = Q + "RETURN sum(duration({days: a.age})) AS v"
    with pytest.raises(TypeError):
        ref.cypher(q).records.to_maps()
    with pytest.raises(UnsupportedOnDevice, match="sum over kind duration"):
        port.cypher(q).records.to_maps()
