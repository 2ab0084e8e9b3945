"""Values on the port's device backend, held to the JAX package.

Temporal values (dates, datetimes, durations: accessors, arithmetic,
constructors, toString, min / max, lists of them), maps (literals,
``properties``, ``keys``, entries, equality, ordering, lists of maps,
map parameters), mixed-type values (CTNumber and CTAny columns and
lists: equality, ordering, DISTINCT, min / max / sum) and strings built
from columns (``+`` of two string columns, ``toString`` of a column) run
on the port's device backend (``backends/cuda/temporal.py``,
``maps.py``, ``anyvalue.py``; on the CPU, the same torch code).  Each
query runs on three engines over the same seeded graph and must answer
the same bag of rows (the ordered list, for an ORDER BY):

* the port's ``local_session(device="cpu")``;
* the JAX package's ``TPUCypherSession`` on the CPU, whose host
  fallback gives the reference's answers;
* the port's own oracle, ``local_session(backend="local")``.

Ints, strings, booleans, dates, datetimes, durations and maps compare
exactly (an int never equals a float here), floats to 1e-12 relative.
The graph (numpy ``RandomState(14)``): 40 ``:Person {name, age, city,
score, born, joined}`` with some null properties and ids both large and
negative, 12 ``:Thing {v}`` whose ``v`` mixes ints, floats, booleans and
strings, 200 ``:KNOWS {since, w}`` edges.  The calendar itself is held
to ``okapi/values.py`` by hypothesis over years 1–9999.
"""
import math

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import caps_tpu
import caps_tpu_torch
from caps_tpu.okapi import values as JV
from caps_tpu.testing.factory import create_graph as jax_create
from caps_tpu_torch.backends.cuda import temporal as T
from caps_tpu_torch.backends.cuda.column import Column
from caps_tpu_torch.okapi import values as PV
from caps_tpu_torch.okapi.types import CTDate, CTDateTime
from caps_tpu_torch.testing.factory import create_graph as port_create
from test_torch_algo import port_make_graph
from util import make_graph

US_PER_DAY = 86_400_000_000
# epoch days of 1940-01-01 and 2005-12-31
DAY_LO, DAY_HI = -10_957, 13_148


def arrays(values):
    """The seeded graph with temporal values of the package ``values``
    (``caps_tpu.okapi.values`` or the port's copy)."""
    rng = np.random.RandomState(14)
    pool = np.concatenate([np.arange(-2_000_000_000, -1_999_999_000, 37),
                           np.arange(-50, 50),
                           np.arange(2_000_000_000, 2_000_001_000, 41)])
    ids = [int(i) for i in rng.choice(pool, size=52, replace=False)]
    people, things = ids[:40], ids[40:]

    def maybe(v, p=0.15):
        return None if rng.rand() < p else v

    person = []
    for i, nid in enumerate(people):
        days = int(rng.randint(DAY_LO, DAY_HI))
        us = int(rng.randint(946_684_800, 1_735_689_600)) * 1_000_000 \
            + int(rng.randint(0, 1_000_000)) * (i % 3 == 0)
        person.append({
            "_id": nid, "name": f"p{i:02d}",
            "age": maybe(int(rng.randint(16, 70))),
            "city": maybe(f"c{rng.randint(0, 5)}"),
            "score": maybe(float(np.round(rng.uniform(-5, 5), 3))),
            "born": maybe(values.CypherDate(days)),
            "joined": values.CypherDateTime(us)})
    mixed = [1, 1.0, True, "a", 2.5, None, 3, "b", False, 0, -7, 2.5]
    thing = [{"_id": nid, "i": i, "v": v}
             for i, (nid, v) in enumerate(zip(things, mixed))]
    knows = [(people[a], people[b], {
        "since": maybe(values.CypherDateTime(
            int(rng.randint(1_262_304_000, 1_735_689_600)) * 1_000_000)),
        "w": int(rng.randint(1, 10))})
        for a, b in rng.randint(0, 40, size=(200, 2)) if a != b]
    return ({("Person",): person, ("Thing",): thing}, {"KNOWS": knows})


@pytest.fixture(scope="module")
def engines():
    nodes, rels = arrays(PV)
    port = port_make_graph(caps_tpu_torch.local_session(device="cpu"),
                           nodes, rels)
    jnodes, jrels = arrays(JV)
    ref = make_graph(caps_tpu.local_session(backend="tpu"), jnodes, jrels)
    own = port_make_graph(caps_tpu_torch.local_session(backend="local"),
                          nodes, rels)
    return port, ref, own


def norm(v):
    """A value in a form both packages share: entities as (kind, id),
    temporal values as tagged tuples, maps as sorted item lists."""
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    if isinstance(v, dict):
        return ("map", [(k, norm(x)) for k, x in sorted(v.items())])
    name = type(v).__name__
    if name == "CypherDate":
        return ("date", v.days)
    if name == "CypherDateTime":
        return ("datetime", v.micros)
    if name == "CypherDuration":
        return ("duration", v.months, v.days, v.seconds)
    if hasattr(v, "id") and hasattr(v, "labels"):
        return ("node", v.id)
    if hasattr(v, "id") and hasattr(v, "rel_type"):
        return ("rel", v.id)
    return v


def close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return (isinstance(a, float) and isinstance(b, float)
                and (math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)
                     or (math.isnan(a) and math.isnan(b))))
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


def held_reads(engines):
    return engines[0]._session.backend.held_reads


# -- temporal values -----------------------------------------------------------

TEMPORAL = {
    "accessors": "MATCH (p:Person) RETURN p.name AS n, p.born AS b, "
                 "p.born.year AS y, p.born.month AS m, p.born.day AS d, "
                 "p.joined.hour AS h, p.joined.minute AS mi, "
                 "p.joined.second AS s, p.born.hour AS none, "
                 "p.joined.day AS jd",
    "date_plus_duration": "MATCH (p:Person) RETURN p.name AS n, "
                          "p.born + duration({months: 1}) AS a, "
                          "p.born - duration('P1Y2M3DT25H') AS b, "
                          "p.born + duration({days: coalesce(p.age, 1)}) AS c",
    "datetime_plus_duration": "MATCH (p:Person) RETURN p.name AS n, "
                              "p.joined + duration({hours: coalesce(p.age, 2), "
                              "minutes: 7}) AS a, "
                              "p.joined - duration('P1M') AS b, "
                              "duration({months: 13}) + p.joined AS c",
    "duration_arithmetic": "MATCH (p:Person) RETURN p.name AS n, "
                           "duration({days: coalesce(p.age, 3), seconds: 30}) "
                           "+ duration('PT1H') AS a, "
                           "duration({years: coalesce(p.age, 4)}) AS b, "
                           "duration({weeks: 2}) - duration({days: coalesce(p.age, 1)}) "
                           "AS c",
    "duration_components": "MATCH (p:Person) WITH p, "
                           "duration({years: 1, months: coalesce(p.age, 6), "
                           "seconds: -3700}) AS d RETURN p.name AS n, "
                           "d.months AS mo, d.years AS y, d.seconds AS s, "
                           "d.hours AS h, d.minutes AS mi, d.days AS dd",
    "truncation": "MATCH (p:Person) RETURN p.name AS n, date(p.joined) AS d, "
                  "datetime(p.born) AS t, date(p.born) AS same",
    "from_components": "MATCH (p:Person) WHERE p.age IS NOT NULL "
                       "RETURN p.name AS n, date({year: 1950 + p.age, "
                       "month: 1 + p.age % 12, day: 1 + p.age % 28}) AS d, "
                       "datetime({year: 2000, month: 2, day: 29, "
                       "hour: p.age % 24, minute: 5}) AS t",
    "comparison": "MATCH (p:Person) WHERE p.born < date('1980-06-15') "
                  "AND p.joined >= datetime($t) RETURN p.name AS n",
    "equality": "MATCH (p:Person) RETURN p.name AS n, "
                "p.born = date(p.joined) AS a, p.born = p.joined AS b, "
                "p.born < p.joined AS c, "
                "duration({days: coalesce(p.age, 1)}) = duration({days: coalesce(p.age, 1)}) AS d, "
                "duration({days: 1}) < duration({days: 2}) AS e",
    "grouping": "MATCH (p:Person) RETURN p.city AS c, min(p.born) AS a, "
                "max(p.born) AS b, min(p.joined) AS f, max(p.joined) AS l, "
                "count(DISTINCT p.born.year) AS y",
    "group_by_date": "MATCH (a:Person)-[k:KNOWS]->(b:Person) "
                     "RETURN b.born AS b, count(*) AS n, "
                     "max(k.since) AS last",
    "to_string": "MATCH (p:Person) RETURN p.name AS n, toString(p.born) AS b, "
                 "toString(p.joined) AS j, toString(p.age) AS a, "
                 "toString(p.score) AS s, "
                 "toString(duration({days: coalesce(p.age, 5), seconds: -61})) AS d",
    "collect_dates": "MATCH (a:Person)-[:KNOWS]->(b:Person) "
                     "WITH a, collect(b.born) AS bs RETURN a.name AS n, "
                     "[d IN bs WHERE d.year > 1975 | toString(d)] AS r, "
                     "size(bs) AS s",
    "date_list_literal": "MATCH (p:Person) RETURN p.name AS n, "
                         "[d IN [p.born, date('2000-02-29')] | d.month] AS m, "
                         "[p.joined, datetime('2001-01-01T00:00:00')] AS t",
    "unwind_dates": "MATCH (p:Person) UNWIND [p.born, date(p.joined)] AS d "
                    "RETURN d, count(*) AS n",
    "null_propagation": "MATCH (p:Person) RETURN p.name AS n, "
                        "date(p.missing) AS a, p.born + null AS b, "
                        "p.missing + duration({days: 1}) AS c",
    "order_by_temporal": "MATCH (p:Person) RETURN p.name AS n, "
                         "duration({days: coalesce(p.age, 1)}) AS d "
                         "ORDER BY p.born DESC, p.joined, d",
    "case_and_coalesce": "MATCH (p:Person) RETURN p.name AS n, "
                         "CASE WHEN p.age > 30 THEN p.born "
                         "ELSE date('2000-01-01') END AS c, "
                         "coalesce(p.born, date(p.joined)) AS f",
    "equal_dates": "MATCH (a:Person), (b:Person) WITH a, b, "
                   "date({year: 2000, month: coalesce(a.born.month, 1)}) "
                   "AS x, date({year: 2000, month: coalesce(b.born.month, "
                   "1)}) AS y WHERE x = y AND a.name < b.name "
                   "RETURN a.name AS a, b.name AS b, x",
    "in_collected_dates": "MATCH (a:Person)-[:KNOWS]->(b:Person) "
                          "WITH a, collect(b.born) AS bs "
                          "RETURN a.name AS n, a.born IN bs AS i",
    "string_column_dates": "UNWIND ['2020-02-29', '1969-07-20', null] AS s "
                           "RETURN date(s) AS d, datetime(s + 'T01:02:03') "
                           "AS t",
}


@pytest.mark.parametrize("query", list(TEMPORAL.values()),
                         ids=list(TEMPORAL))
def test_temporal(engines, query):
    assert assert_same(engines, query, {"t": "2005-03-01T12:00:00"},
                       ordered="ORDER BY" in query)


@pytest.mark.parametrize("query", [
    "MATCH (p:Person) RETURN date('2020-13-01') AS d",
    "MATCH (p:Person) RETURN date() AS d",
    "MATCH (p:Person) RETURN p.born + duration({years: 9000}) AS d",
    "MATCH (p:Person) WHERE p.age IS NOT NULL "
    "RETURN date({year: 2021, month: 2, day: 28 + p.age}) AS d",
    "MATCH (p:Person) RETURN date({month: p.age}) AS d",
    "MATCH (p:Person) RETURN -duration({days: 1}) AS d",
    "MATCH (p:Person) RETURN keys({b: p.age, a: 1}) AS k",
    "UNWIND ['2020-01-01', 'no date'] AS s RETURN date(s) AS d",
], ids=["malformed_literal", "no_argument", "out_of_range", "bad_day",
        "no_year", "malformed_string", "negated_duration",
    "keys_of_a_map_literal"])
def test_temporal_errors(engines, query):
    """A malformed value raises on all three engines."""
    for g in engines:
        with pytest.raises(Exception):
            g.cypher(query, {}).records.to_maps()


def test_no_argument_names_the_reference_message(engines):
    with pytest.raises(Exception, match="non-deterministic"):
        engines[0].cypher("MATCH (p:Person) RETURN date() AS d",
                          {}).records.to_maps()


# -- maps ------------------------------------------------------------------------

MAPS = {
    "literal": "MATCH (p:Person) RETURN {n: p.name, a: p.age, "
               "b: p.born, z: null} AS m",
    "nested_access": "MATCH (p:Person) WITH {a: p.age, b: {c: p.city}} AS m "
                     "RETURN m.a AS a, m.b.c AS c, m.x AS x, m['a'] AS i",
    "properties": "MATCH (p:Person) RETURN properties(p) AS p, keys(p) AS k",
    "properties_entries": "MATCH (p:Person) WITH properties(p) AS m "
                          "RETURN m.name AS n, m.age AS a, m.born AS b, "
                          "keys(m) AS k",
    "equality": "MATCH (p:Person) RETURN p.name AS n, "
                "{a: p.age} = {a: p.age} AS a, {a: 1} = {a: 1, b: 2} AS b, "
                "{a: p.age, b: 1} = {b: 1, a: 30} AS c, "
                "properties(p) = {name: p.name} AS d",
    "order_by_map": "MATCH (p:Person) RETURN {a: p.age, n: p.name} AS m "
                    "ORDER BY m",
    "order_by_properties": "MATCH (p:Person) RETURN properties(p) AS m "
                           "ORDER BY m DESC",
    "order_by_entry": "MATCH (p:Person) RETURN {c: p.city, n: p.name} AS m "
                      "ORDER BY m.c, m.n",
    "parameter": "MATCH (p:Person) WHERE p.age > $m.lo "
                 "RETURN p.name AS n, $m.tag AS t, $m AS m",
    "list_of_maps": "MATCH (p:Person) RETURN p.name AS n, "
                    "[m IN [{a: p.age}, {a: 2, b: p.name}] | m.a] AS a, "
                    "[m IN [{a: 1}, {b: p.city}] | keys(m)] AS k, "
                    "[m IN [{a: p.age, b: 2}] | properties(m)] AS p",
    "group_by_map": "MATCH (p:Person) RETURN {c: p.city} AS m, "
                    "count(*) AS n, size(keys(p)) AS k",
    "properties_in_lambda": "MATCH (a:Person)-[:KNOWS]->(b:Person) "
                            "RETURN a.name AS n, b.name AS m, "
                            "[x IN [a, b] | properties(x).age] AS ages, "
                            "[x IN [b] | keys(x)] AS ks",
}


@pytest.mark.parametrize("query", list(MAPS.values()), ids=list(MAPS))
def test_maps(engines, query):
    assert assert_same(engines, query,
                       {"m": {"lo": 40, "tag": "old", "xs": [1, 2]}},
                       ordered="ORDER BY" in query)


# -- mixed-type values ----------------------------------------------------------

MIXED = {
    "any_property": "MATCH (t:Thing) RETURN t.i AS i, t.v AS v",
    "distinct": "MATCH (t:Thing) RETURN DISTINCT t.v AS v",
    "order_by": "MATCH (t:Thing) RETURN t.i AS i, t.v AS v "
                "ORDER BY v, i",
    "order_by_desc": "MATCH (t:Thing) RETURN t.i AS i, t.v AS v "
                     "ORDER BY v DESC, i",
    "comparisons": "MATCH (t:Thing) RETURN t.i AS i, t.v > 0 AS gt, "
                   "t.v = 1 AS one, t.v <= 'a' AS s, t.v = true AS b, "
                   "t.v <> 2.5 AS ne",
    "where": "MATCH (t:Thing) WHERE t.v >= 1 RETURN t.i AS i",
    "aggregates": "MATCH (t:Thing) WHERE t.i IN [0, 1, 4, 6, 9, 10, 11] "
                  "RETURN min(t.v) AS mn, max(t.v) AS mx, sum(t.v) AS s, "
                  "count(DISTINCT t.v) AS d, avg(t.v) AS a",
    "min_max_all_kinds": "MATCH (t:Thing) RETURN min(t.v) AS mn, "
                         "max(t.v) AS mx, collect(t.v) AS all",
    "number_lists": "MATCH (p:Person) RETURN p.name AS n, "
                    "[p.age, p.score] AS l, [x IN [p.age, p.score] "
                    "WHERE x > 0] AS pos",
    "number_unwind": "MATCH (p:Person) UNWIND [p.age, p.score] AS v "
                     "RETURN p.city AS c, min(v) AS mn, max(v) AS mx, "
                     "sum(v) AS s",
    "any_list_unwind": "MATCH (p:Person) UNWIND [p.age, p.name, p.born, "
                       "p.score] AS v RETURN DISTINCT v ORDER BY v",
    "constant_any_list": "UNWIND ['b', 3, true, 'a', 1.5, null, "
                         "date('2001-01-01')] AS v RETURN v ORDER BY v",
    "int_float_equal": "UNWIND [1, 1.0, 2, 2.0, 2] AS v RETURN DISTINCT v",
    "beyond_2_53": "UNWIND [9007199254740993, 9007199254740992.0, "
                   "9007199254740992] AS v RETURN v, "
                   "v = 9007199254740992.0 AS f ORDER BY v",
    "order_by_any_list": "MATCH (p:Person) RETURN p.name AS n, "
                         "[p.age, p.city] AS l ORDER BY l, n",
    "union": "MATCH (t:Thing) RETURN t.v AS v UNION "
             "MATCH (p:Person) RETURN p.age AS v",
    "group_by_any": "MATCH (t:Thing) RETURN t.v AS v, count(*) AS n",
    "to_string_any": "MATCH (t:Thing) RETURN t.i AS i, toString(t.v) AS s",
}


@pytest.mark.parametrize("query", list(MIXED.values()), ids=list(MIXED))
def test_mixed(engines, query):
    assert assert_same(engines, query, ordered="ORDER BY" in query)


# -- strings built from columns --------------------------------------------------

STRINGS = {
    "pair": "MATCH (a:Person)-[:KNOWS]->(b:Person) "
            "RETURN a.name + '/' + b.name AS p, a.city + b.city AS c",
    "value_text": "MATCH (p:Person) RETURN p.name + p.age AS a, "
                  "p.name + ':' + p.born AS b, p.score + p.name AS c",
    "reduce": "MATCH (a:Person)-[:KNOWS]->(b:Person) WITH a, "
              "collect(b.name) AS ns RETURN a.name AS n, "
              "reduce(s = a.name, x IN ns | s + ',' + x) AS r",
    "grouped_keys": "MATCH (p:Person) RETURN p.city + '-' + p.name AS k, "
                    "count(*) AS n ORDER BY k",
}


@pytest.mark.parametrize("query", list(STRINGS.values()), ids=list(STRINGS))
def test_strings(engines, query):
    assert assert_same(engines, query, ordered="ORDER BY" in query)


def test_built_strings_add_nothing_when_run_again(engines):
    """A string built in a query is encoded once: the second run reads
    the held values again but adds no code to the pool, and an exact
    replay of a query that builds no string reads nothing."""
    port = engines[0]
    pool = port._session.backend.pool
    q = ("MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN a.name + b.city AS p, "
         "toString(b.born) AS d, toString(b.score) AS s")
    first = port.cypher(q, {}).records.to_maps()
    n = len(pool)
    reads = held_reads(engines)
    again = port.cypher(q, {})
    assert again.records.to_maps() == first
    assert len(pool) == n
    assert again.metrics["held_reads"] == held_reads(engines) - reads == 3
    plain = "MATCH (p:Person) RETURN p.born.year AS y, p.joined AS j"
    port.cypher(plain, {}).records.to_maps()
    replay = port.cypher(plain, {})
    replay.records.to_maps()
    assert port._session.fused.last_mode == "replay"
    assert replay.metrics["size_syncs"] == 0
    assert replay.metrics["held_reads"] == 0


# -- the listed scenarios and acceptance tests, in their own form ------------------

# (CREATE text, query): the 26 TCK scenarios and 9 acceptance tests that
# had no device path, each on the three engines
GAP_CASES = {
    # TCK
    "min_mixed": ("", "UNWIND [2, 1.5, 3] AS v RETURN min(v) AS mn"),
    "sum_mixed": ("", "UNWIND [1, 2.5] AS v RETURN sum(v) AS s"),
    "distinct_int_bool": ("CREATE (:P {v: 1}), (:P {v: true}), (:P {v: 1})",
                          "MATCH (p:P) RETURN DISTINCT p.v AS v"),
    "distinct_int_float": ("", "UNWIND [1, 1.0] AS v RETURN DISTINCT v"),
    "keys_properties_node": ("CREATE (:P {b: 2, a: 1})",
                             "MATCH (n:P) RETURN keys(n) AS k, "
                             "properties(n) AS p"),
    "map_values_lookup": ("", "UNWIND [1] AS one "
                              "RETURN [m IN [{a: 1}, {a: 2}] | m.a] AS vs"),
    "reduce_strings": ("", "UNWIND [1] AS one RETURN "
                           "reduce(t = 0, x IN [1, 2, 3] | t + x) AS s, "
                           "reduce(s = '!', x IN ['a', 'b'] | s + x) AS c, "
                           "reduce(t = 0, x IN [] | t + x) AS e"),
    "mixed_chain": ("", "UNWIND [0.5, 1, 1.5, 2] AS v WITH v "
                        "WHERE v >= 1 AND v < 2 RETURN v"),
    "mixed_order": ("", "UNWIND ['b', 3, true, 'a', 1.5] AS v "
                        "RETURN v ORDER BY v"),
    "ints_floats_order": ("", "UNWIND [2.5, 1, 3, 0.5] AS v "
                              "RETURN v ORDER BY v"),
    "cross_type_where": ("CREATE (:P {v: 1}), (:P {v: 'str'})",
                         "MATCH (p:P) WHERE p.v > 0 RETURN p.v AS v"),
    "list_and_map_literal": ("", "RETURN [1, 2, 3] AS l, "
                                 "{a: 1, b: 'two'} AS m"),
    "map_nested_access": ("", "WITH {a: 1, b: {c: 'x'}} AS m "
                              "RETURN m.a AS a, m.b.c AS c"),
    "properties_map": ("CREATE ({name: 'n', age: 3})",
                       "MATCH (n) WITH properties(n) AS p "
                       "RETURN p.name AS name, p.age AS age"),
    "date_accessors": ("", "UNWIND [1] AS one WITH date('2020-03-07') AS d "
                           "RETURN d.year AS y, d.month AS m, d.day AS dd"),
    "date_components": ("", "UNWIND [1] AS one RETURN "
                            "toString(date({year: 1999, month: 12, "
                            "day: 31})) AS s, "
                            "toString(date({year: 2024})) AS t"),
    "date_to_string": ("", "UNWIND [1] AS one "
                           "RETURN toString(date('2020-01-15')) AS s"),
    "date_plus_minus": ("", "UNWIND [1] AS one RETURN "
                            "toString(date('2020-01-31') "
                            "+ duration({months: 1})) AS clamped, "
                            "toString(date('2020-03-06') "
                            "- duration({days: 6})) AS back"),
    "dates_in_lists": ("", "UNWIND [1] AS one RETURN [d IN "
                           "[date('2020-01-15'), date('2021-05-05')] "
                           "| d.year] AS ys"),
    "datetime_accessors": ("", "UNWIND [1] AS one "
                               "WITH datetime('2020-01-15T10:30:45') AS t "
                               "RETURN t.year AS y, t.hour AS h, "
                               "t.minute AS m, t.second AS s, "
                               "t < datetime('2020-01-15T11:00:00') AS lt"),
    "datetime_day_boundary": ("", "UNWIND [1] AS one RETURN "
                                  "toString(datetime('2020-01-15T23:30:00')"
                                  " + duration({hours: 1})) AS t"),
    "datetime_truncation": ("", "UNWIND [1] AS one RETURN "
                                "toString(date(datetime("
                                "'2020-01-15T10:30:00'))) AS d"),
    "duration_map": ("", "UNWIND [1] AS one WITH duration({years: 1, "
                         "months: 2, days: 3, hours: 4}) AS du "
                         "RETURN du.months AS mo, du.days AS d, "
                         "du.hours AS h"),
    "duration_iso": ("", "UNWIND [1] AS one "
                         "WITH duration('P1Y2M3DT4H5M6S') AS du "
                         "RETURN du.months AS mo, du.days AS d, "
                         "du.seconds AS s"),
    "temporal_nulls": ("CREATE (:E)",
                       "MATCH (e:E) RETURN date(e.missing) AS d, "
                       "e.missing + duration({days: 1}) AS p"),
    "temporal_grouping": ("CREATE (:E {g: 'x', d: date('2020-01-15')}), "
                          "(:E {g: 'x', d: date('2019-06-30')}), "
                          "(:E {g: 'y', d: date('2021-05-05')})",
                          "MATCH (e:E) RETURN e.g AS g, "
                          "toString(min(e.d)) AS first, "
                          "count(DISTINCT e.d) AS n"),
    # acceptance
    "acc_bound_map_values": ("CREATE (:Z)",
                             "MATCH (z:Z) RETURN [m IN [{a: 1}] | keys(m)] "
                             "AS ks, [m IN [{a: 1, b: 2}] | properties(m)] "
                             "AS ps"),
    "acc_reduce": ("CREATE (:Z)",
                   "MATCH (z:Z) RETURN reduce(t = 0, x IN [1, 2, 3] "
                   "| t + x) AS s, reduce(s = '', x IN ['a', 'b'] "
                   "| s + x) AS c"),
    "acc_conversions": ("CREATE ({v: 42})",
                        "MATCH (n) RETURN toString(n.v) AS s, "
                        "toFloat(n.v) AS f, toInteger('17') AS i, "
                        "toBoolean('true') AS b"),
    "acc_keys_properties": ("CREATE ({a: 1, b: 'x'})",
                            "MATCH (n) RETURN keys(n) AS k, "
                            "properties(n) AS p"),
    "acc_date_roundtrip": ("CREATE (:E {d: date('2020-03-07')})",
                           "MATCH (e:E) RETURN e.d AS d, e.d.year AS y, "
                           "e.d.month AS m, e.d.day AS dd"),
    "acc_arithmetic": ("CREATE (:Z)",
                       "MATCH (z:Z) RETURN date('2020-01-31') "
                       "+ duration({months: 1}) AS clamped, "
                       "datetime('2020-01-15T23:30:00') "
                       "+ duration({hours: 1}) AS t, "
                       "duration({days: 1}) + duration({hours: 2}) AS dd"),
    "acc_aggregation": ("CREATE (:E {g:'x', d: date('2020-01-15')}), "
                        "(:E {g:'x', d: date('2019-06-30')}), "
                        "(:E {g:'y', d: date('2021-05-05')})",
                        "MATCH (e:E) RETURN e.g AS g, min(e.d) AS mn, "
                        "max(e.d) AS mx, count(DISTINCT e.d) AS n "
                        "ORDER BY g"),
    "acc_collections": ("CREATE (:Z)",
                        "MATCH (z:Z) RETURN [d IN [date('2020-01-15'), "
                        "date('2021-05-05')] WHERE d.year > 2020 "
                        "| toString(d)] AS ds"),
    "acc_null_and_errors": ("CREATE (:Z)",
                            "MATCH (z:Z) RETURN date(z.missing) AS d"),
}


@pytest.fixture(scope="module")
def sessions():
    return (caps_tpu_torch.local_session(device="cpu"),
            caps_tpu.local_session(backend="tpu"),
            caps_tpu_torch.local_session(backend="local"))


@pytest.mark.parametrize("case", list(GAP_CASES.values()),
                         ids=list(GAP_CASES))
def test_closed_gap(sessions, case):
    create, query = case
    port, ref, own = sessions
    graphs = (port_create(port, create, {}), jax_create(ref, create, {}),
              port_create(own, create, {}))
    assert_same(graphs, query, ordered="ORDER BY" in query)


# -- the bulk ingest of datetime64 columns -----------------------------------------

def test_datetime64_columns_ingest_in_bulk():
    """``graph_from_numpy`` takes ``datetime64[D]`` as dates and
    ``datetime64[us]`` as datetimes (NaT a null), the same graph as one
    built from the values."""
    from caps_tpu_torch.interop import ctype_of, graph_from_numpy
    rng = np.random.RandomState(3)
    days = rng.randint(-800_000 // 2, 2_900_000, 50).astype("datetime64[D]")
    days[[3, 17]] = np.datetime64("NaT")
    us = (rng.randint(-10**15, 10**15, 50)).astype("datetime64[us]")
    assert ctype_of(days) == CTDate and ctype_of(us) == CTDateTime
    nodes = {"N": {"_id": np.arange(50, dtype=np.int64), "d": days, "t": us}}
    port = graph_from_numpy(caps_tpu_torch.local_session(device="cpu"),
                            nodes, {})
    rows = port.cypher("MATCH (n:N) RETURN n.d AS d, n.t AS t ORDER BY "
                       "id(n)", {}).records.to_maps()
    want_d = [None if np.isnat(d) else PV.CypherDate(int(d.astype(np.int64)))
              for d in days]
    want_t = [PV.CypherDateTime(int(t.astype(np.int64))) for t in us]
    assert [r["d"] for r in rows] == want_d
    assert [r["t"] for r in rows] == want_t


# -- the calendar against okapi/values.py -------------------------------------------

_DAYS = st.integers(min_value=T.MIN_DAY, max_value=T.MAX_DAY)
_SETTINGS = settings(max_examples=300, deadline=None,
                     suppress_health_check=[HealthCheck.too_slow])


def _t(xs):
    import torch
    return torch.tensor(xs, dtype=torch.int64)


@_SETTINGS
@given(st.lists(_DAYS, min_size=1, max_size=40))
def test_civil_calendar_over_years_1_to_9999(days):
    y, m, d = T.civil_from_days(_t(days))
    want = [PV.CypherDate(x) for x in days]
    assert y.tolist() == [w.year for w in want]
    assert m.tolist() == [w.month for w in want]
    assert d.tolist() == [w.day for w in want]
    assert T.days_from_civil(y, m, d).tolist() == days


_DURATIONS = st.tuples(st.integers(-1300, 1300), st.integers(-40_000, 40_000),
                       st.integers(-10**9, 10**9))


def _plus(value, dur, sign):
    try:
        return value.plus(dur if sign > 0 else dur.negate())
    except (ValueError, OverflowError):
        return None


@_SETTINGS
@given(st.lists(st.tuples(_DAYS, _DURATIONS), min_size=1, max_size=30),
       st.sampled_from([1, -1]))
def test_date_plus_duration(pairs, sign):
    days = [p[0] for p in pairs]
    durs = [PV.CypherDuration(*p[1]) for p in pairs]
    out, bad = T.plus(Column("date", _t(days), None, CTDate),
                      _t([list(p[1]) for p in pairs]), sign)
    for x, dur, got, b in zip(days, durs, out.tolist(), bad.tolist()):
        want = _plus(PV.CypherDate(x), dur, sign)
        assert b == (want is None)
        if want is not None:
            assert got == want.days


_MICROS = st.integers(min_value=T.MIN_DAY * US_PER_DAY,
                      max_value=(T.MAX_DAY + 1) * US_PER_DAY - 1)


@_SETTINGS
@given(st.lists(st.tuples(_MICROS, _DURATIONS), min_size=1, max_size=30),
       st.sampled_from([1, -1]))
def test_datetime_plus_duration(pairs, sign):
    us = [p[0] for p in pairs]
    out, bad = T.plus(Column("datetime", _t(us), None, CTDateTime),
                      _t([list(p[1]) for p in pairs]), sign)
    for x, p, got, b in zip(us, pairs, out.tolist(), bad.tolist()):
        want = _plus(PV.CypherDateTime(x), PV.CypherDuration(*p[1]), sign)
        assert b == (want is None)
        if want is not None:
            assert got == want.micros


@_SETTINGS
@given(st.lists(st.integers(min_value=-10**15, max_value=10**15),
                min_size=1, max_size=40))
def test_datetime_accessors_of_negative_micros(us):
    col = Column("datetime", _t(us), None, CTDateTime)
    want = [PV.CypherDateTime(x) for x in us]
    for key in ("year", "month", "day", "hour", "minute", "second"):
        assert T.component(col, key).tolist() == \
            [PV.temporal_component(w, key) for w in want]
    assert T.component(col, "months") is None
    assert T.to_date(col).tolist() == [w.date().days for w in want]


@_SETTINGS
@given(st.lists(_DURATIONS, min_size=1, max_size=40))
def test_duration_accessors(durs):
    col = Column("duration", _t([list(d) for d in durs]), None, None)
    want = [PV.CypherDuration(*d) for d in durs]
    for key in ("months", "years", "days", "seconds", "hours", "minutes"):
        assert T.component(col, key).tolist() == \
            [PV.temporal_component(w, key) for w in want]
    assert T.component(col, "year") is None
