"""CONSTRUCT / RETURN GRAPH (multiple graphs) on the port against the
JAX package.

The same CREATE text is seeded into ``caps_tpu.local_session(backend=
"tpu")`` and ``caps_tpu_torch.local_session(device="cpu")``; every case
compares the constructed graphs' node and relationship bags exactly and
the rows of the queries run on them.  The cases are those of
``tests/test_multiple_graph.py`` that need no file system (the port's
``io/`` has tests of its own), then the port's own: a NEW property computed on the device
path, two parameter values building two graphs, a catalog graph replaced
by a CONSTRUCT never replaying the old sizes, minted ids disjoint from
the ON graphs', the largest id read on the device equal to the
reference's walk, and overlays over random graphs.
"""
from __future__ import annotations

import numpy as np
import pytest

import caps_tpu_torch
from caps_tpu_torch.testing.bag import Bag
from caps_tpu_torch.testing.factory import create_graph


def port_session():
    return caps_tpu_torch.local_session(device="cpu")


def jax_session():
    import caps_tpu
    return caps_tpu.local_session(backend="tpu")


def jax_create(session, create):
    from caps_tpu.testing.factory import create_graph as jc
    return jc(session, create)


def bags(graph):
    """(nodes, relationships) of a graph as sorted plain tuples: id,
    labels, properties; id, source, target, type, properties."""
    nodes = sorted((i, tuple(sorted(lbls)), tuple(sorted(p.items())))
                   for i, (lbls, p) in graph.node_lookup().items())
    rels = sorted((i, s, t, typ, tuple(sorted(p.items())))
                  for i, (s, t, typ, p) in graph.rel_lookup().items())
    return nodes, rels


class Both:
    """One scenario on both engines: ``run(fn)`` calls ``fn(session,
    create_graph)`` on each and returns (port value, JAX value)."""

    def __init__(self):
        self.port = port_session()
        self.ref = jax_session()

    def run(self, fn):
        return (fn(self.port, create_graph), fn(self.ref, jax_create))


def rows(graph, query, params=None):
    return graph.cypher(query, params or {}).records.to_maps()


# -- the reference's cases (tests/test_multiple_graph.py) --------------------

def test_from_graph_switches_graph():
    def scenario(s, create):
        s.catalog.store("g1", create(s, "CREATE (:A {v: 1})"))
        s.catalog.store("g2", create(s, "CREATE (:A {v: 2})"))
        return [rows(s, f"FROM GRAPH session.{g} MATCH (n:A) RETURN n.v AS v")
                for g in ("g1", "g2")]
    port, ref = Both().run(scenario)
    assert port == ref == [[{"v": 1}], [{"v": 2}]]


def test_union_branches_use_own_graphs():
    def scenario(s, create):
        s.catalog.store("g1", create(s, "CREATE (:A {v: 'g1'})"))
        s.catalog.store("g2", create(s, "CREATE (:A {v: 'g2'})"))
        return rows(s, "FROM GRAPH session.g1 MATCH (n:A) RETURN n.v AS v "
                       "UNION ALL FROM GRAPH session.g2 MATCH (m:A) "
                       "RETURN m.v AS v")
    port, ref = Both().run(scenario)
    assert Bag(port) == Bag(ref) == [{"v": "g1"}, {"v": "g2"}]


def test_construct_new_graph():
    def scenario(s, create):
        g = create(s, "CREATE (:Person {name: 'Alice'}), "
                      "(:Person {name: 'Bob'})")
        out = g.cypher("MATCH (p:Person) CONSTRUCT NEW (:Copy {name: p.name})"
                       " RETURN GRAPH").graph
        return bags(out), rows(out, "MATCH (c:Copy) RETURN c.name AS n")
    (pb, pr), (rb, rr) = Both().run(scenario)
    assert pb == rb
    assert Bag(pr) == Bag(rr) == [{"n": "Alice"}, {"n": "Bob"}]


def test_construct_clone_and_new_edge():
    def scenario(s, create):
        g = create(s, "CREATE (:P {name: 'a'}), (:P {name: 'b'})")
        out = g.cypher(
            "MATCH (p:P) CONSTRUCT CLONE p NEW (p)-[:TAGGED]->"
            "(:Tag {of: p.name}) RETURN GRAPH").graph
        return bags(out), rows(out, "MATCH (p:P)-[:TAGGED]->(t:Tag) "
                                    "RETURN p.name AS p, t.of AS t")
    (pb, pr), (rb, rr) = Both().run(scenario)
    assert pb == rb
    assert Bag(pr) == Bag(rr) == [{"p": "a", "t": "a"}, {"p": "b", "t": "b"}]


def test_construct_on_unions_with_base_graph():
    """The reference reads ``labels(n)``, which has no device path in
    the port (ROADMAP Queue 1 item 2): the labels come from the graph
    bags instead, and the rows from each label."""
    def scenario(s, create):
        s.catalog.store("base", create(s, "CREATE (:X {v: 1})"))
        g = create(s, "CREATE (:Y {v: 2})")
        out = g.cypher("MATCH (y:Y) CONSTRUCT ON session.base "
                       "NEW (:Z {v: y.v}) RETURN GRAPH").graph
        return bags(out), [rows(out, f"MATCH (n:{lbl}) RETURN n.v AS v")
                           for lbl in ("X", "Z")]
    (pb, pr), (rb, rr) = Both().run(scenario)
    assert pb == rb
    assert [lbls for _i, lbls, _p in pb[0]] == [("X",), ("Z",)]
    assert pr == rr == [[{"v": 1}], [{"v": 2}]]


def test_construct_set():
    def scenario(s, create):
        g = create(s, "CREATE (:P {name: 'a'})")
        out = g.cypher("MATCH (p:P) CONSTRUCT CLONE p SET p.seen = true "
                       "SET p:Checked RETURN GRAPH").graph
        return bags(out), rows(out, "MATCH (p:Checked) "
                                    "RETURN p.name AS n, p.seen AS s")
    (pb, pr), (rb, rr) = Both().run(scenario)
    assert pb == rb
    assert pr == rr == [{"n": "a", "s": True}]


def test_catalog_create_graph():
    def scenario(s, create):
        s.catalog.store("src", create(
            s, "CREATE (:A {v: 1})-[:R]->(:B {v: 2})"))
        s.cypher(
            "CATALOG CREATE GRAPH session.snapshot { FROM GRAPH session.src "
            "MATCH (a:A)-[r:R]->(b:B) CONSTRUCT CLONE a, b NEW (a)-[:R2]->(b) "
            "RETURN GRAPH }")
        snap = s.catalog.graph("session.snapshot")
        return bags(snap), rows(snap, "MATCH (a)-[:R2]->(b) "
                                      "RETURN a.v AS a, b.v AS b")
    (pb, pr), (rb, rr) = Both().run(scenario)
    assert pb == rb
    assert pr == rr == [{"a": 1, "b": 2}]


def test_return_graph_of_from_graph():
    def scenario(s, create):
        s.catalog.store("g", create(s, "CREATE (:A {v: 7})"))
        out = s.cypher("FROM GRAPH session.g RETURN GRAPH").graph
        return bags(out), rows(out, "MATCH (n:A) RETURN n.v AS v")
    (pb, pr), (rb, rr) = Both().run(scenario)
    assert pb == rb
    assert pr == rr == [{"v": 7}]


def test_graph_union_all():
    def scenario(s, create):
        u = create(s, "CREATE (:A {v: 1})").union_all(
            create(s, "CREATE (:B {v: 2})"))
        return bags(u), rows(u, "MATCH (n) RETURN n.v AS v")
    (pb, pr), (rb, rr) = Both().run(scenario)
    assert pb == rb
    assert Bag(pr) == Bag(rr) == [{"v": 1}, {"v": 2}]


def test_construct_on_set_clone_replaces_original():
    """SET on a clone of an ON-graph entity replaces the original
    (overlay) instead of leaving a duplicate id in the union."""
    def scenario(s, create):
        s.catalog.store("base", create(
            s, "CREATE (:A {v: 1})-[:R]->(:A {v: 2})"))
        out = s.cypher(
            "FROM GRAPH session.base MATCH (x:A) "
            "CONSTRUCT ON session.base CLONE x SET x.flag = true "
            "RETURN GRAPH").graph
        return (bags(out),
                rows(out, "MATCH (n:A) RETURN n.v AS v, n.flag AS f"),
                rows(out, "MATCH (:A)-[r:R]->(:A) RETURN count(*) AS c"))
    port, ref = Both().run(scenario)
    assert port[0] == ref[0]
    assert Bag(port[1]) == Bag(ref[1]) == [{"v": 1, "f": True},
                                            {"v": 2, "f": True}]
    # relationships from the ON graph survive the overlay
    assert port[2] == ref[2] == [{"c": 1}]


def test_union_branches_rehydrate_from_their_own_graph():
    """Each UNION branch materializes its entities from the graph it
    matched: returning the entity itself, and reading it through a list
    comprehension, whose lambda variable looks the entity up in the
    branch's own graph (the device index of that graph)."""
    def scenario(s, create):
        s.catalog.store("g1", create(s, "CREATE (:A {v: 'g1'})"))
        s.catalog.store("g2", create(s, "CREATE (:A {v: 'g2'})"))
        out = s.cypher(
            "FROM GRAPH session.g1 MATCH (n:A) RETURN n AS v "
            "UNION ALL FROM GRAPH session.g2 MATCH (m:A) RETURN m AS v")
        lam = s.cypher(
            "FROM GRAPH session.g1 MATCH (n:A) RETURN [x IN [n] | x.v] AS v "
            "UNION ALL FROM GRAPH session.g2 MATCH (m:A) "
            "RETURN [x IN [m] | x.v] AS v")
        return (sorted(r["v"].properties["v"] for r in out.to_maps()),
                sorted(r["v"][0] for r in lam.to_maps()))
    port, ref = Both().run(scenario)
    assert port == ref == (["g1", "g2"], ["g1", "g2"])


# -- the port's own cases ----------------------------------------------------

SOCIAL = ("CREATE (a:Person {name: 'Ann', age: 30}), "
          "(b:Person {name: 'Ben', age: 41}), "
          "(c:Person:Admin {name: 'Cid', age: 30}), "
          "(d:Person {name: 'Dee', age: 25}), "
          "(a)-[:KNOWS {w: 1}]->(b), (a)-[:KNOWS {w: 2}]->(c), "
          "(b)-[:KNOWS {w: 3}]->(c), (c)-[:KNOWS {w: 4}]->(d), "
          "(d)-[:KNOWS {w: 5}]->(a)")


def test_new_property_expressions_are_computed_on_the_device_path():
    """NEW and SET property expressions over the driving rows: each is
    a column computed through the device expression compiler, read
    once; the built graph equals the reference's."""
    q = ("MATCH (a:Person)-[k:KNOWS]->(b:Person) WHERE a.age < $max "
         "CONSTRUCT CLONE a, b NEW (a)-[:MET {w: k.w * 10 + b.age, "
         "tag: a.name + '-x', old: b.age > 29}]->(b) "
         "SET a.next = a.age + 1 RETURN GRAPH")

    def scenario(s, create):
        out = create(s, SOCIAL).cypher(q, {"max": 40}).graph
        return bags(out), rows(out, "MATCH (a)-[m:MET]->(b) RETURN a.name AS "
                                    "a, m.w AS w, m.tag AS t, m.old AS o, "
                                    "a.next AS n ORDER BY w")
    (pb, pr), (rb, rr) = Both().run(scenario)
    assert pb == rb
    assert pr == rr
    assert [r["w"] for r in pr] == [50, 51, 65, 80]


def test_an_expression_without_a_device_path_raises_naming_it():
    """An expression the reference refuses too (``toUpper`` of an
    integer) raises naming its cause."""
    from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice
    g = create_graph(port_session(), SOCIAL)
    with pytest.raises(UnsupportedOnDevice, match="toupper on non-string"):
        g.cypher("MATCH (a:Person) CONSTRUCT NEW "
                 "(:C {v: toUpper(a.age)}) RETURN GRAPH")


def test_a_string_function_of_column_arguments_builds_as_the_reference():
    """``substring`` with a column argument sets the new nodes' property
    on the device path, as the reference does."""
    q = ("MATCH (a:Person) CONSTRUCT NEW "
         "(:C {v: substring(a.name, a.age % 3), n: a.name}) RETURN GRAPH")

    def scenario(s, create):
        built = create(s, SOCIAL).cypher(q).graph
        return rows(built, "MATCH (c:C) RETURN c.n AS n, c.v AS v "
                           "ORDER BY n")
    port, ref = Both().run(scenario)
    assert port == ref


def test_two_parameter_values_build_two_graphs():
    q = ("MATCH (a:Person) WHERE a.age = $age "
         "CONSTRUCT NEW (:Seen {name: a.name}) RETURN GRAPH")

    def scenario(s, create):
        g = create(s, SOCIAL)
        out = []
        for age in (30, 41, 30):
            built = g.cypher(q, {"age": age}).graph
            out.append(sorted(r["n"] for r in rows(
                built, "MATCH (x:Seen) RETURN x.name AS n")))
        return out
    port, ref = Both().run(scenario)
    assert port == ref == [["Ann", "Cid"], ["Ben"], ["Ann", "Cid"]]


def test_from_graph_after_a_construct_replaced_it_never_replays_old_sizes():
    """A catalog graph built by CONSTRUCT and stored again under the
    same name: the ``FROM GRAPH`` query that replayed on the first graph
    must answer for the second, never with the first one's recorded
    sizes (the JAX package replays the old sizes here, ROADMAP Queue 3,
    so the oracle is the graph's own count)."""
    s = port_session()
    s.catalog.store("src", create_graph(s, SOCIAL))
    make = ("CATALOG CREATE GRAPH session.seen { FROM GRAPH session.src "
            "MATCH (a:Person) WHERE a.age >= $min "
            "CONSTRUCT NEW (:Seen {name: a.name}) RETURN GRAPH }")
    read = "FROM GRAPH session.seen MATCH (x:Seen) RETURN x.name AS n"
    seen = []
    for lo in (30, 26, 41):
        s.cypher(make, {"min": lo})
        for _ in range(3):  # record, then replays
            seen.append(sorted(r["n"] for r in s.cypher(read).to_maps()))
    want = {30: ["Ann", "Ben", "Cid"], 26: ["Ann", "Ben", "Cid"],
            41: ["Ben"]}
    assert seen == [want[lo] for lo in (30, 26, 41) for _ in range(3)]
    assert s.fused.replays > 0


def test_minted_ids_are_disjoint_from_the_on_graphs():
    def scenario(s, create):
        s.catalog.store("base", create(s, SOCIAL))
        out = s.cypher(
            "FROM GRAPH session.base MATCH (a:Person)-[:KNOWS]->(b) "
            "CONSTRUCT ON session.base NEW (a)-[:MET]->(:Note {of: b.name}) "
            "RETURN GRAPH").graph
        return bags(out)
    port, ref = Both().run(scenario)
    assert port == ref
    base_ids = set(range(9))  # 4 persons, 5 KNOWS
    nodes, rels = port
    new_ids = {i for i, lbls, _p in nodes if lbls == ("Note",)} | \
        {i for i, *_rest, in rels if _rest[2] == "MET"}
    assert len(new_ids) == 10 and not new_ids & base_ids


def test_max_graph_id_equals_the_reference_walk():
    """``_max_graph_id`` reads each id column's largest value on the
    device; the reference walks the values in Python."""
    from caps_tpu.relational.construct import _max_graph_id as ref_max
    from caps_tpu_torch.relational.construct import _max_graph_id
    both = Both()
    port, ref = both.run(lambda s, create: create(s, SOCIAL).union_all(
        create(s, "CREATE (:Q {v: 1})-[:R]->(:Q)")))
    assert _max_graph_id(port) == ref_max(ref) == 8


def _random_create(seed: int, n: int = 40, m: int = 120) -> str:
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(n):
        labels = ":Person:Admin" if i % 7 == 0 else ":Person"
        parts.append(f"(n{i}{labels} {{age: {int(rng.integers(18, 24))}, "
                     f"city: 'c{int(rng.integers(0, 4))}'}})")
    for _ in range(m):
        a, b = rng.integers(0, n, 2)
        parts.append(f"(n{a})-[:KNOWS {{w: {int(rng.integers(0, 9))}}}]->"
                     f"(n{b})")
    return "CREATE " + ", ".join(parts)


@pytest.mark.parametrize("query", [
    # SET on cloned nodes: the overlay replaces them
    "FROM GRAPH session.base MATCH (a:Person) WHERE a.age = $age "
    "CONSTRUCT ON session.base CLONE a SET a.age = a.age + 100 "
    "RETURN GRAPH",
    # SET on a cloned relationship and a label on its source
    "FROM GRAPH session.base MATCH (a:Person)-[r:KNOWS]->(b) "
    "WHERE a.age = $age CONSTRUCT ON session.base CLONE a, r "
    "SET r.w = r.w + a.age SET a:Seen RETURN GRAPH",
    # an overlay that also mints new entities
    "FROM GRAPH session.base MATCH (a:Person)-[:KNOWS]->(b) "
    "WHERE b.age = $age CONSTRUCT ON session.base CLONE b "
    "SET b.hit = true NEW (b)-[:MET {x: a.age}]->(:Tag {c: a.city}) "
    "RETURN GRAPH",
], ids=["set_nodes", "set_rel_and_label", "set_and_new"])
@pytest.mark.parametrize("seed", [0, 1])
def test_overlay_equals_the_reference_build(query, seed):
    """The overlay copies every entity of the ON graph into the build
    (``_materialize_graph_into``) and regroups them into tables
    (``_tables_from_entities``), with NEW and SET values computed on the
    device path: the graph equals the reference's, and so do grouped
    queries on it."""
    create = _random_create(seed)

    def scenario(s, make):
        s.catalog.store("base", make(s, create))
        out = s.cypher(query, {"age": 20}).graph
        return bags(out), rows(
            out, "MATCH (a:Person)-[k:KNOWS]->(b) RETURN a.age AS age, "
                 "count(*) AS n, sum(k.w) AS w ORDER BY age")
    (pb, pr), (rb, rr) = Both().run(scenario)
    assert pb == rb
    assert pr == rr


def test_overlay_stats_and_a_replay_on_the_constructed_graph():
    """The build reports where its time went and what it built, and a
    query on the constructed graph replays with no size read."""
    s = port_session()
    s.catalog.store("base", create_graph(s, _random_create(3)))
    res = s.cypher("CATALOG CREATE GRAPH session.over { FROM GRAPH "
                   "session.base MATCH (a:Person) WHERE a.age = 20 "
                   "CONSTRUCT ON session.base CLONE a SET a.age = 120 "
                   "RETURN GRAPH }")
    stats = res.graph.construct_stats
    assert stats["overlay"] and stats["minted"] == 0
    assert set(stats) >= {"match_s", "entity_s", "materialize_s",
                          "table_s", "rows"}
    q = ("FROM GRAPH session.over MATCH (a:Person)-[:KNOWS]->(b) "
         "WHERE a.age = $age RETURN count(*) AS n")
    first = s.cypher(q, {"age": 120})
    again = s.cypher(q, {"age": 120})
    assert first.to_maps() == again.to_maps()
    assert again.metrics["size_syncs"] == 0
    assert s.cypher(q, {"age": 20}).to_maps() == [{"n": 0}]
