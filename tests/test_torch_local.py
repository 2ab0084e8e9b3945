"""The port's pure-Python oracle (``caps_tpu_torch/backends/local``)
against the JAX package's ``LocalCypherSession``.

The same seeded graph goes into both local sessions (the port's through
``tests/test_torch_algo.py port_make_graph``, the reference's through
``tests/util.py make_graph``) and every query must give the same rows:
reads (chains, undirected patterns, OPTIONAL MATCH, var-length
patterns, cycles, aggregates, percentiles, CASE, string and list
functions, the expressions the CUDA backend has no device path for) and
every ``CALL algo.*`` form, with the same EXPLAIN plans and estimates;
then writes on a versioned graph and CONSTRUCT.  The port's local backend runs only what the reference's
does: no count pushdown, no multiway join, the host algorithm kernels.
"""
from __future__ import annotations

import numpy as np
import pytest

import caps_tpu_torch
from caps_tpu.backends.local.session import LocalCypherSession
from caps_tpu.relational.updates import versioned as jax_versioned
from caps_tpu_torch.backends.local.session import \
    LocalCypherSession as PortLocalSession
from caps_tpu_torch.backends.local.table import LocalTable
from caps_tpu_torch.relational.updates import versioned
from caps_tpu_torch.testing.bag import Bag
from tests.test_torch_algo import port_make_graph
from tests.util import make_graph as jax_make_graph

BASE = 10 ** 9


def _spec(seed=3, n=120, e=600):
    rng = np.random.RandomState(seed)
    people, employees, cities = [], [], []
    for k in range(n):
        nid = BASE + 7 * k
        row = {"_id": nid, "name": f"p{k % 23}",
               "age": int(rng.randint(18, 90)) if k % 9 else None}
        if k % 10 == 0:
            cities.append({"_id": nid, "name": f"c{k}"})
        elif k % 4 == 0:
            employees.append(dict(row, salary=float(rng.randint(1, 9)) * 1e3))
        else:
            people.append(row)
    ids = [r["_id"] for r in people + employees]
    knows = [(int(ids[rng.randint(len(ids))]), int(ids[rng.randint(len(ids))]),
              {"w": float(1 + i % 5)} if i % 7 else {})
             for i in range(e)]
    lives = [(int(i), int(cities[j % len(cities)]["_id"]), {})
             for j, i in enumerate(ids[:60])]
    nodes = {("Person",): people, ("Person", "Employee"): employees,
             ("City",): cities}
    return nodes, {"KNOWS": knows, "LIVES_IN": lives}


QUERIES = [
    "MATCH (a:Person) RETURN a.name AS n, a.age AS g",
    "MATCH (a:Person)-[:KNOWS]->(b) RETURN a.name AS a, b.age AS b",
    "MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) WHERE a.age > $age "
    "RETURN c.name AS n, count(*) AS k ORDER BY k DESC, n LIMIT 7",
    "MATCH (a)-[:KNOWS]-(b) RETURN count(*) AS k",
    "MATCH (a:Person) OPTIONAL MATCH (a)-[:LIVES_IN]->(c:City) "
    "RETURN a.name AS a, c.name AS c",
    "MATCH (a:Employee)-[:KNOWS*1..2]->(b) RETURN a.name AS a, "
    "count(b) AS k",
    "MATCH (a)-[r:KNOWS*2]->(b) RETURN a.age AS a, size(r) AS s",
    "MATCH (a)-[:KNOWS]->(b)-[:KNOWS]->(a) RETURN a.name AS a, b.name AS b",
    "MATCH (a)-[:KNOWS]->(b)-[:KNOWS]->(c)-[:KNOWS]->(a) RETURN count(*) AS k",
    "MATCH (a:Person) RETURN percentileCont(a.age, 0.4) AS p, "
    "percentileDisc(a.age, 0.5) AS d, stDev(a.age) AS s, avg(a.age) AS v",
    "MATCH (a:Person) RETURN CASE WHEN a.age IS NULL THEN 'none' "
    "WHEN a.age < 40 THEN 'young' ELSE 'old' END AS band, count(*) AS k",
    "MATCH (a:Person) RETURN toUpper(a.name) AS u, substring(a.name, 1) AS s,"
    " a.name STARTS WITH 'p1' AS b",
    "MATCH (a:Person) RETURN labels(a) AS l, keys(a) AS k, id(a) AS i",
    "MATCH (a:Employee) RETURN [x IN range(1, 3) | x * a.salary] AS xs, "
    "reduce(s = 0, x IN [1, 2, 3] | s + x) AS r, "
    "any(x IN [a.age, 1] WHERE x > 50) AS q",
    "MATCH p = (a:Employee)-[:KNOWS]->(b) RETURN length(p) AS n, "
    "[n IN nodes(p) | n.name] AS names",
    "MATCH (a:Person)-[:KNOWS]->(b) WITH a, collect(b.name) AS fs "
    "RETURN a.name AS a, size(fs) AS n ORDER BY n DESC, a LIMIT 5",
    "UNWIND [1, 2, null] AS x RETURN x, x + 1 AS y",
    "MATCH (a:Person) WHERE a.age IN [20, 30, 40] OR a.name = $name "
    "RETURN DISTINCT a.name AS n",
    "MATCH (a:City) RETURN {name: a.name, k: 1} AS m",
    "MATCH (a:Person) RETURN a.name AS n ORDER BY a.age DESC, n SKIP 3 "
    "LIMIT 4",
    "CALL algo.degree() YIELD node, degree RETURN node, degree",
    "CALL algo.degree('in') YIELD node, degree RETURN node, degree",
    "CALL algo.degree('out') YIELD node, degree WHERE degree > 3 "
    "RETURN node, degree",
    "CALL algo.pagerank() YIELD node, score RETURN node, score",
    "CALL algo.pagerank(0.85, 5) YIELD node, score RETURN node, score",
    "CALL algo.wcc() YIELD node, component RETURN node, component",
    "CALL algo.wcc(2) YIELD node, component RETURN node, component",
    "CALL algo.bfs($src) YIELD node, dist RETURN node, dist",
    "CALL algo.bfs($src, 2) YIELD node, dist RETURN node, dist",
    "CALL algo.bfs(12345) YIELD node, dist RETURN node, dist",
    "CALL algo.sssp($src, 'w') YIELD node, dist RETURN node, dist",
    "CALL algo.sssp($src, 'missing') YIELD node, dist RETURN node, dist",
    "CALL algo.sssp($src, 'w', 2) YIELD node, dist RETURN node, dist",
    "CALL algo.pagerank() YIELD node, score WHERE score > 0.01 "
    "RETURN node, score",
    "MATCH (a:Employee) CALL algo.degree() YIELD node, degree "
    "WITH a, node, degree WHERE node = id(a) RETURN a.name AS a, degree",
    "CALL algo.wcc() YIELD node, component MATCH (n) WHERE id(n) = node "
    "RETURN component, count(n) AS k",
]
PARAMS = {"age": 40, "name": "p3", "src": BASE + 7}


@pytest.fixture(scope="module")
def graphs():
    nodes, rels = _spec()
    port = port_make_graph(caps_tpu_torch.local_session(backend="local"),
                           nodes, rels)
    ref = jax_make_graph(LocalCypherSession(), nodes, rels)
    return port, ref


def _rows(graph, query, params=PARAMS):
    return graph.cypher(query, params).records.to_maps()


@pytest.mark.parametrize("query", QUERIES, ids=range(len(QUERIES)))
def test_reads_equal_the_reference_local_backend(graphs, query):
    port, ref = graphs
    got, want = _rows(port, query), _rows(ref, query)
    if "ORDER BY" in query:
        assert got == want
    else:
        assert Bag(got) == want


@pytest.mark.parametrize("query", QUERIES, ids=range(len(QUERIES)))
def test_plans_equal_the_reference_local_backend(graphs, query):
    """The same logical and relational plans, the same cost-model
    decisions and estimates: the statistics of host tables are the
    reference's."""
    port, ref = graphs
    got = port.cypher("EXPLAIN " + query, PARAMS).plans
    want = ref.cypher("EXPLAIN " + query, PARAMS).plans
    for key in ("logical", "relational", "cost"):
        assert got.get(key) == want.get(key), key


def test_the_local_session_plans_no_device_operator(graphs):
    port, _ = graphs
    for q in ("MATCH (a)-[:KNOWS]->(b)-[:KNOWS]->(c) RETURN count(*) AS k",
              "MATCH (a)-[:KNOWS]->(b)-[:KNOWS]->(c)-[:KNOWS]->(a) "
              "RETURN a.name AS n",
              "CALL algo.pagerank() YIELD node, score RETURN node, score"):
        res = port.cypher(q)
        ops = res.metrics["operators"]
        names = {o["op"] for o in ops}
        assert not names & {"CountPattern", "CountCycle", "MultiwayJoin"}
        assert all(o.get("strategy", "host") == "host"
                   for o in ops if o["op"] == "AlgoProcedure")
        assert isinstance(res.records.table, LocalTable)


def test_the_session_types():
    s = caps_tpu_torch.local_session(backend="oracle")
    assert isinstance(s, PortLocalSession)
    assert isinstance(PortLocalSession.local(), PortLocalSession)


WRITES = [
    "CREATE (:Person {name: 'new', age: 33})",
    "MATCH (a:Person {name: 'p3'}) SET a.age = 77",
    "MATCH (a:Person {name: 'new'}), (b:City) "
    "CREATE (a)-[:LIVES_IN]->(b)",
    "MATCH (a:Person)-[r:KNOWS]->(b) WHERE a.age > 80 DELETE r",
    "MATCH (a:Employee) WHERE a.salary > 5000 DETACH DELETE a",
    "MATCH (a:Person {name: 'p5'}) SET a.tag = 'x'",
]
READS = [
    "MATCH (a:Person) RETURN a.name AS n, a.age AS g, a.tag AS t",
    "MATCH (a)-[:KNOWS]->(b) RETURN count(*) AS k",
    "MATCH (a)-[:LIVES_IN]->(c) RETURN a.name AS a, c.name AS c",
    "CALL algo.degree() YIELD node, degree RETURN node, degree",
]


def test_writes_equal_the_reference_local_backend():
    nodes, rels = _spec(seed=5, n=60, e=200)
    ps = caps_tpu_torch.local_session(backend="local")
    port = versioned(ps, port_make_graph(ps, nodes, rels))
    js = LocalCypherSession()
    ref = jax_versioned(js, jax_make_graph(js, nodes, rels))
    for i, w in enumerate(WRITES):
        got, want = port.cypher(w), ref.cypher(w)
        assert got.records is None and want.records is None
        assert got.metrics["updates"] == want.metrics["updates"]
        for q in READS:
            assert Bag(_rows(port, q, {})) == _rows(ref, q, {}), (i, q)
        if i == 3:
            port.compact()
            ref.compact()


CONSTRUCTS = [
    "MATCH (a:Employee) CONSTRUCT CLONE a NEW (a)-[:T {w: a.age * 2}]->(:X)"
    " RETURN GRAPH",
    "MATCH (a:Person)-[r:KNOWS]->(b) WHERE a.age > 60 CONSTRUCT CLONE a, b "
    "NEW (a)-[:MET]->(b) RETURN GRAPH",
]


@pytest.mark.parametrize("query", CONSTRUCTS, ids=range(len(CONSTRUCTS)))
def test_construct_equals_the_reference_local_backend(graphs, query):
    port, ref = graphs
    pg, rg = port.cypher(query).graph, ref.cypher(query).graph
    for q in ("MATCH (n) RETURN labels(n) AS l, n.age AS a, n.name AS m",
              "MATCH (a)-[r]->(b) RETURN type(r) AS t, r.w AS w, "
              "a.name AS a, b.name AS b"):
        assert Bag(_rows(pg, q, {})) == _rows(rg, q, {})
