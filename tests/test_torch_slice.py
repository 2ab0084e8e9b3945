"""The port's read path end to end against the JAX package.

One seeded graph — 2,000 :Person nodes {age, city (50 strings)} and
10,000 :KNOWS edges — goes through ``caps_tpu_torch.interop`` into a CPU
session of the port, and the same arrays through ``from_columns`` into
the JAX package's device backend (on the CPU, its Pallas kernels in
interpret mode).  Both must return the same records: in order where the
ORDER BY is total, as bags otherwise."""
import collections

import numpy as np
import pytest

import caps_tpu
import caps_tpu_torch
from caps_tpu.okapi.types import CTInteger, CTString
from caps_tpu.relational.entity_tables import (
    NodeMapping, NodeTable, RelationshipMapping, RelationshipTable,
)
from caps_tpu_torch.interop import graph_from_numpy

N_PERSONS, N_EDGES, N_CITIES = 2000, 10000, 50

TWO_HOP = ("MATCH (a:Person)-[:KNOWS]->(b)-[:KNOWS]->(c) WHERE a.age = $age ")

# (query, parameters, ordered)
QUERIES = {
    "grouped_2hop": (TWO_HOP + "RETURN c.city AS city, count(*) AS n "
                     "ORDER BY n DESC, city LIMIT 20", {"age": 30}, True),
    "count_2hop": (TWO_HOP + "RETURN count(*) AS c", {"age": 30}, True),
    "distinct_1hop": ("MATCH (a:Person)-[:KNOWS]->(b:Person) "
                      "WHERE a.age < 25 RETURN DISTINCT b.city AS city",
                      {}, False),
    "order_skip_limit": ("MATCH (a:Person) WHERE a.age > 80 "
                         "RETURN a.age AS age, a.city AS city, id(a) AS id "
                         "ORDER BY age DESC, city, id SKIP 5 LIMIT 30",
                         {}, True),
    "min_max_by_city": ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age < 30 "
                        "RETURN b.city AS city, count(*) AS n, "
                        "min(b.age) AS lo, max(b.age) AS hi", {}, False),
    "no_match": (TWO_HOP + "RETURN c.city AS city, count(*) AS n",
                 {"age": 200}, False),
    # dense kernel over a bool key
    "group_by_bool": ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age < 40 "
                      "RETURN b.age > 50 AS old, count(*) AS n, "
                      "min(b.age) AS lo ORDER BY old", {}, True),
    # sorted group path over an int key
    "group_by_int": ("MATCH (a:Person) WHERE a.age < 25 "
                     "RETURN a.age AS age, count(*) AS n ORDER BY age",
                     {}, True),
    # ungrouped aggregates
    "sum_avg": ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age = 20 "
                "RETURN sum(b.age) AS s, avg(b.age) AS m, count(b) AS c",
                {}, True),
}


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.RandomState(1234)
    cities = np.array([f"city{i:02d}" for i in range(N_CITIES)])
    nodes = {"Person": {
        "_id": np.arange(N_PERSONS, dtype=np.int64),
        "age": rng.randint(18, 90, N_PERSONS).astype(np.int64),
        "city": cities[rng.randint(0, N_CITIES, N_PERSONS)]}}
    rels = {"KNOWS": {
        "_id": np.arange(N_PERSONS, N_PERSONS + N_EDGES, dtype=np.int64),
        "_src": rng.randint(0, N_PERSONS, N_EDGES).astype(np.int64),
        "_tgt": rng.randint(0, N_PERSONS, N_EDGES).astype(np.int64)}}
    return nodes, rels


@pytest.fixture(scope="module")
def torch_graph(arrays):
    nodes, rels = arrays
    session = caps_tpu_torch.local_session(device="cpu")
    return graph_from_numpy(session, nodes, rels)


@pytest.fixture(scope="module")
def jax_graph(arrays):
    nodes, rels = arrays
    session = caps_tpu.local_session(backend="tpu")
    f = session.table_factory
    p, k = nodes["Person"], rels["KNOWS"]
    people = NodeTable(
        NodeMapping.on("_id").with_implied_labels("Person")
        .with_property("age").with_property("city"),
        f.from_columns({"_id": p["_id"].tolist(), "age": p["age"].tolist(),
                        "city": p["city"].tolist()},
                       {"_id": CTInteger, "age": CTInteger,
                        "city": CTString}))
    knows = RelationshipTable(
        RelationshipMapping.on("KNOWS"),
        f.from_columns({c: k[c].tolist() for c in ("_id", "_src", "_tgt")},
                       {c: CTInteger for c in ("_id", "_src", "_tgt")}))
    return session.create_graph([people], [knows])


def _bag(rows):
    return collections.Counter(tuple(sorted(r.items())) for r in rows)


@pytest.mark.parametrize("name", list(QUERIES))
def test_port_matches_jax(name, torch_graph, jax_graph):
    query, params, ordered = QUERIES[name]
    got = torch_graph.cypher(query, params).records.to_maps()
    want = jax_graph.cypher(query, params).records.to_maps()
    if ordered:
        assert got == want
    else:
        assert _bag(got) == _bag(want)


def test_two_hop_count_matches_numpy_oracle(arrays, torch_graph):
    nodes, rels = arrays
    src, tgt = rels["KNOWS"]["_src"], rels["KNOWS"]["_tgt"]
    seeds = (nodes["Person"]["age"] == 30).astype(np.int64)
    # paths ending at each node after one hop, then after two
    hop1 = np.bincount(tgt, weights=seeds[src], minlength=N_PERSONS)
    hop2 = np.bincount(tgt, weights=hop1[src], minlength=N_PERSONS)
    got = torch_graph.cypher(TWO_HOP + "RETURN count(*) AS c",
                             {"age": 30}).records.to_maps()
    assert got == [{"c": int(hop2.sum())}]
