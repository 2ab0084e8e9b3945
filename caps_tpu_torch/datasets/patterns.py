"""Seeded graphs and queries of the planning and cyclic-pattern runs.

The two configurations the benchmark of the JAX package (``bench.py``)
documents for the cost model and the worst-case-optimal join, as numpy
arrays for ``interop.graph_from_numpy``:

* **plan** (``bench.py`` config 9, ``run_plan_config``): an LDBC-shaped
  planning graph — :Person {name, age} with Zipfian in-degree
  ``:KNOWS`` edges, a few :City and :Tag nodes, 3 ``LIVES_IN`` and 2
  Zipfian ``HAS_INTEREST`` edges per person — and its five query
  families: three chains the model should re-root at their selective
  far end and two guards where it should not deviate.  At its TPU size
  100,000 persons, 200 cities, 1,000 tags and 500,000 ``:KNOWS`` edges.
  The draws are vectorized: the same distributions as the benchmark,
  not the same values.
* **cyclic** (``bench.py`` config 10, ``run_cyclic_config``): n
  :Person {name} nodes and ``n * degree`` uniform ``:KNOWS`` edges (the
  benchmark's own draws), with the triangle, diamond and 4-cycle
  patterns it enumerates.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

#: the plan configuration at its TPU size: persons, cities, tags, KNOWS
PLAN_TPU_SIZE = (100_000, 200, 1_000, 500_000)

PLAN_FAMILIES = {
    # the model should re-root these chains at the selective far end
    "city_reroot": (
        "MATCH (p:Person)-[:LIVES_IN]->(c:City) "
        "WHERE c.name = $city RETURN p.name AS n",
        [{"city": f"c{i}"} for i in (3, 7, 11)]),
    "tag_reroot": (
        "MATCH (p:Person)-[:HAS_INTEREST]->(t:Tag) "
        "WHERE t.name = $tag RETURN p.name AS n",
        [{"tag": f"t{i}"} for i in (5, 9, 60)]),
    "twohop_reroot": (
        "MATCH (a:Person)-[:KNOWS]->(b:Person)-[:LIVES_IN]->(c:City) "
        "WHERE c.name = $city RETURN a.name AS n",
        [{"city": f"c{i}"} for i in (3, 7, 11)]),
    # guards: the model should NOT deviate from the heuristic here
    "count_spmv_guard": (
        "MATCH (a:Person)-[:KNOWS]->(b) WHERE a.name = $name "
        "RETURN count(*) AS c",
        [{"name": f"p{i}"} for i in (17, 940, 2500)]),
    "uniform_guard": (
        "MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE a.age > $min "
        "RETURN count(*) AS c",
        [{"min": m} for m in (20, 40, 60)]),
}

CYCLIC_PATTERNS = {
    "triangle": ("MATCH (a:Person)-[r1:KNOWS]->(b)-[r2:KNOWS]->(c), "
                 "(a)-[r3:KNOWS]->(c) "),
    "diamond": ("MATCH (a:Person)-[r1:KNOWS]->(b)-[r2:KNOWS]->(d), "
                "(a)-[r3:KNOWS]->(c)-[r4:KNOWS]->(d) "),
    "cycle4": ("MATCH (a:Person)-[r1:KNOWS]->(b)-[r2:KNOWS]->(c)"
               "-[r3:KNOWS]->(d), (d)-[r4:KNOWS]->(a) "),
}
CYCLIC_RETURN = {"triangle": "RETURN id(a) AS x, id(b) AS y, id(c) AS z",
                 "diamond": "RETURN id(a) AS w, id(b) AS x, "
                            "id(c) AS y, id(d) AS z",
                 "cycle4": "RETURN id(a) AS w, id(b) AS x, "
                           "id(c) AS y, id(d) AS z"}

Arrays = Dict[str, Dict[str, object]]


def _rels(pairs: Dict[str, Tuple[np.ndarray, np.ndarray]],
          first_id: int) -> Arrays:
    out, rid = {}, first_id
    for rel_type, (src, tgt) in pairs.items():
        m = len(src)
        out[rel_type] = {"_id": np.arange(rid, rid + m, dtype=np.int64),
                         "_src": np.asarray(src, dtype=np.int64),
                         "_tgt": np.asarray(tgt, dtype=np.int64)}
        rid += m
    return out


def plan_graph(n_person: int, n_city: int, n_tag: int, m_knows: int,
               seed: int = 42, lives_k: int = 3,
               interest_k: int = 2) -> Tuple[Arrays, Arrays]:
    """(nodes, rels) of the plan configuration (module docstring)."""
    rng = np.random.RandomState(seed)
    tgt = (rng.zipf(1.5, m_knows) - 1) % n_person    # Zipfian in-degree
    src = rng.randint(0, n_person, m_knows)
    tags = (rng.zipf(1.3, n_person * interest_k) - 1) % n_tag
    ages = rng.randint(0, 80, n_person)
    lives = rng.randint(0, n_city, n_person * lives_k)
    city0, tag0 = n_person, n_person + n_city
    nodes = {
        "Person": {"_id": np.arange(n_person, dtype=np.int64),
                   "name": [f"p{i}" for i in range(n_person)],
                   "age": ages.astype(np.int64)},
        "City": {"_id": np.arange(city0, city0 + n_city, dtype=np.int64),
                 "name": [f"c{i}" for i in range(n_city)]},
        "Tag": {"_id": np.arange(tag0, tag0 + n_tag, dtype=np.int64),
                "name": [f"t{i}" for i in range(n_tag)]},
    }
    persons = np.arange(n_person)
    rels = _rels({
        "KNOWS": (src, tgt),
        "LIVES_IN": (np.repeat(persons, lives_k), city0 + lives),
        "HAS_INTEREST": (np.repeat(persons, interest_k), tag0 + tags),
    }, first_id=tag0 + n_tag)
    return nodes, rels


def cyclic_graph(n: int, degree: int, seed: int = 17
                 ) -> Tuple[Arrays, Arrays]:
    """(nodes, rels) of the cyclic configuration: ``n`` :Person {name}
    and ``n * degree`` uniform :KNOWS edges drawn as the benchmark draws
    them (``RandomState(seed)``; sources, then targets)."""
    rng = np.random.RandomState(seed)
    m = n * degree
    src = rng.randint(0, n, m)
    dst = rng.randint(0, n, m)
    nodes = {"Person": {"_id": np.arange(n, dtype=np.int64),
                        "name": [f"p{i}" for i in range(n)]}}
    return nodes, _rels({"KNOWS": (src, dst)}, first_id=n)
