"""Negative node ids through the count pushdown and the multiway join.

Both packages sized the dense id domain from the largest live id alone,
so a graph with negative ids raised (``hop_dense`` indexing at -180) or
answered wrong (a triangle count of 0, a listing that lost every row
through a negative id).  The port now takes the smallest live id along
with the largest and refuses a negative one as it refuses an oversized
domain: the fused closures return None, the eager paths raise
``_Unsuitable`` (``fallback-join`` / ``fallback-cascade``), folded into
the same consumed size so an exact replay still reads nothing.

Every answer is held against the JAX package's ``LocalCypherSession``
(its device backend has the same fault, so it is no oracle here), the
port's own pure-Python oracle (``local_session(backend="local")``) and
the port's join cascade (``use_count_pushdown=False, use_wcoj=False``).
The graphs: 60 ``:P {k: i % 7}`` nodes and 300 uniform ``:K`` edge draws
over them (numpy ``RandomState(4)``, self-loops dropped), once with the
ids -180, -177, ..., -3 and once with the mixed ids -5, -1, 0, 2, 4,
..., 114."""
import numpy as np
import pytest

import caps_tpu
import caps_tpu_torch
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.testing.factory import create_graph
from caps_tpu_torch.testing.faults import flaky_ingest
from test_torch_algo import port_make_graph
from util import make_graph

IDS = {"negative": [-180 + 3 * i for i in range(60)],
       "mixed": [-5, -1, 0] + list(range(2, 115, 2)),
       "positive": [3 * i for i in range(60)]}

QUERIES = {
    "hop1": "MATCH (a:P)-[:K]->(b) WHERE a.k = 2 RETURN count(*) AS c",
    "hop2": "MATCH (a:P)-[:K]->(b)-[:K]->(c) WHERE a.k = 2 "
            "RETURN count(*) AS c",
    "hop2_all": "MATCH (a:P)-[:K]->(b)-[:K]->(c) RETURN count(*) AS c",
    "varlen": "MATCH (a:P)-[:K*1..2]->(b) WHERE a.k = 3 "
              "RETURN count(*) AS c",
    "triangle": "MATCH (a:P)-[:K]->(b:P)-[:K]->(c:P)-[:K]->(a) "
                "RETURN count(*) AS c",
    "triangle_rows": "MATCH (a:P)-[:K]->(b:P)-[:K]->(c:P)-[:K]->(a) "
                     "RETURN id(a) AS a, id(b) AS b, id(c) AS c, "
                     "a.k AS k ORDER BY a, b, c",
}

#: the operator each query plans to, and its strategy on a graph with a
#: negative id (positive ids keep the fast paths)
PLANNED = {"hop1": ("CountPattern", "fallback-join", "fused-spmv"),
           "hop2": ("CountPattern", "fallback-join", "fused-spmv"),
           "hop2_all": ("CountPattern", "fallback-join", "fused-spmv"),
           "varlen": ("CountPattern", "fallback-join", "fused-spmv"),
           "triangle": ("CountCycle", "fallback-join", "cycle-probe"),
           "triangle_rows": ("MultiwayJoin", "fallback-cascade", "wcoj")}


def arrays(ids):
    rng = np.random.RandomState(4)
    pairs = rng.randint(0, 60, size=(300, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    nodes = {("P",): [{"_id": int(ids[i]), "k": i % 7} for i in range(60)]}
    rels = {"K": [(int(ids[a]), int(ids[b]), {}) for a, b in pairs]}
    return nodes, rels


@pytest.fixture(scope="module", params=sorted(IDS))
def engines(request):
    nodes, rels = arrays(IDS[request.param])
    local = make_graph(caps_tpu.local_session(backend="local"), nodes, rels)
    port = port_make_graph(caps_tpu_torch.local_session(device="cpu"),
                           nodes, rels)
    cascade = port_make_graph(caps_tpu_torch.local_session(
        device="cpu", config=EngineConfig(use_count_pushdown=False,
                                          use_wcoj=False)), nodes, rels)
    own = port_make_graph(caps_tpu_torch.local_session(backend="local"),
                          nodes, rels)
    return request.param, local, port, cascade, own


def strategy(result, op):
    for m in result.metrics["operators"]:
        if m["op"] == op:
            return m.get("strategy")
    return None


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_answers_equal_the_local_oracle_and_the_cascade(engines, name):
    ids, local, port, cascade, own = engines
    q = QUERIES[name]
    want = local.cypher(q).records.to_maps()
    assert want and (name != "triangle_rows" or len(want) == 96)
    assert cascade.cypher(q).records.to_maps() == want
    assert own.cypher(q).records.to_maps() == want
    op, refused, fast = PLANNED[name]
    for run in ("record", "replay"):
        res = port.cypher(q)
        assert res.records.to_maps() == want, (name, run)
        assert strategy(res, op) == (fast if ids == "positive"
                                     else refused), (name, run)


@pytest.mark.parametrize("ids", ["negative", "mixed"])
def test_the_reported_counts(ids):
    """The figures of the fault's report: the filtered 1-hop count is
    49 and the triangle count 96 on both graphs."""
    port = port_make_graph(caps_tpu_torch.local_session(device="cpu"),
                           *arrays(IDS[ids]))
    assert port.cypher(QUERIES["hop1"]).records.to_maps() == [{"c": 49}]
    assert port.cypher(QUERIES["triangle"]).records.to_maps() == [{"c": 96}]
    rows = port.cypher(QUERIES["triangle_rows"]).records.to_maps()
    # the listing keeps the rows through negative ids
    assert len(rows) == 96 and min(r["a"] for r in rows) < 0


@pytest.mark.parametrize("name", ["hop1", "hop2", "triangle",
                                  "triangle_rows"])
def test_exact_replays_read_no_size(name):
    """The sign test rides the consumed size it joined: an exact replay
    on the positive graph (fast paths) and on the negative graph (the
    refusal, then the join fallback) still reads 0 sizes."""
    for ids in ("positive", "negative"):
        nodes, rels = arrays(IDS[ids])
        s = caps_tpu_torch.local_session(device="cpu")
        g = port_make_graph(s, nodes, rels)
        first = g.cypher(QUERIES[name])
        again = g.cypher(QUERIES[name])
        assert s.fused.last_mode == "replay", (ids, name)
        assert again.metrics["size_syncs"] == 0, (ids, name)
        assert again.records.to_maps() == first.records.to_maps()


# -- flaky_ingest (testing/faults.py) -----------------------------------------

SOCIAL = """
    CREATE (a:Person {name: 'Alice', age: 33}),
           (b:Person {name: 'Bob', age: 44}),
           (c:Person {name: 'Carol', age: 27}),
           (d:Person {name: 'Dana', age: 51}),
           (a)-[:KNOWS {since: 2011}]->(b),
           (b)-[:KNOWS {since: 2015}]->(c),
           (a)-[:KNOWS {since: 2019}]->(c),
           (c)-[:KNOWS {since: 2021}]->(d)
"""
Q_COUNT = ("MATCH (a:Person)-[k:KNOWS]->(b) WHERE k.since >= $y "
           "RETURN count(*) AS c")


def test_flaky_ingest_rolls_back_string_pool():
    """The counterpart of ``tests/test_faults.py``'s test: a failed
    ingest leaves no pool growth behind (the pool's size decides the
    dense group-by path and the fused executor's replayability), and the
    retried ingest succeeds once the budget is spent."""
    session = caps_tpu_torch.local_session(device="cpu")
    pool_before = len(session.backend.pool)
    with flaky_ingest(session, n_times=1) as budget:
        with pytest.raises(Exception) as ex:
            create_graph(session, SOCIAL)
        assert "out of memory" in str(ex.value)
        assert budget.injected == 1
        assert len(session.backend.pool) == pool_before
        graph = create_graph(session, SOCIAL)
    assert graph.cypher(Q_COUNT, {"y": 2015}).records.to_maps() == [{"c": 3}]


def test_flaky_ingest_needs_a_device_backed_session():
    with pytest.raises(ValueError, match="device-backed"):
        with flaky_ingest(object()):
            pass
