"""Worst-case-optimal multiway joins of the port (ops/wcoj.py,
relational/wcoj.py) against the JAX package.

The primitives run on the same sorted structures in both packages and
are compared element for element (the JAX side on its jnp reference of
the expand kernel).  Every cyclic query of ``tests/test_wcoj.py`` runs
on the same seeded graph (self-loops, parallel edges, two relationship
types) in a CPU session of the port and in the JAX package's device
backend, both with their default configuration, and must give the same
bag of rows as the JAX package and as the port's own cascade
(``use_wcoj=False``).  Planning, the domain guard, the refusal to hide a
fault behind the cascade, and sync-free exact replays follow.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caps_tpu_torch
from caps_tpu.backends.tpu import kernels as JK
from caps_tpu.backends.tpu.session import TPUCypherSession
from caps_tpu.ops import wcoj as JW
from caps_tpu_torch.backends.cuda import kernels as K
from caps_tpu_torch.interop import graph_from_numpy
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.ops import wcoj as W
from caps_tpu_torch.relational import wcoj as RW
from tests.test_torch_count_pushdown import jax_graph


def random_graph(n=40, e=200, seed=7, self_loops=True):
    """``tests/test_wcoj.py _random_graph`` as arrays: :P {name}, :K
    edges with self-loops and 12 parallel copies, :L every third K edge;
    relationship ids from 1000 in that order."""
    rng = np.random.RandomState(seed)
    edges = [(int(rng.randint(n)), int(rng.randint(n))) for _ in range(e)]
    if not self_loops:
        edges = [(a, b) for a, b in edges if a != b]
    edges += edges[:12]
    k = np.asarray(edges, dtype=np.int64)
    l_ = k[::3]
    nodes = {"P": {"_id": np.arange(n, dtype=np.int64),
                   "name": [f"n{i % 11}" for i in range(n)]}}
    rels = {"K": {"_id": np.arange(1000, 1000 + len(k), dtype=np.int64),
                  "_src": k[:, 0].copy(), "_tgt": k[:, 1].copy()},
            "L": {"_id": np.arange(1000 + len(k), 1000 + len(k) + len(l_),
                                   dtype=np.int64),
                  "_src": l_[:, 0].copy(), "_tgt": l_[:, 1].copy()}}
    return nodes, rels


def port_graph(config=None, **kw):
    session = caps_tpu_torch.local_session(device="cpu", config=config)
    return graph_from_numpy(session, *random_graph(**kw))


@pytest.fixture(scope="module")
def graphs():
    """(port, JAX, port cascade) graphs over the same arrays."""
    ref = jax_graph(TPUCypherSession(), *random_graph())
    return (port_graph(), ref,
            port_graph(EngineConfig(use_wcoj=False)))


def bag(result):
    return sorted(repr(sorted(r.items())) for r in result.records.to_maps())


def ops(result):
    return [m["op"] for m in result.metrics["operators"]]


def wcoj_strategy(result):
    return [m.get("strategy") for m in result.metrics["operators"]
            if m["op"] == "MultiwayJoin"]


TRIANGLE_ENUM = ("MATCH (a:P)-[r1:K]->(b)-[r2:K]->(c), (a)-[r3:K]->(c) "
                 "RETURN id(a) AS x, id(b) AS y, id(c) AS z")

CYCLIC_QUERIES = [
    TRIANGLE_ENUM,
    # closing edge written in the reverse orientation
    "MATCH (a:P)-[r1:K]->(b)-[r2:K]->(c), (c)-[r3:K]->(a) "
    "RETURN id(a) AS x, id(b) AS y, id(c) AS z",
    # closing edge as an incoming mention on a
    "MATCH (a:P)-[r1:K]->(b)-[r2:K]->(c), (a)<-[r3:K]-(c) "
    "RETURN id(a) AS x, id(b) AS y, id(c) AS z",
    # mixed rel types + mixed chain directions
    "MATCH (a:P)-[r1:K]->(b)<-[r2:L]-(c), (a)-[r3:K]->(c) "
    "RETURN id(b) AS x, id(c) AS y",
    # diamond: two 2-hop paths meeting (one closing edge)
    "MATCH (a:P)-[r1:K]->(b)-[r2:K]->(d), (a)-[r3:K]->(c)-[r4:K]->(d) "
    "RETURN id(a) AS w, id(b) AS x, id(c) AS y, id(d) AS z",
    # 4-cycle
    "MATCH (a:P)-[r1:K]->(b)-[r2:K]->(c)-[r3:K]->(d), (d)-[r4:K]->(a) "
    "RETURN id(a) AS w, id(b) AS x, id(c) AS y, id(d) AS z",
    # predicates on multiple pattern vars
    "MATCH (a:P)-[r1:K]->(b)-[r2:K]->(c), (a)-[r3:K]->(c) "
    "WHERE a.name = 'n3' AND c.name = 'n5' RETURN id(b) AS x, id(c) AS y",
    # full entity materialization through the gather path
    "MATCH (a:P)-[r1:K]->(b)-[r2:K]->(c), (a)-[r3:L]->(c) RETURN a, r3, c",
    # cyclic count without the count-pushdown triangle shape (diamond):
    # the aggregate rides the MultiwayJoin output
    "MATCH (a:P)-[r1:K]->(b)-[r2:K]->(d), (a)-[r3:K]->(c)-[r4:K]->(d) "
    "RETURN count(*) AS c",
]


# -- primitives --------------------------------------------------------------


def _sorted_both(frm, to, ok, n):
    """The sorted edge structure in each package, from the same arrays."""
    keys = W.edge_keys(torch.from_numpy(frm), torch.from_numpy(to),
                       torch.from_numpy(ok), n)
    ks, perm = W.sorted_edges(torch.from_numpy(frm), torch.from_numpy(to),
                              torch.from_numpy(ok), n,
                              lambda k: K.sort_perm(k, keys.shape[0]))
    jkeys = JW.edge_keys(jnp.asarray(frm), jnp.asarray(to), jnp.asarray(ok),
                         jnp.int64(n))
    jperm = JK.sort_perm([jkeys], jkeys.shape[0])
    return (ks, perm), (jkeys[jperm], jperm)


def same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        assert (g.astype(np.int64) == w.astype(np.int64)).all(), (g, w)


def test_probe_adj_counts_and_order():
    n = 8
    frm = np.array([0, 0, 0, 5, 5, 1, 2, 0], np.int64)
    to = np.array([3, 1, 3, 7, 0, 6, 2, 4], np.int64)
    ok = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)  # last edge dead
    (ks, perm), (jks, jperm) = _sorted_both(frm, to, ok, n)
    same((ks, perm), (jks, jperm))
    u = np.arange(n, dtype=np.int64)
    valid = np.array([1, 1, 1, 1, 0, 1, 1, 1], bool)
    got = W.probe_adj(ks, torch.from_numpy(u), torch.from_numpy(valid), n)
    want = JW.probe_adj(jks, jnp.asarray(u), jnp.asarray(valid),
                        jnp.int64(n))
    same(got, want)
    counts, lo = got
    # neighbours of 0 in sorted order: 1, 3, 3 (duplicate edge kept)
    assert list((ks[int(lo[0]):int(lo[0]) + int(counts[0])] % n).tolist()) \
        == [1, 3, 3]


def test_probe_pair_and_probe_id():
    n = 4
    frm = np.array([1, 1, 1, 2], np.int64)
    to = np.array([2, 2, 3, 0], np.int64)
    u = np.array([1, 1, 2, 3, -1], np.int64)
    v = np.array([2, 3, 0, 3, 2], np.int64)
    valid = np.ones(5, bool)
    for ok in (np.ones(4, bool), np.zeros(4, bool)):
        (ks, _), (jks, _) = _sorted_both(frm, to, ok, n)
        got = W.probe_pair(ks, torch.from_numpy(u), torch.from_numpy(v),
                           torch.from_numpy(valid), n)
        same(got, JW.probe_pair(jks, jnp.asarray(u), jnp.asarray(v),
                                jnp.asarray(valid), jnp.int64(n)))
    assert got[0].tolist() == [0, 0, 0, 0, 0]   # fully masked edges
    ids = np.array([5, 2, 9, 2, -1, 7], np.int64)
    ids_ok = np.array([1, 1, 1, 0, 1, 1], bool)
    keys = W.sorted_ids(torch.from_numpy(ids), torch.from_numpy(ids_ok))
    jkeys = JW.sorted_ids(jnp.asarray(ids), jnp.asarray(ids_ok))
    same(keys, jkeys)
    ids_sorted = keys[K.sort_perm([keys], keys.shape[0])]
    jids_sorted = jkeys[JK.sort_perm([jkeys], jkeys.shape[0])]
    cand = np.array([2, 5, 3, 7, 9, -1, 2], np.int64)
    cok = np.array([1, 1, 1, 1, 0, 1, 1], bool)
    got = W.probe_id(ids_sorted, torch.from_numpy(cand),
                     torch.from_numpy(cok))
    same(got, JW.probe_id(jids_sorted, jnp.asarray(cand), jnp.asarray(cok)))
    assert got[0].tolist() == [1, 1, 0, 1, 0, 0, 1]


@pytest.mark.parametrize("out_cap", [256, 512, 300],
                         ids=["tile256", "tile512", "odd-cap"])
def test_extend_matches_jax(out_cap):
    """One output slot per (frontier row, incident edge), duplicates
    included, with the exact live prefix — slot for slot the JAX
    package's."""
    n = 6
    frm = np.array([0, 0, 2, 2, 2, 4], np.int64)
    to = np.array([1, 1, 3, 5, 3, 0], np.int64)
    (ks, perm), (jks, jperm) = _sorted_both(frm, to, np.ones(6, bool), n)
    u = np.array([0, 2, 3], np.int64)
    valid = np.array([1, 1, 1], bool)
    got = W.extend(ks, perm, torch.from_numpy(u), torch.from_numpy(valid),
                   n, out_cap)
    want = JW.extend(jks, jperm, jnp.asarray(u), jnp.asarray(valid), n,
                     out_cap)
    same(got, want)
    l_idx, cand, erow, ok = got
    assert sorted((int(a), int(c)) for a, c, o in zip(l_idx, cand, ok)
                  if o) == [(0, 1), (0, 1), (1, 3), (1, 3), (1, 5)]
    assert sorted(int(r) for r, o in zip(erow, ok) if o) == [0, 1, 2, 3, 4]
    assert ok[:5].all() and int(ok.sum()) == 5


def test_close_matches_jax():
    n = 4
    frm = np.array([1, 1, 3], np.int64)
    to = np.array([2, 2, 0], np.int64)
    (ks, perm), (jks, jperm) = _sorted_both(frm, to, np.ones(3, bool), n)
    u = np.array([1, 3, 0], np.int64)
    v = np.array([2, 0, 1], np.int64)
    got = W.close(ks, perm, torch.from_numpy(u), torch.from_numpy(v),
                  torch.ones(3, dtype=torch.bool), n, 256)
    want = JW.close(jks, jperm, jnp.asarray(u), jnp.asarray(v),
                    jnp.ones(3, bool), n, 256)
    same(got, want)
    l_idx, erow, ok = got
    # row 0 closes twice (parallel edges 0 and 1), row 1 once, row 2 never
    assert sorted((int(a), int(r)) for a, r, o in zip(l_idx, erow, ok)
                  if o) == [(0, 0), (0, 1), (1, 2)]
    assert int(W.adj_total(torch.tensor([2, 1, 0]))) == 3


# -- enumeration -------------------------------------------------------------


@pytest.mark.parametrize("query", CYCLIC_QUERIES)
def test_enumeration_matches_jax_and_cascade(graphs, query):
    """Exact bags three ways: the port's WCOJ, the JAX package's default
    session, the port's forced cascade; the same plan decision and
    operators as the JAX package."""
    port_g, jax_g, cascade_g = graphs
    got, want = port_g.cypher(query), jax_g.cypher(query)
    assert "MultiwayJoin" in ops(got), got.plans["relational"]
    assert wcoj_strategy(got) == ["wcoj"]
    assert [(m["op"], m.get("strategy"), m.get("est_rows"))
            for m in got.metrics["operators"]] == \
        [(m["op"], m.get("strategy"), m.get("est_rows"))
         for m in want.metrics["operators"]]
    assert got.plans["cost"] == want.plans["cost"]
    assert bag(got) == bag(want)
    cascade = cascade_g.cypher(query)
    assert "MultiwayJoin" not in ops(cascade)
    assert bag(cascade) == bag(want)


# -- planning ----------------------------------------------------------------


def test_param_rebinding_through_plan_cache(graphs):
    port_g, jax_g, _ = graphs
    q = ("MATCH (a:P)-[r1:K]->(b)-[r2:K]->(c), (a)-[r3:K]->(c) "
         "WHERE a.name = $seed RETURN id(b) AS x, id(c) AS y")
    hits0 = port_g._session.plan_cache.stats()["hits"]
    for seed in ("n1", "n4", "n1", "n9"):
        got = port_g.cypher(q, {"seed": seed})
        assert wcoj_strategy(got) == ["wcoj"]
        assert bag(got) == bag(jax_g.cypher(q, {"seed": seed})), seed
    assert port_g._session.plan_cache.stats()["hits"] >= hits0 + 2


def test_uniqueness_pairs_absorbed_same_type(graphs):
    port_g, jax_g, _ = graphs
    q = ("MATCH (a:P)-[r1:K]->(b)-[r2:K]->(c), (a)-[r3:K]->(c) "
         "RETURN id(r1) AS x, id(r2) AS y, id(r3) AS z")
    got = port_g.cypher(q)
    assert "MultiwayJoin" in ops(got)
    assert bag(got) == bag(jax_g.cypher(q))
    assert all(len({r["x"], r["y"], r["z"]}) == 3
               for r in got.records.to_maps())


def test_multi_closing_pattern_substitutes_once():
    q = ("MATCH (a:P)-[r1:K]->(b)-[r2:K]->(c), (a)-[r3:K]->(c), "
         "(b)-[r4:L]->(c) RETURN id(a) AS x, id(b) AS y, id(c) AS z")
    g = port_graph()
    jax_g = jax_graph(TPUCypherSession(), *random_graph())
    snap = g._session.metrics_snapshot
    sub0 = snap().get("wcoj.substituted", 0)
    exp = g.cypher("EXPLAIN " + q)
    assert exp.plans["relational"].count("MultiwayJoin") == 1, \
        exp.plans["relational"]
    assert exp.plans["cost"].count("wcoj_strategy") == 1
    assert snap()["wcoj.substituted"] == sub0 + 1
    assert exp.plans["relational"] == \
        jax_g.cypher("EXPLAIN " + q).plans["relational"]
    res = g.cypher(q)
    assert bag(res) == bag(jax_g.cypher(q))
    assert wcoj_strategy(res) == ["wcoj"]


def test_explain_renders_wcoj_choice_before_execution(graphs):
    port_g, jax_g, _ = graphs
    exp = port_g.cypher("EXPLAIN " + TRIANGLE_ENUM)
    assert exp.records is None
    assert "MultiwayJoin" in exp.plans["relational"]
    assert "strategy=unplanned" in exp.plans["relational"]
    assert "anchors=" in exp.plans["relational"]
    for word in ("wcoj_strategy", "wcoj_cost", "cascade_cost"):
        assert word in exp.plans["cost"]
    want = jax_g.cypher("EXPLAIN " + TRIANGLE_ENUM).plans
    assert exp.plans["relational"] == want["relational"]
    assert exp.plans["cost"] == want["cost"]


def test_use_wcoj_off_is_the_cascade_everywhere(graphs):
    exp = graphs[2].cypher("EXPLAIN " + TRIANGLE_ENUM)
    assert "MultiwayJoin" not in exp.plans["relational"]
    assert "Join" in exp.plans["relational"]


def test_model_off_still_substitutes(graphs):
    g = port_graph(EngineConfig(use_cost_model=False))
    res = g.cypher(TRIANGLE_ENUM)
    assert "MultiwayJoin" in ops(res)
    assert "~rows=" not in res.plans["relational"]
    assert bag(res) == bag(graphs[1].cypher(TRIANGLE_ENUM))


def test_est_rows_feed_op_stats():
    g = port_graph()
    res = g.cypher(TRIANGLE_ENUM)
    entry = [m for m in res.metrics["operators"]
             if m["op"] == "MultiwayJoin"][0]
    assert "est_rows" in entry and entry["rows"] >= 0
    from caps_tpu_torch.frontend.parser import normalize_query
    fam = g._session.op_stats.stats(normalize_query(TRIANGLE_ENUM))
    keys = [k for k in fam if k.endswith(":MultiwayJoin")]
    assert keys, fam
    assert fam[keys[0]].get("est_rows") is not None


def _segment(close_type="K"):
    from caps_tpu_torch.ir.pattern import Direction
    from caps_tpu_torch.logical import ops as L
    from caps_tpu_torch.logical.optimizer import match_cyclic_segment
    scan = L.NodeScan(L.Start(), "a", frozenset({"P"}),
                      fields=(("a", None),))
    e1 = L.Expand(scan, "a", "r1", ("K",), "b", frozenset(),
                  Direction.OUTGOING, fields=())
    e2 = L.Expand(e1, "b", "r2", ("K",), "c", frozenset(),
                  Direction.OUTGOING, fields=())
    e3 = L.Expand(e2, "a", "r3", (close_type,), "c", frozenset(),
                  Direction.OUTGOING, into=True, fields=())
    return match_cyclic_segment(e3)


def test_plan_steps_anchor_choice():
    """Without a model the introducing edge anchors and the deferred
    closing edge semi-filters and closes; with a model the lower
    expected degree anchors."""
    seg = _segment()
    assert seg is not None and seg.order == ("a", "b", "c")
    extends, closes = RW.plan_steps(seg, model=None)
    assert [s.var for s in extends] == ["b", "c"]
    assert extends[1].anchor.rel == "r2"
    assert [c.rel_types for c in extends[1].checks] == [("K",)]
    assert [c.edge.rel for c in closes] == ["r3"]

    class Model:   # an L hop expands less than a K hop
        def degree(self, rel_types, direction):
            return 1.0 if rel_types == ("L",) else 5.0

    extends, closes = RW.plan_steps(_segment("L"), model=Model())
    assert extends[1].anchor.rel == "r3" and extends[1].forward
    assert [c.rel for c in extends[1].checks] == ["r2"]
    assert [c.edge.rel for c in closes] == ["r2"]


# -- the domain guard, faults, replays ---------------------------------------


def test_domain_guard_falls_back_to_the_cascade(graphs, monkeypatch):
    monkeypatch.setattr(RW, "_MAX_DOMAIN", 8)
    g = port_graph()
    res = g.cypher(TRIANGLE_ENUM)
    assert wcoj_strategy(res) == ["fallback-cascade"]
    assert g._session.metrics_snapshot()["wcoj.fallbacks"] == 1
    assert bag(res) == bag(graphs[1].cypher(TRIANGLE_ENUM))


def test_a_fault_raises_and_is_not_answered_by_the_cascade(monkeypatch):
    """Only an unsuitable input falls back: an error of the WCOJ path
    itself (here an extend step that raises) reaches the caller."""
    def broken(*args, **kwargs):
        raise RuntimeError("injected extend fault")

    monkeypatch.setattr(W, "extend", broken)
    g = port_graph()
    with pytest.raises(RuntimeError, match="injected extend fault"):
        g.cypher(TRIANGLE_ENUM)
    assert g._session.metrics_snapshot().get("wcoj.fallbacks", 0) == 0


def test_exact_replay_reads_no_size(graphs):
    g = port_graph()
    q = ("MATCH (a:P)-[r1:K]->(b)-[r2:K]->(c), (a)-[r3:K]->(c) "
         "WHERE a.name = $seed RETURN id(a) AS x, id(b) AS y, id(c) AS z")
    first = g.cypher(q, {"seed": "n3"})
    assert g._session.fused.last_mode == "record"
    assert first.metrics["size_syncs"] > 0
    for _ in range(2):
        again = g.cypher(q, {"seed": "n3"})
        assert g._session.fused.last_mode == "replay"
        assert again.metrics["size_syncs"] == 0
        assert wcoj_strategy(again) == ["wcoj"]
        assert bag(again) == bag(first)
    assert bag(first) == bag(graphs[1].cypher(q, {"seed": "n3"}))


def test_wcoj_charges_compile_kind_once_then_zero():
    """As ``tests/test_wcoj.py``'s compile case: the first execution
    charges the ``wcoj`` kind for its first-seen step shapes, a fused
    replay charges nothing, and a second graph of the same shape
    buckets charges no new ``wcoj`` shape."""
    s = caps_tpu_torch.local_session(device="cpu")
    g = graph_from_numpy(s, *random_graph())
    r1 = g.cypher(TRIANGLE_ENUM)
    kinds1 = {c["kind"] for c in r1.metrics.get("compile_charges", ())}
    assert "wcoj" in kinds1
    replays0 = s.fused.replays + s.fused.generic_replays
    r2 = g.cypher(TRIANGLE_ENUM)
    assert r2.metrics["compile_s_charged"] == 0.0
    assert s.fused.replays + s.fused.generic_replays == replays0 + 1
    g2 = graph_from_numpy(s, *random_graph(seed=9))
    r3 = g2.cypher(TRIANGLE_ENUM)
    assert [c for c in r3.metrics.get("compile_charges", ())
            if c["kind"] == "wcoj"] == []
