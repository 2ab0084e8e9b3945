"""The result cache's second level (``caps_tpu_torch/relational/
result_cache.py``): scan→filter prefixes memoized on the device and
reused across plan families, held to the JAX package's
``caps_tpu/relational/result_cache.py`` on the CPU.

The same CREATE text goes through the JAX package's ``backend="tpu"``
and ``backend="local"`` sessions and the port's ``device="cpu"`` and
``backend="local"`` sessions, each with a ``ResultCache`` attached.
Covered here:

* the six-run sequence of two families over one prefix: rows, operators,
  ``subplan_*`` counts, fused modes and mismatch counts equal the JAX
  package's run by run (the second run replays a recording made without
  the seeded prefix, diverges, and re-records through the audit);
* the reference's own subplan tests, on both of the port's backends;
* a memo shared by reference is never written: families over a
  computed column, an ORDER BY, a list column and a held map, run in
  turn, leave the memo's tensors bit-for-bit as stored;
* ``shrink_and_reshard`` on a ``(4,)`` mesh drops every memo, and the
  next run misses and answers right;
* a commit on a ``VersionedGraph`` retires the superseded version's
  memos (and the next read sees the write), ``evict_family`` drops every
  memo, and the byte budget holds over a soak of 20 prefixes.
"""
from __future__ import annotations

import pytest
import torch

import caps_tpu
import caps_tpu_torch
from caps_tpu.relational.result_cache import ResultCache as JaxResultCache
from caps_tpu.relational.result_cache import (
    ResultCacheConfig as JaxResultCacheConfig)
from caps_tpu.testing.factory import create_graph as jax_create_graph
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.relational.result_cache import (ResultCache,
                                                    ResultCacheConfig,
                                                    result_scope)
from caps_tpu_torch.relational.updates import versioned
from caps_tpu_torch.testing.bag import Bag
from caps_tpu_torch.testing.factory import create_graph

SOCIAL = """
    CREATE (a:Person {name: 'Alice', age: 33, tags: ['x', 'y']}),
           (b:Person {name: 'Bob', age: 44, tags: ['z']}),
           (c:Person {name: 'Carol', age: 27, tags: []}),
           (d:Person {name: 'Dana', age: 51, tags: ['w', 'v', 'u']}),
           (a)-[:KNOWS {since: 2011}]->(b),
           (b)-[:KNOWS {since: 2015}]->(c),
           (a)-[:KNOWS {since: 2019}]->(c),
           (c)-[:KNOWS {since: 2021}]->(d)
"""

Q = "MATCH (p:Person) WHERE p.age > 30 RETURN p.name AS n ORDER BY n"
Q2 = "MATCH (p:Person) WHERE p.age > 30 RETURN count(*) AS c"
SIX = (Q, Q, Q, Q2, Q, Q2)

#: families over the prefix ``Filter(p.age > 30, Scan(p))`` whose outputs
#: would show a write through the shared memo: a computed column and a
#: map, an ORDER BY over a computed key, a list column grown by ``+``, a
#: map or a list held among values of other types, and a one-hop join
MUTATION_FAMILIES = (
    "MATCH (p:Person) WHERE p.age > 30 RETURN p.name AS n, "
    "p.age * 2 + 1 AS x, p.tags AS t, {k: p.age, n: p.name} AS m "
    "ORDER BY n",
    "MATCH (p:Person) WHERE p.age > 30 WITH p, p.age + 100 AS y "
    "ORDER BY y DESC RETURN p.name AS n, y, p.tags + ['z'] AS t2, "
    "CASE WHEN p.age > 40 THEN {a: p.age} ELSE [p.name] END AS h",
    "MATCH (p:Person) WHERE p.age > 30 MATCH (p)-[k:KNOWS]->(q) "
    "RETURN p.name AS a, q.name AS b, k.since AS s ORDER BY a, b",
)

ENGINES = ("jax_tpu", "jax_local", "cuda", "local")


def _engine(name, config=None):
    """(session, graph, cache) of one engine over SOCIAL."""
    if name.startswith("jax_"):
        s = caps_tpu.local_session(backend=name[4:])
        rc = JaxResultCache(JaxResultCacheConfig(),
                            registry=s.metrics_registry)
        s.result_cache = rc
        return s, jax_create_graph(s, SOCIAL), rc
    if name == "cuda":
        s = caps_tpu_torch.local_session(device="cpu", config=config)
    else:
        s = caps_tpu_torch.local_session(backend="local")
    rc = ResultCache(ResultCacheConfig(), registry=s.metrics_registry)
    s.result_cache = rc
    return s, create_graph(s, SOCIAL), rc


def _runs(name):
    s, g, rc = _engine(name)
    out = []
    for q in SIX:
        r = g.cypher(q)
        st = rc.stats()
        fused = getattr(s, "fused", None)
        out.append({
            "rows": r.records.to_maps(),
            "ops": [m["op"] for m in r.metrics["operators"]],
            "subplan": (st["subplan_hits"], st["subplan_misses"],
                        st["subplan_entries"]),
            "fused": (None if fused is None
                      else (fused.last_mode, fused.mismatches)),
            "size_syncs": r.metrics.get("size_syncs"),
        })
    return out, s


@pytest.fixture(scope="module")
def six():
    return {name: _runs(name) for name in ENGINES}


@pytest.mark.parametrize("port", ["cuda", "local"])
def test_six_runs_give_the_reference_rows(six, port):
    want = [r["rows"] for r in six["jax_tpu"][0]]
    assert [r["rows"] for r in six[port][0]] == want
    assert want[0] == [{"n": "Alice"}, {"n": "Bob"}, {"n": "Dana"}]
    assert want[3] == [{"c": 3}]


@pytest.mark.parametrize("port,ref", [("cuda", "jax_tpu"),
                                      ("local", "jax_local")])
def test_six_runs_match_the_reference_run_by_run(six, port, ref):
    """Operators, subplan counts, fused modes and mismatches equal the
    JAX package's in every run."""
    for key in ("ops", "subplan", "fused"):
        assert [r[key] for r in six[port][0]] \
            == [r[key] for r in six[ref][0]], key


def test_six_runs_reaudit_once_on_the_seeded_replay(six):
    """Run 1 records with the filter's size in its stream; run 2 seeds
    the stored prefix, so its replay diverges and re-records (two hits),
    and from then on every run replays or records with no size read."""
    runs, session = six["cuda"]
    assert [r["fused"] for r in runs] == [
        ("record", 0), ("record", 1), ("replay", 1), ("record", 1),
        ("replay", 1), ("replay", 1)]
    assert [r["subplan"] for r in runs] == [
        (0, 1, 1), (2, 1, 1), (3, 1, 1), (4, 1, 1), (5, 1, 1), (6, 1, 1)]
    assert runs[0]["ops"] == ["Scan", "Filter", "Project", "Select",
                              "OrderBy"]
    assert runs[1]["ops"] == ["Project", "Select", "OrderBy"]
    assert runs[3]["ops"] == ["Aggregate"]
    assert [r["size_syncs"] for r in runs[1:]] == [0] * 5
    assert [r["size_syncs"] for r in six["jax_tpu"][0][1:]] == [0] * 5
    snap = session.metrics_snapshot()
    assert snap["fused.mismatches"] == 1
    assert snap["rescache.subplan_hits"] == 6
    assert snap["rescache.subplan_insertions"] == 1
    # the seeded set is an entry of the recorded stream: a replay that
    # seeds another set diverges at it, before an operator reads a size
    streams = [rec for _pool, rec, _deps in session.fused._memo.values()]
    seeds = [e for rec in streams for e in rec if e[0] == "seeds"]
    assert len(seeds) == 2 and all(e[1].isdigit() for e in seeds)


# -- the reference's subplan tests (tests/test_result_cache.py) -------------

@pytest.mark.parametrize("backend", ["cuda", "local"])
def test_subplan_prefix_reused_across_two_plan_families(backend):
    session, graph, rc = _engine(backend)
    r1 = graph.cypher("MATCH (p:Person) RETURN count(*) AS c")
    assert r1.records.to_maps() == [{"c": 4}]
    assert rc.stats()["subplan_entries"] >= 1  # the Scan prefix parked
    # a DIFFERENT plan family sharing the scan prefix: its op metrics
    # must show the prefix never re-executed
    hits0 = rc.stats()["subplan_hits"]
    r2 = graph.cypher("MATCH (p:Person) RETURN p.age AS a ORDER BY a")
    assert [r["a"] for r in r2.records.to_maps()] == [27, 33, 44, 51]
    assert rc.stats()["subplan_hits"] == hits0 + 1
    ops_run = [m["op"] for m in r2.metrics["operators"]]
    assert not any(o.startswith("Scan") for o in ops_run), ops_run


@pytest.mark.parametrize("backend", ["cuda", "local"])
def test_parameterized_filter_prefix_is_not_memoized(backend):
    session, graph, rc = _engine(backend)
    q = "MATCH (p:Person) WHERE p.age > $min RETURN p.name AS n ORDER BY n"
    a = graph.cypher(q, {"min": 30}).records.to_maps()
    b = graph.cypher(q, {"min": 40}).records.to_maps()
    assert [r["n"] for r in a] == ["Alice", "Bob", "Dana"]
    assert [r["n"] for r in b] == ["Bob", "Dana"]
    # only the Scan below the $min filter is a prefix
    (key,) = rc._subplans
    assert [step[0] for step in key[2]] == ["scan"]


# -- a shared memo is never written -----------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "local"])
def test_families_over_one_memo_leave_it_untouched(backend):
    """A, B, C, A, B, C over the one memoized prefix: every answer equals
    the JAX package's, and the memo's tensors stay as stored."""
    js = caps_tpu.local_session(backend="tpu")
    jg = jax_create_graph(js, SOCIAL)
    session, graph, rc = _engine(backend)
    snapshot = None
    for q in MUTATION_FAMILIES * 2:
        assert graph.cypher(q).records.to_maps() \
            == jg.cypher(q).records.to_maps(), q
        if backend == "cuda" and snapshot is None:
            entry = next(e for e in rc._subplans.values()
                         if e.key[2][-1][0] == "filter")
            held = entry.table.held_tensors()
            snapshot = [t.clone() for t in held]
    assert rc.stats()["subplan_hits"] >= 5
    if backend == "cuda":
        assert len(held) >= 4
        assert all(torch.equal(a, b) for a, b in zip(held, snapshot))
        assert entry.mark is None  # off the card: no stream to order


# -- placement, retirement, eviction, budget ---------------------------------

def test_reshard_drops_every_memo_and_the_next_run_misses():
    # a list column has no ingest mirror to rebuild a lost slot's block
    # from (``sharded.recover``): this graph holds none
    plain = SOCIAL.replace("tags: ['x', 'y']", "tags: 1").replace(
        "tags: ['z']", "tags: 2").replace("tags: []", "tags: 3").replace(
        "tags: ['w', 'v', 'u']", "tags: 4")
    s = caps_tpu_torch.local_session(
        device="cpu", config=EngineConfig(mesh_shape=(4,)))
    rc = ResultCache(ResultCacheConfig(), registry=s.metrics_registry)
    s.result_cache = rc
    g = create_graph(s, plain)
    js = caps_tpu.local_session(backend="local")
    q = MUTATION_FAMILIES[2]
    want = jax_create_graph(js, plain).cypher(q).records.to_maps()
    s.catalog.store("g", g)
    assert g.cypher(q).records.to_maps() == want
    assert g.cypher(q).records.to_maps() == want
    hits = rc.stats()["subplan_hits"]
    assert hits >= 1 and rc.stats()["subplan_entries"] == 3
    assert all(k[3][1] is not None and len(k[3][1]) == 4
               for k in rc._subplans)
    assert s.shrink_and_reshard(
        healthy=list(s.backend.mesh.slots)[:3]) == 2
    assert rc.stats()["subplan_entries"] == 0
    assert rc.bytes == 0
    misses = rc.stats()["subplan_misses"]
    r = g.cypher(q)
    assert r.records.to_maps() == want
    assert rc.stats()["subplan_hits"] == hits
    assert rc.stats()["subplan_misses"] == misses + 3
    assert "Filter" in [m["op"] for m in r.metrics["operators"]]
    # the new memos are keyed by the new mesh's slots
    assert {len(k[3][1]) for k in rc._subplans} == {2}


@pytest.mark.parametrize("backend", ["cuda", "local"])
def test_commit_retires_superseded_memos_and_reads_see_the_write(backend):
    s, g, rc = _engine(backend)
    vg = versioned(s, g)
    v0 = vg.current().snapshot_version
    assert vg.cypher(Q2).records.to_maps() == [{"c": 3}]
    (key,) = [k for k in rc._subplans if k[2][-1][0] == "filter"]
    assert key[:2] == (result_scope(vg.current()), v0)
    vg.cypher("CREATE (e:Person {name: 'Eve', age: 61})")
    assert rc.stats()["subplan_entries"] == 0
    assert rc.stats()["retired"] >= 1 and rc.bytes == 0
    # the new version is a new key space: a miss, then the write's row
    assert vg.cypher(Q2).records.to_maps() == [{"c": 4}]
    assert vg.cypher(Q).records.to_maps() == [
        {"n": "Alice"}, {"n": "Bob"}, {"n": "Dana"}, {"n": "Eve"}]
    assert {k[1] for k in rc._subplans} == {vg.current().snapshot_version}


@pytest.mark.parametrize("backend", ["cuda", "local"])
def test_evict_family_drops_every_memo(backend):
    _s, g, rc = _engine(backend)
    for q in MUTATION_FAMILIES:
        g.cypher(q)
    assert rc.stats()["subplan_entries"] == 3
    assert rc.evict_family("some other family") == 3
    assert rc.stats()["subplan_entries"] == 0 and rc.bytes == 0
    hits = rc.stats()["subplan_hits"]
    assert Bag(g.cypher(MUTATION_FAMILIES[2]).records.to_maps()) \
        == Bag(_engine("local")[1].cypher(
            MUTATION_FAMILIES[2]).records.to_maps())
    assert rc.stats()["subplan_hits"] == hits


def test_byte_budget_holds_over_a_soak_of_20_prefixes():
    """20 prefixes of distinct literal predicates through a budget that
    holds a few: bytes never exceed it, the LRU evicts across both
    levels, and the ledger gauge reports what is held."""
    s = caps_tpu_torch.local_session(device="cpu")
    g = create_graph(s, SOCIAL)
    probe = ResultCache(ResultCacheConfig(), registry=s.metrics_registry)
    s.result_cache = probe
    g.cypher("MATCH (p:Person) WHERE p.age > 0 RETURN count(*) AS c")
    one = max(e.nbytes for e in probe._subplans.values())
    budget = 4 * one
    rc = ResultCache(ResultCacheConfig(budget_bytes=budget),
                     registry=s.metrics_registry)
    s.result_cache = rc
    key = ("fam",)
    rc.lookup(key, 0)
    assert rc.offer(key, 0, [{"c": 1}], nbytes=one // 2, service_s=1.0)
    for i in range(20):
        q = f"MATCH (p:Person) WHERE p.age > {20 + i} RETURN count(*) AS c"
        want = sum(a > 20 + i for a in (33, 44, 27, 51))
        assert g.cypher(q).records.to_maps() == [{"c": want}]
        assert rc.bytes <= budget
        assert s.metrics_snapshot()["mem.result_cache_bytes"] == rc.bytes
        assert rc.stats()["subplan_entries"] <= 4
    assert rc.stats()["evictions"] >= 16
    assert rc.entries == 0  # the older result entry went first
    assert rc.bytes == sum(e.nbytes for e in rc._subplans.values())
    # an entry over max_entry_fraction of the budget is never stored
    small = ResultCache(ResultCacheConfig(budget_bytes=one),
                        registry=s.metrics_registry)
    s.result_cache = small
    g.cypher("MATCH (p:Person) WHERE p.age > 1 RETURN count(*) AS c")
    assert small.stats()["subplan_entries"] == 0 and small.bytes == 0
