"""Snapshot-keyed result caching.

The soundness story is version-keyed consistency: results are keyed by
``(result scope, normalized query, param digest)`` and checked against
the snapshot version at lookup, so writes never *invalidate* — they
open a new key space — and a superseded entry can only ever read as a
miss.  Covered here:

* key discipline: plan-family normal form, value-faithful param
  digests, refusal to cache what can't be keyed;
* hit/miss/eviction/stale counter EXACTNESS on a fake clock, including
  the cost-aware admission's half-life recency decay;
* digest parity cached-vs-uncached on both backends;
* write -> miss -> repopulate through the server, retirement on
  commit/compaction, family eviction on quarantine;
* budget never exceeded under an adversarial soak;
* the session's own execution paths never read or fill the result
  level; they seed and store the subplan level's device tables
  (``tests/test_torch_result_cache_subplan.py`` holds that level to the
  JAX package);
* the ``stale_cache`` fault injector (a forged wrong-version entry is
  rejected, never served);
* fleet: read-your-writes with caching on, and the rejoin fencing
  regression — version gauges and retirement publish UNDER the commit
  lock, before the snapshot flip.
"""
from __future__ import annotations

import threading

import pytest

import caps_tpu_torch
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.frontend.parser import normalize_query
from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.metrics import merge_snapshots
from caps_tpu_torch.relational.result_cache import (CachedRows, ResultCache,
                                              ResultCacheConfig,
                                              params_digest,
                                              result_cache_key,
                                              result_scope)
from caps_tpu_torch.relational.updates import (
    delta_state_from_payload, delta_state_to_payload, versioned,
)
from caps_tpu_torch.serve import QueryServer, ServerConfig
from caps_tpu_torch.testing.factory import create_graph
from caps_tpu_torch.testing.faults import failing_operator, stale_cache

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

Q_AGE = ("MATCH (p:Person) WHERE p.age > $min "
         "RETURN p.name AS n ORDER BY n")
Q_COUNT = "MATCH (p:Person) RETURN count(*) AS c"



@pytest.fixture()
def make_session():
    """The port's CPU session (the port has one backend)."""
    def make(**cfg):
        return caps_tpu_torch.local_session(
            device="cpu", config=EngineConfig(**cfg) if cfg else None)
    return make

def _session():
    return caps_tpu_torch.local_session(device="cpu")


class FakeClock:
    """Same fake as tests/test_telemetry.py: ``sleep`` advances ``now``
    instantly."""

    def __init__(self, t0: float = 1_000.0):
        self._t = t0
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def sleep(self, s: float) -> None:
        self.advance(s)

    def wait(self, event, timeout: float) -> bool:
        if event.is_set():
            return True
        self.advance(timeout)
        return event.is_set()

    def advance(self, s: float) -> None:
        with self._lock:
            self._t += s


@pytest.fixture()
def fake_clock(monkeypatch):
    fc = FakeClock()
    monkeypatch.setattr(clock, "now", fc.now)
    monkeypatch.setattr(clock, "sleep", fc.sleep)
    monkeypatch.setattr(clock, "wait", fc.wait)
    return fc


# -- key discipline ----------------------------------------------------------

def test_params_digest_is_value_faithful():
    a = params_digest({"min": 30, "name": "x"})
    b = params_digest({"name": "x", "min": 30})  # order-insensitive
    assert a == b
    assert params_digest({"min": 31, "name": "x"}) != a
    # an un-tokenizable value refuses to digest rather than collide
    assert params_digest({"min": object()}) is None


def test_result_cache_key_uses_plan_family_normal_form():
    s = _session()
    g = create_graph(s, SOCIAL)
    k1 = result_cache_key(g, Q_AGE, {"min": 30})
    k2 = result_cache_key(g, "  " + Q_AGE.replace(" WHERE", "\n WHERE"),
                          {"min": 30})
    assert k1 is not None and k1 == k2  # whitespace variants share a key
    assert k1[1] == normalize_query(Q_AGE)  # == the plan family string
    assert result_cache_key(g, Q_AGE, {"min": object()}) is None
    # both graphs of one scope agree; distinct graphs never collide
    assert result_cache_key(g, Q_AGE, {"min": 30}) == k1
    g2 = create_graph(s, SOCIAL)
    assert result_cache_key(g2, Q_AGE, {"min": 30})[0] != k1[0]


def test_versioned_lineage_shares_one_scope():
    s = _session()
    vg = versioned(s, create_graph(s, SOCIAL))
    snap0 = vg.current()
    vg.cypher("CREATE (e:Person {name: 'Eve', age: 61})")
    snap1 = vg.current()
    assert snap1.snapshot_version == snap0.snapshot_version + 1
    assert result_scope(snap0) == result_scope(snap1) == result_scope(vg)


def test_cached_rows_hands_out_fresh_copies():
    rows = [{"n": "Alice"}, {"n": "Bob"}]
    cr = CachedRows(rows)
    got = cr.to_maps()
    got[0]["n"] = "MUTATED"
    assert cr.to_maps()[0]["n"] == "Alice"


# -- counter exactness on a fake clock ---------------------------------------

def test_hit_miss_stale_counters_exact(fake_clock):
    rc = ResultCache(ResultCacheConfig(budget_bytes=1 << 20))
    key = (1, "q", ())
    assert rc.lookup(key, 0) is None  # cold
    assert rc.offer(key, 0, [{"c": 4}], nbytes=100, service_s=1.0)
    assert rc.lookup(key, 0) == [{"c": 4}]
    assert rc.lookup(key, 0) == [{"c": 4}]
    # a lookup at any OTHER version drops the entry and misses
    assert rc.lookup(key, 1) is None
    st = rc.stats()
    assert (st["hits"], st["misses"]) == (2, 2)
    assert st["stale_rejects"] == 1
    assert st["insertions"] == 1
    assert st["evictions"] == 1  # the stale drop reclaimed the bytes
    assert st["entries"] == 0 and st["bytes"] == 0
    assert st["hit_ratio"] == pytest.approx(0.5)


def test_cost_aware_admission_half_life_decay_exact(fake_clock):
    # min_benefit_per_byte high enough to discriminate decay steps
    rc = ResultCache(ResultCacheConfig(budget_bytes=1000, half_life_s=30.0,
                                       min_benefit_per_byte=1e-3))
    rows = [{"c": 1}]
    # zero observed service time saves nothing: rejected
    assert not rc.offer((1, "q0", ()), 0, rows, nbytes=100, service_s=0.0)
    # fresh key (one noted miss): p = 1/2, benefit/byte = .8*.5/100 =
    # 4e-3 >= 1e-3 -> admitted
    rc.lookup((1, "q1", ()), 0)
    assert rc.offer((1, "q1", ()), 0, rows, nbytes=100, service_s=0.8)
    # three half-lives of silence: p = .5 * .125, benefit/byte = 5e-4
    # < 1e-3 -> rejected, EXACTLY at the decayed estimate
    rc.lookup((1, "q2", ()), 0)
    fake_clock.advance(90.0)
    assert not rc.offer((1, "q2", ()), 0, rows, nbytes=100, service_s=0.8)
    # no single entry over max_entry_fraction of the budget
    assert not rc.offer((1, "q3", ()), 0, rows, nbytes=251, service_s=9.0)
    assert rc.stats()["admission_rejects"] == 3


def test_budget_never_exceeded_adversarial_soak(fake_clock):
    budget = 4096
    rc = ResultCache(ResultCacheConfig(budget_bytes=budget, max_entries=8,
                                       min_benefit_per_byte=1e-12))
    for i in range(50):
        key = (1, f"q{i}", ())
        rc.lookup(key, 0)  # note the miss (re-hit estimator state)
        rc.offer(key, 0, [{"i": i}], nbytes=1000, service_s=1.0)
        assert rc.bytes <= budget, (i, rc.bytes)
        assert rc.entries <= 8
    st = rc.stats()
    assert st["evictions"] > 0
    assert st["insertions"] == 50
    assert st["bytes"] <= budget


# -- serving integration -----------------------------------------------------

def _server(session, graph, **cfg):
    cfg.setdefault("workers", 1)
    cfg.setdefault("result_cache", ResultCacheConfig(budget_bytes=1 << 20))
    return QueryServer(session, graph=graph, config=ServerConfig(**cfg))


@pytest.mark.parametrize("backend", ["local", "tpu"])
def test_digest_parity_cached_vs_uncached(make_session, backend):
    """A hit's rows equal an uncached run's and the JAX package's
    server's (its ``backend`` session on the same CREATE text)."""
    import caps_tpu
    from caps_tpu.serve import QueryServer as JaxServer
    from caps_tpu.serve.fleet import rows_digest
    from caps_tpu.testing.factory import create_graph as jax_create
    ref = caps_tpu.local_session(backend=backend)
    with JaxServer(ref, graph=jax_create(ref, SOCIAL)) as jax_server:
        want_ref = rows_digest(jax_server.submit(Q_AGE, {"min": 30})
                               .rows(timeout=30))
    session = make_session()
    graph = create_graph(session, SOCIAL)
    want = rows_digest(graph.cypher(Q_AGE, {"min": 30})
                       .records.to_maps())  # uncached ground truth
    assert want == want_ref
    with _server(session, graph) as server:
        h1 = server.submit(Q_AGE, {"min": 30})
        d1 = rows_digest(h1.rows(timeout=30))
        h2 = server.submit(Q_AGE, {"min": 30})
        d2 = rows_digest(h2.rows(timeout=30))
        assert h1.info.get("cache") != "hit"
        assert h2.info["cache"] == "hit"
        # handle.result() works on hits too (CachedRows shim)
        assert h2.result().to_maps() == h1.rows()
    assert want == d1 == d2


def test_cache_hit_skips_queue_and_stamps_flight_record():
    session = _session()
    graph = create_graph(session, SOCIAL)
    with _server(session, graph) as server:
        server.run(Q_AGE, {"min": 30})
        h = server.submit(Q_AGE, {"min": 30})
        h.rows(timeout=30)
        assert h.info["cache"] == "hit"
        assert h.info["queue_wait_s"] == 0.0
        recs = [r for r in server.telemetry.recorder.snapshot()
                if r.get("outcome") == "cache_hit"]
        assert recs and recs[-1]["phase"] == "cache"
        assert recs[-1]["device"] is None  # no device dwell on a hit
        # the ledger gauge sees the resident bytes
        snap = session.metrics_snapshot()
        assert snap["mem.result_cache_bytes"] == server.result_cache.bytes
        assert snap["mem.result_cache_bytes"] > 0
        assert snap["rescache.hits"] >= 1


def test_write_new_version_misses_then_repopulates():
    session = _session()
    vg = versioned(session, create_graph(session, SOCIAL))
    with _server(session, vg) as server:
        h0 = server.submit(Q_AGE, {"min": 30})
        assert [r["n"] for r in h0.rows(timeout=30)] \
            == ["Alice", "Bob", "Dana"]
        h1 = server.submit(Q_AGE, {"min": 30})
        h1.rows(timeout=30)
        assert h1.info["cache"] == "hit"
        server.run("CREATE (e:Person {name: 'Zed', age: 70})")
        # the write opened a NEW key space: the read below must re-
        # execute at the new version, never serve the superseded rows
        h2 = server.submit(Q_AGE, {"min": 30})
        rows = h2.rows(timeout=30)
        assert h2.info.get("cache") != "hit"
        assert h2.info["snapshot_version"] \
            == vg.current().snapshot_version
        assert [r["n"] for r in rows] == ["Alice", "Bob", "Dana", "Zed"]
        # superseded-version entries were RETIRED by the commit...
        assert session.metrics_snapshot()["rescache.retired"] >= 1
        # ...and the new version repopulates
        h3 = server.submit(Q_AGE, {"min": 30})
        assert h3.rows(timeout=30) == rows
        assert h3.info["cache"] == "hit"


def test_commit_and_compaction_retire_superseded_entries():
    session = _session()
    rc = ResultCache(ResultCacheConfig(),
                     registry=session.metrics_registry)
    session.result_cache = rc
    vg = versioned(session, create_graph(session, SOCIAL))
    scope = result_scope(vg.current())
    v0 = vg.current().snapshot_version
    rc.lookup((scope, "fam", ()), v0)
    assert rc.offer((scope, "fam", ()), v0, [{"c": 1}], service_s=1.0)
    vg.cypher("CREATE (e:Person {name: 'Eve', age: 61})")
    assert rc.entries == 0  # the commit retired the version-0 entry
    assert rc.stats()["retired"] == 1
    v1 = vg.current().snapshot_version
    rc.lookup((scope, "fam", ()), v1)
    assert rc.offer((scope, "fam", ()), v1, [{"c": 2}], service_s=1.0)
    assert vg.compact() is True
    # compaction publishes a NEWER snapshot: version-1 entries retire
    assert rc.entries == 0
    assert rc.stats()["retired"] == 2
    assert vg.current().snapshot_version > v1


def test_quarantine_evicts_the_familys_results():
    session = _session()
    graph = create_graph(session, SOCIAL)
    graph.cypher(Q_AGE, {"min": 30})  # park a cached plan to poison
    with _server(session, graph) as server:
        rc = server.result_cache
        # resident entry for the SAME family, different binding (the
        # poisoned submission itself must miss, or it never executes)
        server.run(Q_AGE, {"min": 30})
        assert rc.entries == 1
        evicted0 = rc.stats()["evictions"]
        # the fault fires on the replay and on the fused executor's
        # re-record (backends/cuda/fused.py) before the server sees it
        with failing_operator("OrderBy", exc=RuntimeError("poison"),
                              n_times=2):
            h = server.submit(Q_AGE, {"min": 40})
            assert [r["n"] for r in h.rows(timeout=30)] == ["Bob", "Dana"]
        snap = session.metrics_snapshot()
        assert snap["serve.quarantined"] >= 1
        # the quarantined family's resident results were evicted —
        # poisoned rows cannot linger.  (The degraded replan's OWN fresh
        # result may repopulate afterwards; that one is sound.)
        assert rc.stats()["evictions"] > evicted0
        h2 = server.submit(Q_AGE, {"min": 30})
        h2.rows(timeout=30)
        assert h2.info.get("cache") != "hit"  # re-executed, not served


def test_stale_cache_injector_is_rejected_not_served():
    session = _session()
    graph = create_graph(session, SOCIAL)
    with _server(session, graph) as server:
        want = server.run(Q_AGE, {"min": 30}).to_maps()
        h = server.submit(Q_AGE, {"min": 30})
        h.rows(timeout=30)
        assert h.info["cache"] == "hit"  # resident before the forgery
        before = session.metrics_snapshot()
        with stale_cache(n_times=1) as budget:
            h2 = server.submit(Q_AGE, {"min": 30})
            rows = h2.rows(timeout=30)
        assert budget.injected == 1
        # the forged wrong-version entry was REJECTED: the read re-
        # executed and still returned the right rows
        assert rows == want
        assert h2.info.get("cache") != "hit"
        delta_snap = session.metrics_snapshot()
        assert delta_snap["rescache.stale_rejects"] \
            == before.get("rescache.stale_rejects", 0) + 1
        from caps_tpu_torch.obs.metrics import global_registry
        assert global_registry().snapshot()[
            "faults.injected.stale_cache"] >= 1


# -- the session's paths and the two levels ---------------------------------

def test_session_execution_never_touches_the_cache():
    # the session's execution paths never read or fill the RESULT level
    # (the serving tier does, at admission and completion); they seed
    # and store the second level's scan→filter prefixes, held as the
    # device tables they are
    assert ResultCacheConfig().subplan is True
    session = _session()
    rc = ResultCache(ResultCacheConfig(), registry=session.metrics_registry)
    session.result_cache = rc
    graph = create_graph(session, SOCIAL)
    assert graph.cypher(Q_COUNT).records.to_maps() == [{"c": 4}]
    a = graph.cypher(Q_AGE, {"min": 30}).records.to_maps()
    b = graph.cypher(Q_AGE, {"min": 40}).records.to_maps()
    assert [r["n"] for r in a] == ["Alice", "Bob", "Dana"]
    assert [r["n"] for r in b] == ["Bob", "Dana"]
    stats = rc.stats()
    assert (stats["entries"], stats["hits"], stats["misses"],
            stats["insertions"]) == (0, 0, 0, 0)
    # the Scan prefix of the count parked once, then seeded by both
    # runs of Q_AGE, whose $min filter is no prefix of its own
    assert (stats["subplan_entries"], stats["subplan_misses"],
            stats["subplan_hits"]) == (1, 1, 2)
    from caps_tpu_torch.backends.cuda.table import DeviceTable
    (entry,) = rc._subplans.values()
    assert isinstance(entry.table, DeviceTable)
    assert stats["bytes"] == entry.nbytes == entry.table.nbytes > 0
    assert session.metrics_snapshot()["mem.result_cache_bytes"] \
        == stats["bytes"]


# -- fleet -------------------------------------------------------------------

def test_merge_snapshots_recomputes_hit_ratio():
    a = {"rescache.hits": 8, "rescache.misses": 2,
         "rescache.hit_ratio": 0.8}
    b = {"rescache.hits": 0, "rescache.misses": 10,
         "rescache.hit_ratio": 0.0}
    merged = merge_snapshots([a, b])
    # summed hits/misses, ratio RECOMPUTED (not summed to 0.8)
    assert merged["rescache.hits"] == 8
    assert merged["rescache.misses"] == 12
    assert merged["rescache.hit_ratio"] == pytest.approx(0.4)


def test_install_state_publishes_under_lock_before_flip():
    """The rejoin fencing regression: ``on_install`` (gauge publication
    + retirement) runs BEFORE the reference swap, so no reader can be
    admitted at a version the gauges don't yet report."""
    s1 = _session()
    vg1 = versioned(s1, create_graph(s1, "CREATE (:Seed {k:-1, v:-1})"))
    vg1.cypher("CREATE (:Item {k: 1, v: 7})")
    payload = delta_state_to_payload(vg1.current().state)

    s2 = _session()
    rc = ResultCache(ResultCacheConfig(), registry=s2.metrics_registry)
    s2.result_cache = rc
    vg2 = versioned(s2, create_graph(s2, "CREATE (:Seed {k:-1, v:-1})"))
    scope = result_scope(vg2.current())
    rc.lookup((scope, "fam", ()), 0)
    assert rc.offer((scope, "fam", ()), 0, [{"c": 0}], service_s=1.0)

    seen = {}

    def publish(new_snap):
        # inside the commit lock: the new version must NOT be readable
        # yet, and the superseded entry must ALREADY be retired
        seen["flip_published"] = (vg2.current().snapshot_version
                                  == new_snap.snapshot_version)
        seen["retired_first"] = rc.entries == 0
        seen["version"] = new_snap.snapshot_version

    snap = vg2.install_state(delta_state_from_payload(payload), 1,
                             on_install=publish)
    assert seen == {"flip_published": False, "retired_first": True,
                    "version": 1}
    assert snap.snapshot_version == 1
    assert vg2.current().snapshot_version == 1
    # idempotent re-install still re-publishes (a rejoining peer's
    # gauges must not stay stale forever)
    seen.clear()
    vg2.install_state(delta_state_from_payload(payload), 1,
                      on_install=publish)
    assert seen["version"] == 1 and seen["flip_published"] is True


def test_shutdown_detaches_and_clears_the_cache():
    session = _session()
    graph = create_graph(session, SOCIAL)
    server = _server(session, graph)
    server.run(Q_AGE, {"min": 30})
    rc = server.result_cache
    assert session.result_cache is rc and rc.bytes > 0
    server.shutdown()
    assert session.result_cache is None
    assert rc.bytes == 0 and rc.entries == 0
