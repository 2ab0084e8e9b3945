"""The warm-path subsystem on the port: shape-bucket lattice, ragged
bucket batching, deterministic compile-cliff faults, the persistent
plan store's honesty contract, and the warmup round trip — the cases
of ``tests/test_warmup.py``.

Acceptance contract under test: a store-warmed fresh session serves its
first client queries with ZERO compile charge (plan-cache hit + fused
generic replay, proven by the compile ledger); a corrupt / truncated /
version-mismatched / unwritable store degrades to cold compile with a
structured ``planstore.rejected`` event while the server keeps serving;
ragged batching coalesces DISTINCT query texts sharing a shape bucket
with exact per-member results and per-member failure isolation.
"""
from __future__ import annotations

import json
import threading

import pytest

import caps_tpu_torch
from caps_tpu_torch.obs import clock
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.relational.plan_store import (PlanStore, collect_warm_state,
                                            deserialize_stream,
                                            store_fingerprint)
from caps_tpu_torch.relational.shapes import (ShapeBucketLattice,
                                        param_shape_signature,
                                        signature_text)
from caps_tpu_torch.serve import QueryServer, ServerConfig, WarmupConfig
from caps_tpu_torch.serve.batcher import request_keys
from caps_tpu_torch.testing.factory import create_graph
from caps_tpu_torch.testing.faults import failing_operator, slow_compile

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
Q_KNOWS = ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age > $min "
           "RETURN a.name AS a, b.name AS b")


def _session(**cfg):
    return caps_tpu_torch.local_session(device="cpu",
                                  config=EngineConfig(**cfg) if cfg else None)


def _graph(session):
    return create_graph(session, SOCIAL)


# -- shape-bucket lattice (relational/shapes.py) ----------------------------

def test_lattice_default_rounding_matches_config():
    cfg = EngineConfig()
    lat = ShapeBucketLattice(cfg.bucket_sizes)
    for n in (0, 1, 255, 256, 257, 5000, 1048576, 3_000_000):
        assert lat.bucket(n) == max(1, cfg.bucket_for(n))


def test_lattice_seeding_refines_and_is_bounded():
    lat = ShapeBucketLattice((256, 4096), max_buckets=4)
    assert lat.bucket(300) == 4096
    assert lat.seed([300]) == 1          # pow2 ceil of 300 = 512
    assert lat.bucket(300) == 512
    assert lat.seed([300]) == 0          # idempotent
    assert lat.seed([60, 1500]) == 1     # bounded: only ONE more fits
    assert len(lat.boundaries()) == 4
    assert lat.signature(300) == "b512"


def test_lattice_seed_from_op_stats():
    s = _session()
    g = _graph(s)
    g.cypher(Q_AGE, {"min": 20})
    # observed max rows are tiny; their pow2 ceilings become boundaries
    added = s.seed_shape_buckets()
    assert added >= 1
    assert min(s.shape_lattice.boundaries()) < 256


def test_param_shape_signature_value_independent():
    a = param_shape_signature({"min": 20, "name": "Alice"})
    b = param_shape_signature({"min": 99, "name": "Bob"})
    assert a == b
    # coarse type changes the shape
    assert param_shape_signature({"min": 1.5}) != \
        param_shape_signature({"min": 1})
    # container LENGTH buckets, not values
    lat = ShapeBucketLattice((4, 16))
    assert param_shape_signature({"xs": [1, 2]}, lat) == \
        param_shape_signature({"xs": [7, 8]}, lat)
    assert param_shape_signature({"xs": [1] * 10}, lat) != \
        param_shape_signature({"xs": [1, 2]}, lat)
    # map KEY SETS are part of the shape (plans specialize on them)
    assert param_shape_signature({"m": {"k": 1}}) != \
        param_shape_signature({"m": {"j": 1}})
    assert signature_text(a)  # printable label for the compile ledger


# -- ragged batch keys (serve/batcher.py) -----------------------------------

def test_request_keys_plan_vs_bucket():
    s = _session()
    g = _graph(s)
    mode, plan_a, key_a = request_keys(g, Q_AGE, {"min": 20}, ragged=True)
    _m, plan_b, key_b = request_keys(g, Q_KNOWS, {"min": 30}, ragged=True)
    assert mode is None
    assert plan_a != plan_b              # distinct plan families ...
    assert key_a == key_b                # ... sharing one bucket key
    # un-ragged: batch key IS the plan key (the pre-PR behavior)
    _m, plan_a2, key_a2 = request_keys(g, Q_AGE, {"min": 20})
    assert plan_a2 == key_a2 == plan_a
    # a diverging coarse type diverges the bucket too
    _m, _p, key_f = request_keys(g, Q_AGE, {"min": 20.5}, ragged=True)
    assert key_f != key_a
    # writes / EXPLAIN never batch, ragged or not
    assert request_keys(g, "EXPLAIN " + Q_AGE, {}, ragged=True)[2] is None


def test_ragged_batch_coalesces_distinct_texts_exactly():
    s = _session()
    g = _graph(s)
    texts = [Q_AGE, Q_KNOWS,
             "MATCH (p:Person) WHERE p.age > $min RETURN count(*) AS c"]
    for t in texts:
        g.cypher(t, {"min": 20})  # warm each family's plan
    server = QueryServer(s, graph=g, start=False, config=ServerConfig(
        workers=1, max_batch=16, ragged_batching=True))
    hs = [server.submit(texts[i % 3], {"min": 20 + 10 * (i % 2)})
          for i in range(9)]
    server.start()
    server.shutdown()
    sizes = [h.info["batch_size"] for h in hs]
    assert max(sizes) > 1, sizes  # distinct texts coalesced
    for i, h in enumerate(hs):    # every member's result stays exact
        want = g.cypher(texts[i % 3],
                        {"min": 20 + 10 * (i % 2)}).records.to_maps()
        assert h.rows() == want
    assert server.stats()["batching"]["mean_occupancy"] > 1


def test_ragged_batch_member_isolation_and_breaker_scope():
    """A poisoned family inside a ragged batch fails only ITS members;
    siblings from other families in the same shared batch succeed, and
    the breaker keys on the exact plan family (Request.plan_key), not
    the bucket."""
    s = _session()
    g = _graph(s)
    g.cypher(Q_AGE, {"min": 20})
    g.cypher(Q_KNOWS, {"min": 20})
    server = QueryServer(s, graph=g, start=False, config=ServerConfig(
        workers=1, max_batch=16, ragged_batching=True,
        breaker_threshold=2, breaker_cooldown_s=60.0))
    with failing_operator("OrderBy", exc=RuntimeError("poison"),
                          n_times=None):
        bad = [server.submit(Q_AGE, {"min": m}) for m in (20, 30, 40)]
        good = [server.submit(Q_KNOWS, {"min": m}) for m in (20, 30)]
        server.start()
        server.shutdown()
    for h in good:
        assert h.rows() == g.cypher(
            Q_KNOWS, {"min": h._request.params["min"]}).records.to_maps()
    failures = [h.exception() for h in bad]
    assert all(f is not None for f in failures), failures
    # the poisoned family tripped ITS breaker; the healthy family's is
    # closed (scoped per plan family even though they share the bucket)
    assert server.breaker.open_count() >= 1


# -- slow_compile (testing/faults.py) ---------------------------------------

class FakeClock:
    def __init__(self, t0: float = 1_000.0):
        self._t = t0
        self._lock = threading.Lock()
        self.sleeps: list = []

    def now(self) -> float:
        with self._lock:
            return self._t

    def sleep(self, s: float) -> None:
        with self._lock:
            self._t += s
            self.sleeps.append(s)

    def wait(self, event, timeout: float) -> bool:
        if event.is_set():
            return True
        self.sleep(timeout)
        return event.is_set()


@pytest.fixture()
def fake_clock(monkeypatch):
    fc = FakeClock()
    monkeypatch.setattr(clock, "now", fc.now)
    monkeypatch.setattr(clock, "sleep", fc.sleep)
    monkeypatch.setattr(clock, "wait", fc.wait)
    return fc


def test_slow_compile_deterministic_on_fake_clock(fake_clock):
    from caps_tpu_torch.obs.metrics import global_registry
    s = _session()
    g = _graph(s)
    before = global_registry().snapshot().get("faults.injected.slow_compile",
                                              0)
    with slow_compile(35.0, n_times=1) as budget:
        r1 = s.cypher_on_graph(g, Q_AGE, {"min": 20})
        # budget spent: the next cold family compiles at normal speed
        r2 = s.cypher_on_graph(g, Q_KNOWS, {"min": 20})
    assert budget.injected == 1
    assert r1.metrics["compile_s_charged"] >= 35.0
    assert r2.metrics["compile_s_charged"] < 35.0
    assert 35.0 in fake_clock.sleeps  # wall time advanced on the fake clock
    after = global_registry().snapshot()["faults.injected.slow_compile"]
    assert after == before + 1
    # ledger agrees with the inflated charge
    fam = [f for f in s.compile_ledger.families()][0]
    assert s.compile_ledger.seconds_for(fam) >= 35.0


def test_slow_compile_kind_filter(fake_clock):
    # an unfused session never crosses a fused_record boundary: no delay
    s = _session(use_fused=False)
    g = _graph(s)
    with slow_compile(5.0, kinds=("fused_record",)):
        r = s.cypher_on_graph(g, Q_AGE, {"min": 20})
    assert r.metrics["compile_s_charged"] < 5.0
    # a fusing session's record run is the one boundary the filter slows
    s = _session()
    g = _graph(s)
    with slow_compile(5.0, kinds=("fused_record",)):
        r = s.cypher_on_graph(g, Q_AGE, {"min": 20})
    by_kind = {c["kind"]: c["seconds"] for c in r.metrics["compile_charges"]}
    assert by_kind["fused_record"] >= 5.0 and by_kind["plan"] < 5.0


# -- plan store honesty (relational/plan_store.py) --------------------------

def _served_through(store_path, tmp_path):
    """A server configured against ``store_path`` must keep serving and
    report the rejection; returns (server, session)."""
    s = _session()
    g = _graph(s)
    server = QueryServer(s, graph=g, config=ServerConfig(
        warmup=WarmupConfig(store_path=str(store_path), background=False,
                            save_on_shutdown=False)))
    rows = server.run(Q_AGE, {"min": 30}).to_maps()
    assert [r["n"] for r in rows] == ["Alice", "Bob", "Dana"]
    return server, s


@pytest.mark.parametrize("damage", ["corrupt", "truncated", "mismatch",
                                    "malformed"])
def test_bad_store_degrades_to_cold_with_event(tmp_path, damage):
    path = tmp_path / "plans.json"
    if damage == "corrupt":
        path.write_text("{not json at all", encoding="utf-8")
    elif damage == "truncated":
        s0 = _session()
        g0 = _graph(s0)
        s0.cypher_on_graph(g0, Q_AGE, {"min": 20})
        PlanStore(str(path)).save(collect_warm_state(s0, graph=g0))
        full = path.read_text(encoding="utf-8")
        path.write_text(full[:len(full) // 2], encoding="utf-8")
    elif damage == "mismatch":
        payload = {"fingerprint": dict(store_fingerprint(),
                                       package="some-other-version"),
                   "lattice": [], "families": []}
        path.write_text(json.dumps(payload), encoding="utf-8")
    else:  # malformed families section
        payload = {"fingerprint": store_fingerprint(), "lattice": [],
                   "families": [{"query": 42}]}
        path.write_text(json.dumps(payload), encoding="utf-8")
    server, s = _served_through(path, tmp_path)
    events = server.events("planstore.rejected")
    assert len(events) == 1 and events[0]["path"] == str(path)
    assert s.metrics_registry.snapshot()["planstore.rejected"] == 1
    report = server.warmer.report()
    assert report["state"] == "done"
    assert report["store"]["loaded"] is False
    assert report["store"]["rejected"]
    server.shutdown()


def test_unwritable_store_rejects_save_and_server_survives(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("a file where a directory must go",
                       encoding="utf-8")
    path = blocker / "sub" / "plans.json"  # parent dir can never exist
    s = _session()
    g = _graph(s)
    server = QueryServer(s, graph=g, config=ServerConfig(
        warmup=WarmupConfig(store_path=str(path), background=False)))
    assert server.run(Q_AGE, {"min": 30}).to_maps()
    server.shutdown()  # save_on_shutdown fires against the bad path
    assert s.metrics_registry.snapshot()["planstore.rejected"] >= 1
    store = PlanStore(str(path))
    assert store.save({"fingerprint": store_fingerprint(),
                       "families": []}) is False
    assert store.last_rejection.startswith("unwritable")


def test_missing_store_is_not_an_error(tmp_path):
    path = tmp_path / "never-written.json"
    server, s = _served_through(path, tmp_path)
    assert server.events("planstore.rejected") == []
    assert s.metrics_registry.snapshot().get("planstore.rejected", 0) == 0
    server.shutdown()


def test_stream_serialization_round_trip():
    raw = [["rows", 7], ["size", 3, "cap"], ["size", 1, "exact"]]
    assert deserialize_stream(raw) == [("rows", 7), ("size", 3, "cap"),
                                       ("size", 1, "exact")]
    assert deserialize_stream([["rows", "x"]]) is None
    assert deserialize_stream([["__obj__", {}]]) is None
    assert deserialize_stream("nope") is None


# -- the warm-path round trip -----------------------------------------------

def test_store_warmup_round_trip_zero_compile_charge(tmp_path):
    """Serve traffic, persist, restart into a 'fresh process' (new
    session, same data): warmup from the store covers every hot family
    through the REAL compile boundaries, and the first client query of
    each family — including new bindings within the same shape bucket —
    charges zero compile seconds."""
    path = tmp_path / "plans.json"
    s1 = _session()
    g1 = _graph(s1)
    server1 = QueryServer(s1, graph=g1, config=ServerConfig(
        warmup=WarmupConfig(store_path=str(path), background=False)))
    for params in ({"min": 30}, {"min": 35}):
        server1.run(Q_AGE, params)
        server1.run(Q_KNOWS, params)
    server1.shutdown()  # save_on_shutdown persists the warm state
    assert path.exists()

    s2 = _session()
    g2 = _graph(s2)
    server2 = QueryServer(s2, graph=g2, config=ServerConfig(
        warmup=WarmupConfig(store_path=str(path), background=False)))
    report = server2.warmer.report()
    assert report["state"] == "done"
    assert report["completed"] == report["families_total"] == 2
    assert report["failures"] == []
    assert report["store"]["loaded"] is True
    assert report["converged"] is True
    # the ledger proves coverage: no hot family is cold on this process
    assert server2.warmup_report()["cold_families"] == []
    # first client queries — warmed bindings AND fresh within-bucket
    # bindings — all charge zero compile seconds
    for query, params in [(Q_AGE, {"min": 30}), (Q_AGE, {"min": 25}),
                          (Q_KNOWS, {"min": 50})]:
        h = server2.submit(query, params)
        assert h.rows() == g2.cypher(query, params).records.to_maps()
        assert h.info["ledger"]["compile_s"] == 0.0, (params,
                                                      h.info["ledger"])
    assert server2.stats()["warmup"]["state"] == "done"
    assert server2.health_report()["warmup"]["state"] == "done"
    server2.shutdown()


def test_explicit_family_list_warmup():
    s = _session()
    g = _graph(s)
    paramless = "MATCH (p:Person) RETURN count(*) AS c"
    server = QueryServer(s, graph=g, config=ServerConfig(
        warmup=WarmupConfig(families=((Q_AGE, {"min": 20}), paramless),
                            background=False)))
    report = server.warmer.report()
    assert report["completed"] == 2
    assert server.warmup_report()["cold_families"] == []
    h = server.submit(Q_AGE, {"min": 30})
    assert h.rows()
    assert h.info["ledger"]["compile_s"] == 0.0
    server.shutdown()


def test_warmup_family_failure_is_contained():
    s = _session()
    g = _graph(s)
    server = QueryServer(s, graph=g, config=ServerConfig(
        warmup=WarmupConfig(families=(("THIS IS NOT CYPHER", {}),
                                      (Q_AGE, {"min": 20})),
                            background=False)))
    report = server.warmer.report()
    assert report["state"] == "done"
    assert report["completed"] == 1
    assert len(report["failures"]) == 1
    assert server.events("warmup.family_failed")
    assert server.run(Q_AGE, {"min": 30}).to_maps()  # still serving
    server.shutdown()


def test_background_warmup_reports_progress():
    s = _session()
    g = _graph(s)
    server = QueryServer(s, graph=g, config=ServerConfig(
        warmup=WarmupConfig(families=((Q_AGE, {"min": 20}),),
                            background=True)))
    assert server.warmer.wait(timeout=120)
    assert server.warmer.report()["state"] == "done"
    assert [e["event"] for e in server.events()].count("warmup.done") == 1
    server.shutdown()


def test_warmup_resolves_versioned_graph_for_replicas():
    """Regression: warmup must execute against the pinned snapshot, not
    the writable VersionedGraph handle — replicas cannot replicate the
    handle, and a multi-device warmup would otherwise fail every
    family."""
    s = _session()
    vg = s.create_versioned_graph()
    s.cypher_on_graph(vg, "CREATE (:Person {name: 'Ada', age: 36})")
    server = QueryServer(s, graph=vg, config=ServerConfig(
        devices=2,
        warmup=WarmupConfig(families=((Q_AGE, {"min": 20}),),
                            background=False)))
    report = server.warmer.report()
    assert report["state"] == "done"
    assert report["failures"] == [], report["failures"]
    assert report["completed"] == 1
    assert server.run(Q_AGE, {"min": 20}).to_maps() == [{"n": "Ada"}]
    server.shutdown()


def test_warmup_converges_in_one_pass_without_fused_streams():
    """Regression: a target that can never hold a param-generic fused
    stream (use_fused off) is ABSENT, not stale — warmup must not burn
    every convergence pass and report a false non-convergence."""
    s = _session(use_fused=False)
    g = _graph(s)
    server = QueryServer(s, graph=g, config=ServerConfig(
        warmup=WarmupConfig(families=((Q_AGE, {"min": 20}),),
                            background=False)))
    report = server.warmer.report()
    assert report["state"] == "done" and report["completed"] == 1
    assert report["converged"] is True
    assert report["passes"] == 1, report
    server.shutdown()


def test_ragged_bucket_key_uses_session_lattice():
    """Regression: container params bucket through the SESSION lattice
    (the one padding and compile labels use), not the process default."""
    s = _session()
    g = _graph(s)
    s.shape_lattice.seed([300])  # 512 boundary only the session knows
    server = QueryServer(s, graph=g, start=False, config=ServerConfig(
        ragged_batching=True))
    q = "MATCH (p:Person) WHERE p.age IN $xs RETURN p.name AS n"
    h_small = server.submit(q, {"xs": list(range(300))})
    h_big = server.submit(q, {"xs": list(range(600))})
    # 300 -> 512, 600 -> 1024 on the seeded session lattice: different
    # buckets, so these must NOT share a ragged batch key (the default
    # lattice would have merged both into 1024)
    assert h_small._request.batch_key != h_big._request.batch_key
    server.start()
    server.shutdown()


def test_fused_stream_export_is_pool_current_only():
    s = _session()
    g = _graph(s)
    s.cypher_on_graph(g, Q_AGE, {"min": 20})
    exported = s.fused.export_streams(g)
    assert Q_AGE in exported
    # a violation-disabled stream is known-divergent: never exported
    s.fused._generic[(g._fused_epoch, Q_AGE)][2] = 3
    assert Q_AGE not in s.fused.export_streams(g)
    s.fused._generic[(g._fused_epoch, Q_AGE)][2] = 0
    assert Q_AGE in s.fused.export_streams(g)
    # simulate pool growth: the stale stream must drop out of the export
    s.backend.pool.encode("a-brand-new-string")
    assert Q_AGE not in s.fused.export_streams(g)


def test_sibling_server_shutdown_keeps_memory_accounting():
    """Regression: a short-lived sibling server sharing the graph must
    not drop the live server's memory-ledger slot on shutdown."""
    s = _session()
    g = _graph(s)
    main = QueryServer(s, graph=g)
    sibling = QueryServer(s, graph=g)
    sibling.shutdown()
    mem = main.stats()["memory"]
    assert mem["graphs"].get("default", {}).get("bytes", 0) > 0
    main.shutdown()
    assert s.memory_ledger.report()["graphs"] == {}  # all owners gone


def test_finalize_cancels_pending_warmup(tmp_path):
    """Regression: the warmer's cooperative cancel bounds a run at the
    next family boundary (no family executes past it), and a cancelled
    run never emits into a possibly-closed event-log sink."""
    path = tmp_path / "plans.json"
    s = _session()
    g = _graph(s)
    server = QueryServer(s, graph=g, start=False, config=ServerConfig(
        warmup=WarmupConfig(store_path=str(path), background=False,
                            families=((Q_AGE, {"min": 20}),))))
    server.warmer._stop.set()  # cancel BEFORE the run starts
    server.start()
    report = server.warmer.report()
    assert report["truncated"] is True and report["completed"] == 0
    assert server.events("warmup.done") == []  # no late sink write
    server.shutdown()


def test_seed_generic_never_clobbers_live_streams():
    s = _session()
    g = _graph(s)
    s.cypher_on_graph(g, Q_AGE, {"min": 20})
    assert s.fused.seed_generic(g, Q_AGE, 99, [("rows", 1)]) is False
    # a different query seeds fine, and a pool-stale seed simply never
    # replays (the gate) — execution degrades to an honest record
    assert s.fused.seed_generic(g, Q_KNOWS, 99, [("rows", 1)]) is True
    r = s.cypher_on_graph(g, Q_KNOWS, {"min": 20})
    assert r.metrics["compile_s_charged"] > 0.0  # recorded, not misled
