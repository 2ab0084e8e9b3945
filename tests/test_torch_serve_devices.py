"""Device fault domains on the port: multi-device replica serving with
failover behind QueryServer — the cases of ``tests/test_devices.py``
(its long soak excepted) on the port's CPU session (its replicas are
CPU sessions), with copies and answers held against the JAX package's,
plus the replicas' placement and the two graph-copy paths.

The contracts under test:

* replication — each replica owns a re-ingested graph copy and a cloned
  session (per-device plan cache / string pool / fused memos); results
  are digest-equal to the template session's;
* failover — a TRANSIENT device failure retries on a DIFFERENT healthy
  device; consecutive device-attributed failures quarantine the device,
  its claimed work drains back to the dispatcher, and a background
  canary probe reinstates it (quarantine → probing → healthy on the
  fake clock, exactly);
* degraded capacity — the admission controller's retry_after estimator
  is told how many devices are actually live;
* the acceptance soak — 8 clients × mixed queries with one of N devices
  killed mid-run: availability 1.0, digest-equal results, work visibly
  redistributed off the dead device;
* retry-backoff interruptibility — ``cancel()``
  wakes a backing-off worker immediately instead of burning the rest of
  the backoff, and ``shutdown(drain=False)`` cancels in-flight work.
"""
from __future__ import annotations

import threading
import time

import pytest
import torch

import caps_tpu_torch
from caps_tpu_torch.obs import clock, lockgraph
from caps_tpu_torch.serve import (Cancelled, CancellationError, QueryServer,
                            RetryPolicy, ServerConfig, device_fault)
from caps_tpu_torch.serve.devices import (HEALTHY, PROBING, QUARANTINED,
                                    ReplicaSet, executing_device_index,
                                    replicate_graph)
from caps_tpu_torch.serve.errors import ReplicationUnsupported
from caps_tpu_torch.testing.factory import create_graph
from caps_tpu_torch.testing.faults import device_loss, sick_device

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

Q_ORDER = ("MATCH (p:Person) WHERE p.age > $min "
           "RETURN p.name AS n ORDER BY n")
Q_EDGE = ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age > $min "
          "RETURN a.name AS a, b.name AS b")
Q_COUNT = ("MATCH (a:Person)-[k:KNOWS]->(b) WHERE k.since >= $y "
           "RETURN count(*) AS c")


def _session():
    return caps_tpu_torch.local_session(device="cpu")


def _graph(session):
    return create_graph(session, SOCIAL)


def _bag(rows):
    return sorted(sorted(r.items()) for r in rows)


def _drive(server, replica):
    """Direct-drive one dispatch cycle: pull the next batch from the
    dispatcher and execute it as ``replica``'s worker would."""
    batch = server.batcher.next_batch(timeout=0)
    if batch:
        server._execute_batch(batch, replica)
    return batch


class FakeClock:
    """Same fake as tests/test_faults.py: ``sleep`` advances ``now``
    instantly; ``wait`` honors an already-fired cancel event with no
    time passing."""

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


# -- replication (serve/devices.py replicate_graph + session.clone) --------

def test_replicate_graph_digest_parity():
    from caps_tpu_torch.relational.session import result_digest
    src = _session()
    graph = _graph(src)
    dst = src.clone()
    copy = replicate_graph(graph, dst)
    for q, b in [(Q_ORDER, {"min": 30}), (Q_EDGE, {"min": 25}),
                 (Q_COUNT, {"y": 2015})]:
        assert result_digest(graph.cypher(q, b)) \
            == result_digest(copy.cypher(q, b))
    # the copy is anchored to the CLONE session, not the template
    assert copy.session is dst and copy.session is not src


@pytest.mark.parametrize("path", ["device_copy", "host_reingest"])
def test_replicate_graph_copy_paths_agree(path):
    """Between sessions whose string pools agree the copy clones the
    device tensors and extends the pool; otherwise every column is read
    back and re-ingested (the reference's only path).  Both copies own
    their buffers, and both answer as the JAX package's copy does."""
    import caps_tpu
    from caps_tpu.relational.session import result_digest as jax_digest
    from caps_tpu.serve.devices import replicate_graph as jax_replicate
    from caps_tpu.testing.factory import create_graph as jax_create
    from caps_tpu_torch.relational.session import result_digest
    src = _session()
    graph = _graph(src)
    dst = src.clone()
    if path == "host_reingest":
        dst.backend.pool.encode("a string the source pool lacks")
    copy = replicate_graph(graph, dst)
    for a, b in zip(graph.node_tables + graph.rel_tables,
                    copy.node_tables + copy.rel_tables):
        for c in a.table.columns:
            assert b.table._cols[c].data.data_ptr() \
                != a.table._cols[c].data.data_ptr()
    same_codes = all(
        torch.equal(b.table._cols[c].data, a.table._cols[c].data)
        for a, b in zip(graph.node_tables, copy.node_tables)
        for c in a.table.columns)
    assert same_codes == (path == "device_copy")
    ref_src = caps_tpu.local_session(backend="tpu")
    ref_copy = jax_replicate(jax_create(ref_src, SOCIAL), ref_src.clone())
    for q, b in [(Q_ORDER, {"min": 30}), (Q_EDGE, {"min": 25}),
                 (Q_COUNT, {"y": 2015})]:
        assert result_digest(copy.cypher(q, b)) \
            == jax_digest(ref_copy.cypher(q, b))


def test_acquire_devices_places_replicas_on_the_sessions_device(monkeypatch):
    """A CPU session's replicas are CPU sessions; a card session's get
    one card each when the process sees enough cards, else all share its
    card (each on a stream of its own) — never the CPU."""
    import types
    from caps_tpu_torch.serve.devices import _acquire_devices
    assert _acquire_devices(3, _session()) == [torch.device("cpu")] * 3
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert _acquire_devices(3, card) == [torch.device("cuda", i)
                                         for i in range(3)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert _acquire_devices(2, card) == [torch.device("cuda", 0)] * 2


def test_a_clone_of_a_card_session_never_lands_on_the_cpu():
    from caps_tpu_torch.backends.cuda.session import CUDACypherSession
    card = CUDACypherSession.__new__(CUDACypherSession)
    card.device = torch.device("cuda", 0)
    card.config = _session().config
    with pytest.raises(ValueError, match="must stay on a card"):
        card.clone(device="cpu")


def test_clone_session_shares_no_mutable_state():
    src = _session()
    dst = src.clone()
    assert type(dst) is type(src) and dst.config is src.config
    assert dst.plan_cache is not src.plan_cache
    assert dst.metrics_registry is not src.metrics_registry
    assert dst.catalog is not src.catalog
    # device backend: per-device string pool and fused memos
    tpu = caps_tpu_torch.local_session(device="cpu")
    tpu2 = tpu.clone()
    assert tpu2.backend is not tpu.backend
    assert tpu2.backend.pool is not tpu.backend.pool
    assert tpu2.fused is not tpu.fused


def test_replicate_graph_rejects_union_graphs():
    session = _session()
    g = _graph(session)
    union = g.union_all(_graph(session))
    with pytest.raises(ReplicationUnsupported):
        replicate_graph(union, session.clone())


def test_replica_set_isolation_and_eager_ingest():
    session = _session()
    graph = _graph(session)
    rs = ReplicaSet(session, graph=graph, n_devices=3,
                    registry=session.metrics_registry)
    assert len(rs) == 3
    assert rs.replicas[0].session is session           # template reuse
    sessions = [r.session for r in rs.replicas]
    assert len({id(s) for s in sessions}) == 3
    assert len({id(s.plan_cache) for s in sessions}) == 3
    # ingest once per device happened at construction; replica copies
    # are distinct objects anchored to their own sessions
    g1 = rs.replicas[1].graph_for(graph)
    g2 = rs.replicas[2].graph_for(graph)
    assert g1 is not graph and g2 is not graph and g1 is not g2
    assert g1.session is sessions[1] and g2.session is sessions[2]
    # replica 0 serves the ORIGINAL graph object
    assert rs.replicas[0].graph_for(graph) is graph


def test_non_replicable_graphs_pin_to_device0():
    """A union graph cannot re-ingest onto other devices: the server
    must still construct with devices=N (other replicas just idle for
    it), serve it on device 0, and keep TRANSIENT retries on device 0
    instead of leaking ReplicationUnsupported to the client."""
    from caps_tpu_torch.testing.faults import failing_operator
    session = _session()
    union = _graph(session).union_all(_graph(session))
    expected = _bag(union.cypher(Q_COUNT, {"y": 2015}).records.to_maps())
    server = QueryServer(session, graph=union, start=False,
                         config=ServerConfig(
                             devices=2,
                             retry=RetryPolicy(backoff_base_s=0.0,
                                               jitter=0.0)))
    r1 = server.devices.replicas[1]
    marked = RuntimeError("flaky backend")
    marked.caps_transient = True
    # the fault fires on the replay and on the fused executor's
    # re-record (backends/cuda/fused.py) before the server sees it
    with failing_operator("Scan", exc=marked, n_times=2):
        h = server.submit(Q_COUNT, {"y": 2015})
        _drive(server, r1)                   # claimed by device 1...
    rows = h.rows(timeout=5)                 # ...served by device 0
    assert _bag(rows) == expected
    assert all(a["device"] == 0 for a in h.info["attempts"])
    server.shutdown(drain=False)


def test_replica_graph_cache_is_bounded():
    from caps_tpu_torch.serve.devices import MAX_REPLICA_GRAPHS
    session = _session()
    rs = ReplicaSet(session, n_devices=2,
                    registry=session.metrics_registry)
    r1 = rs.replicas[1]
    graphs = [create_graph(session, "CREATE (:Person {name: 'solo'})")
              for _ in range(MAX_REPLICA_GRAPHS + 3)]
    for g in graphs:
        r1.graph_for(g)
    assert len(r1._graphs) == MAX_REPLICA_GRAPHS
    # the most recent graphs stayed cached (LRU end), the oldest fell out
    assert id(graphs[-1]) in r1._graphs
    assert id(graphs[0]) not in r1._graphs


# -- multi-device serving --------------------------------------------------

def test_multi_device_server_serves_mixed_queries():
    session = _session()
    graph = _graph(session)
    expected = {
        (Q_ORDER, 30): _bag(graph.cypher(Q_ORDER,
                                         {"min": 30}).records.to_maps()),
        (Q_EDGE, 25): _bag(graph.cypher(Q_EDGE,
                                        {"min": 25}).records.to_maps()),
        (Q_COUNT, 2015): _bag(graph.cypher(Q_COUNT,
                                           {"y": 2015}).records.to_maps()),
    }
    with QueryServer(session, graph=graph,
                     config=ServerConfig(devices=3)) as server:
        handles = []
        for i in range(30):
            q, k, b = [(Q_ORDER, 30, {"min": 30}), (Q_EDGE, 25, {"min": 25}),
                       (Q_COUNT, 2015, {"y": 2015})][i % 3]
            handles.append(((q, k), server.submit(q, b)))
        for key, h in handles:
            assert _bag(h.rows(timeout=30)) == expected[key]
        assert server.health() == "healthy"
        assert server.device_health() == {0: HEALTHY, 1: HEALTHY,
                                          2: HEALTHY}
        devs = server.stats()["devices"]
        assert sum(d["completed"] for d in devs) == 30
        assert all(d["health"] == HEALTHY for d in devs)


def test_transient_device_fault_retries_on_different_device():
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(
                             devices=2,
                             retry=RetryPolicy(backoff_base_s=0.0,
                                               jitter=0.0)))
    r0 = server.devices.replicas[0]
    with device_loss(0, n_times=1) as budget:
        h = server.submit(Q_ORDER, {"min": 30})
        _drive(server, r0)
    assert budget.injected == 1
    assert [r["n"] for r in h.rows(timeout=5)] == ["Alice", "Bob", "Dana"]
    attempts = h.info["attempts"]
    # first attempt failed ON device 0, the retry succeeded on device 1
    assert attempts[0]["device"] == 0
    assert attempts[0]["classified"] == "transient"
    assert attempts[-1] == {"mode": "fused", "ok": True, "device": 1}
    devs = server.stats()["devices"]
    assert devs[0]["failed"] == 1 and devs[1]["completed"] == 1
    server.shutdown(drain=False)


def test_sick_device_faults_scope_to_one_replica():
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(
                             devices=2,
                             # out of the way: this test isolates the
                             # injector's per-device scoping, not the
                             # quarantine ladder (its own tests above)
                             device_failure_threshold=100,
                             retry=RetryPolicy(backoff_base_s=0.0,
                                               jitter=0.0)))
    r0, r1 = server.devices.replicas
    with sick_device(1, error_rate=0.5) as budget:
        # device 0's stream never sees the fault
        for _ in range(3):
            h = server.submit(Q_COUNT, {"y": 2015})
            _drive(server, r0)
            assert h.rows(timeout=5) == [{"c": 3}]
        assert budget.injected == 0
        # device 1's stream does — and every hit resolves via failover
        for _ in range(4):
            h = server.submit(Q_COUNT, {"y": 2015})
            _drive(server, r1)
            assert h.rows(timeout=5) == [{"c": 3}]
        assert budget.injected >= 1
    assert executing_device_index() is None  # bracket never leaks
    server.shutdown(drain=False)


# -- quarantine -> probe -> reinstate lifecycle ----------------------------

def test_quarantine_probe_reinstate_lifecycle(fake_clock):
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(
                             devices=2, device_failure_threshold=1,
                             device_cooldown_s=10.0,
                             retry=RetryPolicy(backoff_base_s=0.0,
                                               jitter=0.0)))
    r0, r1 = server.devices.replicas
    assert server.admission.workers == 2
    loss = device_loss(1)
    budget = loss.__enter__()
    try:
        # one device-attributed failure trips the (threshold-1) ladder:
        # the request itself fails over to device 0 and succeeds
        h = server.submit(Q_ORDER, {"min": 30})
        _drive(server, r1)
        assert [r["n"] for r in h.rows(timeout=5)] == ["Alice", "Bob",
                                                       "Dana"]
        assert h.info["attempts"][-1]["device"] == 0
        assert server.device_health() == {0: HEALTHY, 1: QUARANTINED}
        assert server.health() == "degraded"
        # degraded capacity reaches the retry_after estimator
        assert server.admission.workers == 1
        # a batch CLAIMED by the quarantined device drains back to the
        # dispatcher and is served by the healthy one
        h2 = server.submit(Q_COUNT, {"y": 2015})
        _drive(server, r1)                       # requeues, must not run
        assert not h2.done()
        _drive(server, r0)
        assert h2.rows(timeout=5) == [{"c": 3}]
        assert h2.info["device"] == 0
        assert session.metrics_snapshot()["serve.requeued"] == 1
        # cooldown not elapsed: no probe slot yet
        verdict, retry_after = server.devices.try_probe(r1)
        assert verdict == "reject" and 0 < retry_after <= 10.0
        # cooldown elapsed, fault still active: the background canary
        # probe fails and buys another full cooldown
        fake_clock.advance(10.0)
        verdict, _ = server.devices.try_probe(r1)
        assert verdict == "trial"
        assert server.devices.probe(r1) is False
        assert server.device_health()[1] == QUARANTINED
        assert budget.injected >= 2              # trip + failed probe
    finally:
        loss.__exit__(None, None, None)
    # fault lifted + cooldown elapsed: the probe reinstates the device
    fake_clock.advance(10.0)
    verdict, _ = server.devices.try_probe(r1)
    assert verdict == "trial"
    assert server.devices.state(r1) == PROBING
    assert server.devices.probe(r1) is True
    assert server.device_health() == {0: HEALTHY, 1: HEALTHY}
    assert server.health() == "healthy"
    assert server.admission.workers == 2
    snap = r1.snapshot()
    assert snap["quarantines"] == 1
    assert snap["reinstates"] == 1
    assert snap["probes"] == 2
    reg = session.metrics_snapshot()
    assert reg["serve.devices.quarantined"] == 1
    assert reg["serve.devices.reinstated"] == 1
    assert reg["serve.devices.probes"] == 2
    server.shutdown(drain=False)


def test_device_ladder_disabled_for_single_device():
    """A lone device never quarantines: there is nowhere to fail over,
    so a sick single device must stay a serving (retrying) device."""
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(
                             devices=1, device_failure_threshold=1,
                             retry=RetryPolicy(max_attempts=2,
                                               backoff_base_s=0.0,
                                               jitter=0.0)))
    r0 = server.devices.replicas[0]
    with device_loss(0, n_times=1):
        h = server.submit(Q_COUNT, {"y": 2015})
        _drive(server, r0)
    assert h.rows(timeout=5) == [{"c": 3}]       # same-device retry
    assert server.device_health() == {0: HEALTHY}
    server.shutdown(drain=False)


def test_user_errors_never_quarantine_a_device():
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(devices=2,
                                             device_failure_threshold=1))
    r1 = server.devices.replicas[1]
    for _ in range(3):
        h = server.submit("MATCH (p:Person RETURN p")  # syntax error
        _drive(server, r1)
        assert isinstance(h.exception(timeout=5), Exception)
    assert server.device_health()[1] == HEALTHY
    assert not device_fault(SyntaxError("x"))
    server.shutdown(drain=False)


# -- admission accounting --------------------------------------------------

def test_retry_after_accounts_for_live_streams():
    from caps_tpu_torch.obs.metrics import MetricsRegistry
    from caps_tpu_torch.serve.admission import AdmissionController
    adm = AdmissionController(MetricsRegistry(), max_queue=64, workers=4)
    adm.observe_service(1.0)
    assert adm.retry_after_s(depth=8) == pytest.approx(2.0)
    adm.set_active_workers(2)                    # two devices quarantined
    assert adm.retry_after_s(depth=8) == pytest.approx(4.0)
    adm.set_active_workers(0)                    # clamps to 1
    assert adm.retry_after_s(depth=8) == pytest.approx(8.0)


# -- retry-backoff interruptibility (satellite regression) -----------------

def test_cancel_interrupts_retry_backoff_fake_clock(fake_clock):
    """Regression: a cancelled request must stop sleeping immediately —
    the backoff wait returns the moment the cancel event is set, no
    backoff is burned, and the outcome is the budget's verdict."""
    from caps_tpu_torch.testing.faults import make_oom
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(
                             retry=RetryPolicy(max_attempts=5,
                                               backoff_base_s=100.0,
                                               backoff_max_s=100.0,
                                               jitter=0.0)))
    h = server.submit(Q_COUNT, {"y": 2015})
    req = server.batcher.next_batch(timeout=0)[0]
    req.scope.cancel()
    outcome = server._recover(req, make_oom(), 0,
                              server.devices.replicas[0])
    assert isinstance(outcome, Cancelled)
    assert outcome.phase == "backoff"
    assert fake_clock.sleeps == []               # zero backoff burned
    assert h is req.handle
    server.shutdown(drain=False)


def test_cancel_wakes_real_backoff_sleep_promptly():
    from caps_tpu_torch.serve.deadline import CancelScope
    policy = RetryPolicy(backoff_base_s=5.0, backoff_max_s=5.0, jitter=0.0)
    scope = CancelScope()
    threading.Timer(0.05, scope.cancel).start()
    t0 = time.perf_counter()
    policy.sleep(5.0, scope=scope)
    elapsed = time.perf_counter() - t0
    assert scope.cancelled
    assert elapsed < 2.0                         # woke early, not at 5s


def test_non_drain_shutdown_cancels_inflight_backoff():
    """shutdown(drain=False) must interrupt an in-flight request's
    retry sleep, not wait out its backoff schedule."""
    from caps_tpu_torch.testing.faults import failing_operator
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, config=ServerConfig(
        workers=1, retry=RetryPolicy(max_attempts=1000,
                                     backoff_base_s=0.5, backoff_max_s=0.5,
                                     jitter=0.0)))
    with failing_operator("Filter", n_times=None):  # permanent transient
        h = server.submit(Q_ORDER, {"min": 30})
        # wait until the worker demonstrably entered the retry loop
        deadline = time.perf_counter() + 5.0
        while session.metrics_snapshot().get("serve.retries", 0) == 0 \
                and time.perf_counter() < deadline:
            time.sleep(0.01)
        t0 = time.perf_counter()
        assert server.shutdown(drain=False, timeout=10.0)
        assert time.perf_counter() - t0 < 5.0
    ex = h.exception(timeout=5)
    assert isinstance(ex, CancellationError)


# -- the acceptance soak: device killed mid-run ----------------------------

def _device_loss_soak(n_devices: int, per_thread: int,
                      lock_graph: bool = False):
    if lock_graph:
        # every lock created from here on (server, breaker, admission
        # cond, per-replica session state) is a tracked lock recording
        # per-thread acquisition-order edges; strict mode raises
        # LockOrderViolation mid-soak the moment any two locks are ever
        # taken in both orders
        lockgraph.reset()
    session = _session()
    graph = _graph(session)
    flat = [(Q_ORDER, {"min": m}) for m in (20, 30, 40, 50)] + \
           [(Q_EDGE, {"min": m}) for m in (25, 35, 45)] + \
           [(Q_COUNT, {"y": y}) for y in (2011, 2015, 2020)]
    expected = {i: _bag(graph.cypher(q, b).records.to_maps())
                for i, (q, b) in enumerate(flat)}
    server = QueryServer(session, graph=graph, config=ServerConfig(
        devices=n_devices, max_queue=4096, max_batch=4,
        # threshold 1: the victim quarantines on its FIRST claimed
        # failure — which batch lands on which worker is scheduling
        # noise the soak must not depend on
        device_failure_threshold=1, device_cooldown_s=30.0,
        breaker_threshold=1000,
        retry=RetryPolicy(max_attempts=5, backoff_base_s=0.001,
                          backoff_max_s=0.01)))
    n_threads = 8
    results: dict = {}
    submit_errors: list = []

    def run_phase(phase: int):
        def client(tid: int):
            try:
                for j in range(per_thread):
                    i = (tid * 7 + phase + j) % len(flat)
                    q, b = flat[i]
                    results[(phase, tid, j)] = (i, server.submit(q, b))
            except Exception as ex:  # pragma: no cover — must not happen
                submit_errors.append(ex)
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for _i, handle in results.values():
            assert handle.wait(timeout=60)

    # phase 1: all devices healthy (warms every replica's plan cache)
    phases = 1
    run_phase(0)
    before_kill = {d["device"]: d["requests"]
                   for d in server.stats()["devices"]}
    victim = 1
    with device_loss(victim):
        # phase 2: device `victim` is DEAD mid-run — requests fail over,
        # the quarantine trips, capacity degrades to N-1
        run_phase(1)
        phases += 1
        # the victim quarantines on its first claimed failure; top up
        # with bounded extra waves in case phase 2's batches all landed
        # on other workers (scheduling noise, not a failover property)
        for extra in range(10):
            if server.device_health()[victim] != HEALTHY:
                break
            run_phase(2 + extra)
            phases += 1
        health = server.device_health()
        assert health[victim] in (QUARANTINED, PROBING)
        assert all(h == HEALTHY for d, h in health.items() if d != victim)
        assert server.health() == "degraded"
        server.shutdown()        # graceful drain completes on N-1 devices
    assert not submit_errors, submit_errors
    # availability 1.0: every request of EVERY phase resolved with
    # digest-equal rows — no typed give-ups, no worker deaths, no
    # untyped injector leaks
    assert len(results) == phases * n_threads * per_thread
    for i, handle in results.values():
        assert handle.done()
        ex = handle.exception()
        assert ex is None, ex
        assert _bag(handle.rows()) == expected[i], i
    # work visibly redistributed: the dead device stopped absorbing
    # requests after its quarantine while the survivors kept serving
    devs = server.stats()["devices"]
    victim_stats = devs[victim]
    assert victim_stats["quarantines"] == 1
    survivor_delta = sum(d["requests"] - before_kill[d["device"]]
                         for d in devs if d["device"] != victim)
    victim_delta = victim_stats["requests"] - before_kill[victim]
    assert survivor_delta > victim_delta
    snap = session.metrics_snapshot()
    assert snap["serve.completed"] == phases * n_threads * per_thread
    return snap


def test_soak_device_killed_mid_run(monkeypatch):
    """The acceptance soak, with the runtime lock-order graph on
    (CAPS_TPU_LOCK_GRAPH=1): 8 clients, a device killed mid-run, AND a
    machine-checked assertion that the locks the quarantine/requeue
    path took form an acyclic acquisition order that agrees with
    capslint's static lock-order graph (every statically predicted
    serve-tier edge that fired at runtime fired in the same
    direction)."""
    monkeypatch.setenv("CAPS_TPU_LOCK_GRAPH", "1")
    _device_loss_soak(n_devices=4, per_thread=6, lock_graph=True)
    snap = lockgraph.lock_graph_snapshot()
    # strict mode would already have raised mid-soak on a cycle; assert
    # anyway so a future `record` default can't silently weaken this
    assert lockgraph.find_cycle() is None, snap["edges"]
    # the soak's lock traffic covers the serve tier's fault-domain
    # machinery: per-device exec locks, the admission condition (offer/
    # requeue), the breaker state machine driving quarantine/probe, and
    # per-replica stats — all under tracked names
    nodes = set(snap["nodes"])
    assert {"devices.DeviceReplica.lock",
            "admission.AdmissionController._cond",
            "breaker.CircuitBreaker._lock",
            "devices.DeviceReplica._stats_lock",
            "plan_cache.PlanCache._lock"} <= nodes, nodes
    edges = set(snap["edges"])
    # execution holds the device stream lock while the engine takes the
    # plan-cache lock; admission counters tick under the queue condition
    assert ("devices.DeviceReplica.lock",
            "plan_cache.PlanCache._lock") in edges, sorted(edges)
    assert ("admission.AdmissionController._cond",
            "metrics.Counter._lock") in edges, sorted(edges)
    # static/dynamic agreement: every statically predicted edge that was
    # observed at runtime was observed in the SAME direction — the
    # reverse direction appearing would be a cycle between the graphs
    # the port's capslint (caps_tpu_torch/analysis), on its defaults
    from caps_tpu_torch.analysis.core import load_project
    from caps_tpu_torch.analysis.locks import static_lock_graph
    static_edges, _index, _info = static_lock_graph(load_project())
    assert static_edges
    for a, b in static_edges:
        assert (b, a) not in edges, (
            f"static order {a} -> {b} reversed at runtime")
