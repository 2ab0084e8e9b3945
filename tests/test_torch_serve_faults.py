"""Failure containment on the port: the fault-injection harness, the
transient-retry/backoff path, plan quarantine + the degraded execution
ladder, and the per-plan-family circuit breaker — the cases of
``tests/test_faults.py`` that the ported injectors reach, with the
errors PyTorch raises (a CUDA runtime error, ``OutOfMemoryError``).

Acceptance contract under test: under ``failing_operator(...,
n_times=1)`` transient faults injected into ~20% of requests at 8
concurrent clients, the server stays available — zero worker-thread
deaths, every request resolves to a result or a typed ``ServeError``,
retried results are bag-equal to a fault-free sequential run — and a
permanently failing query family trips its breaker within K attempts
while other families keep serving.

All retry/backoff/breaker TIMING tests run against a fake
``obs.clock`` whose ``sleep`` advances ``now`` instantly: the
backoff sequence, the deadline-budget interaction, and the breaker's
open → half-open → closed transitions are asserted exactly, with zero
real sleeping.
"""
from __future__ import annotations

import threading

import pytest

import caps_tpu_torch
from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.metrics import MetricsRegistry
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.serve import (
    FATAL, POISONED_PLAN, TRANSIENT, Cancelled, CircuitOpen, DeadlineExceeded,
    Overloaded, QueryFailed, QueryServer, RetryPolicy, ServeError,
    ServerConfig, WaitTimeout, classify,
)
from caps_tpu_torch.serve.breaker import (
    ALLOW, CLOSED, HALF_OPEN, OPEN, REJECT, TRIAL, CircuitBreaker,
)
from caps_tpu_torch.testing.factory import create_graph
from caps_tpu_torch.testing.faults import (
    FaultPlan, failing_operator, make_oom, slow_operator,
)

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

#: three distinct plan families (ORDER BY makes family 0 the only one
#: that touches OrderByOp — fault it to break ONE family)
Q_ORDER = ("MATCH (p:Person) WHERE p.age > $min "
           "RETURN p.name AS n ORDER BY n")
Q_EDGE = ("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.age > $min "
          "RETURN a.name AS a, b.name AS b")
Q_COUNT = ("MATCH (a:Person)-[k:KNOWS]->(b) WHERE k.since >= $y "
           "RETURN count(*) AS c")


def _session(**cfg):
    return caps_tpu_torch.local_session(device="cpu",
                                  config=EngineConfig(**cfg) if cfg else None)


def _graph(session):
    return create_graph(session, SOCIAL)


def _bag(rows):
    return sorted(sorted(r.items()) for r in rows)


class FakeClock:
    """Monotonic fake for obs.clock: ``sleep`` advances ``now``
    instantly and records what was slept (thread-safe — server workers
    read it concurrently).  ``wait`` — the interruptible backoff
    primitive — honors an already-fired event instantly (no time passes,
    nothing recorded) and otherwise advances like a sleep."""

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


# -- taxonomy (serve/failure.py) -------------------------------------------

def test_classify_taxonomy():
    from caps_tpu_torch.frontend.lexer import CypherSyntaxError
    import torch
    from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice
    assert classify(make_oom()) == TRANSIENT
    # a CUDA runtime error of a launch or a copy: retried (on another
    # replica), in both of the shapes PyTorch raises it
    assert classify(torch.AcceleratorError("CUDA error: launch failure")
                    ) == TRANSIENT
    assert classify(RuntimeError("CUDA error: an illegal memory access "
                                 "was encountered")) == TRANSIENT
    # the port's own refusal of an expression is the query's fault
    assert classify(UnsupportedOnDevice("labels")) == FATAL
    assert classify(ConnectionError("tunnel reset")) == TRANSIENT
    assert classify(DeadlineExceeded("execute", 0.1, 0.2)) == FATAL
    assert classify(Cancelled()) == FATAL
    assert classify(Overloaded("full")) == FATAL
    assert classify(CypherSyntaxError("bad", "q", 0)) == FATAL
    assert classify(KeyError("missing parameter $x")) == FATAL
    # unexplained execution errors default to poisoned-plan suspicion
    assert classify(RuntimeError("boom")) == POISONED_PLAN
    assert classify(IndexError("gather out of range")) == POISONED_PLAN
    # explicit marker overrides everything
    marked = RuntimeError("flaky thing")
    marked.caps_transient = True
    assert classify(marked) == TRANSIENT


def test_wait_timeout_is_serve_error_and_timeout():
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False)
    h = server.submit(Q_COUNT, {"y": 2015})
    with pytest.raises(TimeoutError):      # backward compatible
        h.result(timeout=0.01)
    with pytest.raises(ServeError):        # one base type catches all
        h.result(timeout=0.01)
    with pytest.raises(WaitTimeout):
        h.exception(timeout=0.01)
    server.shutdown(drain=False)


# -- the harness (testing/faults.py) ---------------------------------------

def test_failing_operator_transient_then_heals():
    session = _session()
    graph = _graph(session)
    with failing_operator("Scan", n_times=1) as budget:
        with pytest.raises(Exception) as ex:
            graph.cypher(Q_COUNT, {"y": 2015})
        assert "out of memory" in str(ex.value)
        # healed: the budget is spent, the same query now succeeds
        assert graph.cypher(Q_COUNT, {"y": 2015}).records.to_maps() \
            == [{"c": 3}]
    assert budget.injected == 1


def test_failing_operator_raises_fresh_exception_objects():
    session = _session()
    graph = _graph(session)
    template = RuntimeError("shared template")
    caught = []
    with failing_operator("Scan", exc=template, n_times=2):
        for _ in range(2):
            try:
                graph.cypher(Q_COUNT, {"y": 2015})
            except RuntimeError as ex:
                caught.append(ex)
    assert len(caught) == 2
    assert caught[0] is not caught[1]          # fresh object per injection
    assert caught[0] is not template and caught[1] is not template


def test_fault_plan_composes_and_nests():
    from caps_tpu_torch.relational import ops as R
    orig_scan = R.ScanOp._compute
    orig_filter = R.FilterOp._compute
    session = _session()
    graph = _graph(session)
    with FaultPlan(slow_operator("Filter", 0.0),
                   failing_operator("Scan", n_times=1)):
        with failing_operator("Scan", n_times=1):  # nested, same class
            with pytest.raises(Exception):
                graph.cypher(Q_COUNT, {"y": 2015})
            with pytest.raises(Exception):  # second hook's budget
                graph.cypher(Q_COUNT, {"y": 2015})
        assert graph.cypher(Q_COUNT, {"y": 2015}).records.to_maps() \
            == [{"c": 3}]
    # everything restored, verbatim
    assert R.ScanOp._compute is orig_scan
    assert R.FilterOp._compute is orig_filter


def test_operator_hooks_thread_safe_install_remove():
    from caps_tpu_torch.relational import ops as R
    orig = R.FilterOp._compute
    errors: list = []

    def churn():
        # a session each: the port's sessions, like the JAX package's
        # device sessions, run one query at a time (the server
        # serializes each through its execution lock); the patch point
        # under test is process-wide
        graph = _graph(_session())
        try:
            for _ in range(30):
                with slow_operator("Filter", 0.0):
                    graph.cypher(Q_COUNT, {"y": 2015})
        except Exception as ex:  # pragma: no cover
            errors.append(ex)

    threads = [threading.Thread(target=churn) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert R.FilterOp._compute is orig


def test_injection_counters_in_registry():
    from caps_tpu_torch.obs.metrics import global_registry
    session = _session()
    graph = _graph(session)
    before = global_registry().counter(
        "faults.injected.failing_operator").value
    with failing_operator("Scan", n_times=2):
        for _ in range(3):  # third execution is past the budget
            try:
                graph.cypher(Q_COUNT, {"y": 2015})
            except Exception:
                pass
    after = global_registry().counter(
        "faults.injected.failing_operator").value
    assert after - before == 2


def test_backoff_sequence_deterministic_and_capped():
    policy = RetryPolicy(max_attempts=6, backoff_base_s=0.1,
                         backoff_multiplier=2.0, backoff_max_s=0.5,
                         jitter=0.1)
    seq = [policy.backoff_s(a, token=7) for a in range(1, 6)]
    # deterministic: same (attempt, token) -> identical backoff
    assert seq == [policy.backoff_s(a, token=7) for a in range(1, 6)]
    # a different token jitters differently
    assert seq != [policy.backoff_s(a, token=8) for a in range(1, 6)]
    # exponential nominal values 0.1, 0.2, 0.4, then capped at 0.5,
    # each within the ±10% jitter band
    for got, nominal in zip(seq, [0.1, 0.2, 0.4, 0.5, 0.5]):
        assert abs(got - nominal) <= 0.1 * nominal + 1e-12
    # no-jitter policy is exact
    exact = RetryPolicy(backoff_base_s=0.1, backoff_max_s=10.0, jitter=0.0)
    assert [exact.backoff_s(a) for a in (1, 2, 3)] == [0.1, 0.2, 0.4]


def test_server_retries_transient_with_fake_clock_backoff(fake_clock):
    session = _session()
    graph = _graph(session)
    policy = RetryPolicy(max_attempts=4, backoff_base_s=0.25, jitter=0.0)
    with QueryServer(session, graph=graph,
                     config=ServerConfig(workers=1, retry=policy)) as server:
        with failing_operator("Filter", n_times=2):
            h = server.submit(Q_ORDER, {"min": 30})
            rows = h.rows(timeout=30)
    assert [r["n"] for r in rows] == ["Alice", "Bob", "Dana"]
    attempts = h.info["attempts"]
    assert [a.get("ok", False) for a in attempts] == [False, False, True]
    assert attempts[0]["classified"] == TRANSIENT
    assert attempts[0]["op"] == "Filter"
    # the exact exponential backoff sequence, slept on the fake clock
    assert attempts[0]["backoff_s"] == 0.25
    assert attempts[1]["backoff_s"] == 0.5
    assert fake_clock.sleeps == [0.25, 0.5]
    assert session.metrics_snapshot()["serve.retries"] == 2


def test_retry_never_fires_when_budget_below_backoff(fake_clock):
    session = _session()
    graph = _graph(session)
    policy = RetryPolicy(max_attempts=5, backoff_base_s=10.0,
                         backoff_max_s=10.0, jitter=0.0)
    with QueryServer(session, graph=graph,
                     config=ServerConfig(workers=1, retry=policy)) as server:
        with failing_operator("Filter", n_times=1):
            h = server.submit(Q_ORDER, {"min": 30}, deadline_s=5.0)
            ex = h.exception(timeout=30)
    # remaining budget (~5s) < next backoff (10s): the give-up error
    # fires IMMEDIATELY — no backoff sleep ever happened
    assert isinstance(ex, QueryFailed)
    assert ex.retry_after_s == 10.0
    assert fake_clock.sleeps == []
    assert len(ex.attempts) == 1 and ex.attempts[0]["classified"] \
        == TRANSIENT
    assert session.metrics_snapshot()["serve.retries"] == 0


def test_retries_exhausted_gives_typed_query_failed(fake_clock):
    session = _session()
    graph = _graph(session)
    policy = RetryPolicy(max_attempts=3, backoff_base_s=0.1, jitter=0.0)
    with QueryServer(session, graph=graph,
                     config=ServerConfig(workers=1, retry=policy)) as server:
        with failing_operator("Filter", n_times=None):  # permanent
            h = server.submit(Q_ORDER, {"min": 30})
            ex = h.exception(timeout=30)
    assert isinstance(ex, QueryFailed)
    assert len(ex.attempts) == 3            # max_attempts executions
    assert all(a["classified"] == TRANSIENT for a in ex.attempts)
    assert ex.retry_after_s > 0             # Overloaded-style hint
    assert fake_clock.sleeps == [0.1, 0.2]  # backoffs BETWEEN attempts


def test_retry_emits_tracer_events():
    session = _session(trace=True)
    graph = _graph(session)
    policy = RetryPolicy(backoff_base_s=0.0, jitter=0.0)
    with QueryServer(session, graph=graph,
                     config=ServerConfig(workers=1, retry=policy)) as server:
        with failing_operator("Filter", n_times=1):
            server.submit(Q_ORDER, {"min": 30}).rows(timeout=30)

    def walk(spans):
        for sp in spans:
            yield sp
            yield from walk(sp.children)

    spans = list(walk(session.tracer.spans))
    retry_events = [sp for sp in spans if sp.name == "retry.attempt"]
    assert retry_events and retry_events[0].attrs["error"] \
        == "OutOfMemoryError"
    assert any(sp.name == "op.error" for sp in spans)


# -- quarantine + degraded ladder ------------------------------------------

def test_poisoned_plan_quarantines_and_recovers_degraded():
    session = _session()
    graph = _graph(session)
    graph.cypher(Q_ORDER, {"min": 30})  # warm: park a cached plan
    key = session._plan_cache_key(graph, Q_ORDER, {"min": 30})
    assert session.plan_cache.lookup(key, {"min": 30}) is not None
    with QueryServer(session, graph=graph,
                     config=ServerConfig(workers=1)) as server:
        # a non-transient, non-fatal error: suspected poisoned plan.
        # The fused executor answers a failed replay by re-recording
        # (backends/cuda/fused.py), so the fault fires twice — the
        # replay and its re-record — before it reaches the server; the
        # degraded replan re-execution then succeeds.
        with failing_operator("OrderBy", exc=RuntimeError("poison"),
                              n_times=2):
            h = server.submit(Q_ORDER, {"min": 30})
            rows = h.rows(timeout=30)
    assert [r["n"] for r in rows] == ["Alice", "Bob", "Dana"]
    attempts = h.info["attempts"]
    assert attempts[0]["classified"] == POISONED_PLAN
    assert attempts[1] == {"mode": "replan", "ok": True, "device": 0}
    # the suspected entry was evicted (quarantined), not served again
    assert session.plan_cache.quarantined >= 1
    snap = session.metrics_snapshot()
    assert snap["serve.quarantined"] >= 1
    assert snap["serve.degraded_exec"] >= 1
    assert snap["plan_cache.quarantined"] >= 1


def test_degraded_ladder_exhausts_to_query_failed():
    session = _session()
    graph = _graph(session)
    with QueryServer(session, graph=graph,
                     config=ServerConfig(workers=1)) as server:
        with failing_operator("OrderBy", exc=RuntimeError("always"),
                              n_times=None):
            h = server.submit(Q_ORDER, {"min": 30})
            ex = h.exception(timeout=30)
    assert isinstance(ex, QueryFailed)
    # the full ladder ran: fused -> replan -> unfused, each failed
    assert [a["mode"] for a in ex.attempts] == ["fused", "replan",
                                                "unfused"]
    assert "ladder exhausted" in str(ex)


def test_session_cypher_degraded_bypasses_plan_cache():
    session = _session()
    graph = _graph(session)
    graph.cypher(Q_ORDER, {"min": 30})  # park an entry
    hits_before = session.plan_cache.hits
    r = session.cypher_degraded(graph, Q_ORDER, {"min": 30})
    assert [row["n"] for row in r.records.to_maps()] == ["Alice", "Bob",
                                                         "Dana"]
    # no lookup, no store: the cache was not touched in either direction
    assert session.plan_cache.hits == hits_before
    assert r.metrics["plan_cache"] == "off"


def test_fused_replay_keeps_memo_on_transient_device_error():
    session = _session()
    graph = create_graph(session, SOCIAL)
    graph.cypher(Q_COUNT, {"y": 2015})  # record
    graph.cypher(Q_COUNT, {"y": 2015})  # replay ok
    recordings = session.fused.recordings
    mismatches = session.fused.mismatches
    with failing_operator("Scan", n_times=1):  # transient OOM in replay
        with pytest.raises(Exception):
            graph.cypher(Q_COUNT, {"y": 2015})
    # the sound recording was NOT dropped or counted as divergence...
    assert session.fused.mismatches == mismatches
    assert session.fused.recordings == recordings
    replays = session.fused.replays
    # ...so the healed retry replays sync-free again
    assert graph.cypher(Q_COUNT, {"y": 2015}).records.to_maps() \
        == [{"c": 3}]
    assert session.fused.replays == replays + 1


# -- circuit breaker -------------------------------------------------------

def test_breaker_transitions_open_half_open_closed(fake_clock):
    reg = MetricsRegistry()
    br = CircuitBreaker(reg, failure_threshold=2, cooldown_s=10.0)
    key = ("family",)
    assert br.admit(key) == (ALLOW, 0.0)
    assert br.record_failure(key, RuntimeError("a")) is False
    assert br.state(key) == CLOSED
    assert br.record_failure(key, RuntimeError("b")) is True  # trips
    assert br.state(key) == OPEN
    verdict, retry_after = br.admit(key)
    assert verdict == REJECT and 0 < retry_after <= 10.0
    fake_clock.advance(10.0)
    assert br.admit(key) == (TRIAL, 0.0)      # half-open probe
    assert br.state(key) == HALF_OPEN
    assert br.admit(key)[0] == REJECT         # one probe at a time
    br.record_success(key)                    # probe succeeded
    assert br.state(key) == CLOSED
    assert br.admit(key) == (ALLOW, 0.0)
    # failed probe path: straight back to open with a fresh cooldown
    br.record_failure(key, RuntimeError("c"))
    br.record_failure(key, RuntimeError("d"))
    fake_clock.advance(10.0)
    assert br.admit(key) == (TRIAL, 0.0)
    assert br.record_failure(key, RuntimeError("e")) is True
    assert br.state(key) == OPEN
    assert br.admit(key)[0] == REJECT
    assert reg.counter("serve.breaker.opened").value == 3
    assert reg.snapshot()["serve.breaker.open"] == 1


def test_breaker_trips_family_and_isolates_others(fake_clock):
    session = _session()
    graph = _graph(session)
    policy = RetryPolicy(max_attempts=2, backoff_base_s=0.01, jitter=0.0)
    config = ServerConfig(workers=1, retry=policy, breaker_threshold=2,
                          breaker_cooldown_s=30.0)
    with QueryServer(session, graph=graph, config=config) as server:
        with failing_operator("OrderBy", exc=RuntimeError("fam-A dead"),
                              n_times=None):
            # K=2 request-level failures trip family A's breaker
            for _ in range(2):
                ex = server.submit(Q_ORDER, {"min": 30}).exception(
                    timeout=30)
                assert isinstance(ex, QueryFailed)
            assert server.health() == "degraded"
            # family A now fast-fails with the remaining cooldown...
            ex = server.submit(Q_ORDER, {"min": 30}).exception(timeout=30)
            assert isinstance(ex, CircuitOpen)
            assert isinstance(ex, ServeError)
            assert 0 < ex.retry_after_s <= 30.0
            # ...while families B and C keep serving normally
            assert server.run(Q_COUNT, {"y": 2015}).to_maps() == [{"c": 3}]
            assert _bag(server.submit(Q_EDGE, {"min": 40}).rows(
                timeout=30)) == _bag([{"a": "Bob", "b": "Carol"}])
        # fault lifted + cooldown elapsed: the half-open trial heals it
        fake_clock.advance(30.0)
        rows = server.submit(Q_ORDER, {"min": 30}).rows(timeout=30)
        assert [r["n"] for r in rows] == ["Alice", "Bob", "Dana"]
        assert server.health() == "healthy"
        stats = server.stats()
        assert stats["breakers"]["counts"][OPEN] == 0
        assert stats["breaker.opened"] == 1
        assert stats["breaker.closed"] == 1
        assert stats["breaker.fast_fail"] >= 1


def test_half_open_trial_is_single_probe(fake_clock):
    """Exactly ONE probe executes when a batch arrives at a half-open
    breaker; its success closes the breaker and the siblings serve as a
    normal batch."""
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(workers=1, max_batch=8,
                                             breaker_threshold=1,
                                             breaker_cooldown_s=10.0))
    # trip the family open (threshold 1, workers never started — the
    # test thread drives the worker path directly, deterministically)
    with failing_operator("OrderBy", exc=RuntimeError("poison"),
                          n_times=None):
        bad = server.submit(Q_ORDER, {"min": 30})
        server._execute_batch(server.batcher.next_batch(timeout=0),
                              server.devices.replicas[0])
        assert isinstance(bad.exception(), QueryFailed)
    assert server.health() == "degraded"
    # fault lifted; three same-family requests queue during cooldown
    handles = [server.submit(Q_ORDER, {"min": m}) for m in (30, 40, 20)]
    fake_clock.advance(10.0)
    server._execute_batch(server.batcher.next_batch(timeout=0),
                              server.devices.replicas[0])
    # one probe (batch of 1), then the siblings as one normal batch
    assert handles[0].info["batch_size"] == 1
    assert [h.info["batch_size"] for h in handles[1:]] == [2, 2]
    assert [r["n"] for r in handles[0].rows()] == ["Alice", "Bob", "Dana"]
    assert [r["n"] for r in handles[1].rows()] == ["Bob", "Dana"]
    assert len(handles[2].rows()) == 4
    assert server.health() == "healthy"
    server.shutdown(drain=False)


def test_failed_half_open_probe_fast_fails_siblings(fake_clock):
    session = _session()
    graph = _graph(session)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(workers=1, max_batch=8,
                                             breaker_threshold=1,
                                             breaker_cooldown_s=10.0))
    with failing_operator("OrderBy", exc=RuntimeError("poison"),
                          n_times=None):
        bad = server.submit(Q_ORDER, {"min": 30})
        server._execute_batch(server.batcher.next_batch(timeout=0),
                              server.devices.replicas[0])
        assert isinstance(bad.exception(), QueryFailed)
        handles = [server.submit(Q_ORDER, {"min": m}) for m in (30, 40)]
        fake_clock.advance(10.0)
        server._execute_batch(server.batcher.next_batch(timeout=0),
                              server.devices.replicas[0])
        # the probe failed again: it carries the real error, the sibling
        # fast-fails typed without touching the device
        assert isinstance(handles[0].exception(), QueryFailed)
        assert isinstance(handles[1].exception(), CircuitOpen)
    assert server.health() == "degraded"
    server.shutdown(drain=False)


def test_ops_errors_counted_once_per_failure():
    """A leaf-operator failure unwinds through every ancestor's lazy
    child evaluation — the telemetry must still fire exactly once."""
    session = _session()
    graph = _graph(session)
    counter = session.metrics_registry.counter("ops.errors")
    before = counter.value
    with failing_operator("Scan", exc=RuntimeError("leaf"), n_times=1):
        with pytest.raises(RuntimeError):
            graph.cypher(Q_ORDER, {"min": 30})  # Scan under Filter/OrderBy
    assert counter.value - before == 1


# -- batch member isolation (satellite regression) -------------------------

def test_batch_member_retry_isolated_from_siblings():
    session = _session()
    graph = _graph(session)
    graph.cypher(Q_ORDER, {"min": 20})  # warm the family's plan
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(
                             workers=1, max_batch=8,
                             retry=RetryPolicy(backoff_base_s=0.0,
                                               jitter=0.0)))
    handles = [server.submit(Q_ORDER, {"min": m}) for m in (20, 30, 40)]
    with failing_operator("OrderBy", n_times=1):  # exactly ONE member hit
        server.start()
        server.shutdown()
    # they coalesced into one batch...
    assert [h.info["batch_size"] for h in handles] == [3, 3, 3]
    # ...every member resolved to its own correct rows
    assert [r["n"] for r in handles[0].rows()] == ["Alice", "Bob",
                                                   "Carol", "Dana"]
    assert [r["n"] for r in handles[1].rows()] == ["Alice", "Bob", "Dana"]
    assert [r["n"] for r in handles[2].rows()] == ["Bob", "Dana"]
    # exactly one member carries a retry history; the siblings never saw
    # the injector's exception or anyone else's attempt context
    histories = [h.info.get("attempts") for h in handles]
    with_history = [a for a in histories if a is not None]
    assert len(with_history) == 1
    assert [a.get("ok", False) for a in with_history[0]] == [False, True]
    assert with_history[0][0]["op"] == "OrderBy"
    assert session.metrics_snapshot()["serve.completed"] == 3


def test_cypher_batch_isolates_fresh_exceptions_per_member():
    session = _session()
    graph = _graph(session)
    q = Q_ORDER
    graph.cypher(q, {"min": 20})  # warm
    # each member fails its replay and the fused executor's re-record
    with failing_operator("OrderBy", exc=RuntimeError("template"),
                          n_times=4):
        out = session.cypher_batch(graph, [(q, {"min": 20}),
                                           (q, {"min": 30})])
    assert isinstance(out[0], RuntimeError)
    assert isinstance(out[1], RuntimeError)
    assert out[0] is not out[1]  # no shared mutable error object


# -- the acceptance soak ---------------------------------------------------

def _soak(n_threads: int, per_thread: int, fault_fraction: float = 0.2):
    session = _session()
    graph = _graph(session)
    flat = [(Q_ORDER, {"min": m}) for m in (20, 30, 40, 50)] + \
           [(Q_EDGE, {"min": m}) for m in (25, 35, 45)] + \
           [(Q_COUNT, {"y": y}) for y in (2011, 2015, 2020)]
    expected = {i: _bag(graph.cypher(q, b).records.to_maps())
                for i, (q, b) in enumerate(flat)}

    total = n_threads * per_thread
    n_faults = int(total * fault_fraction)
    # breaker_threshold is raised out of the way: this soak exercises
    # the RETRY path's availability; the breaker has its own tests
    server = QueryServer(session, graph=graph, config=ServerConfig(
        workers=4, max_queue=4096, max_batch=8, breaker_threshold=100,
        retry=RetryPolicy(max_attempts=4, backoff_base_s=0.001,
                          backoff_max_s=0.01)))
    results: dict = {}
    submit_errors: list = []

    def client(tid: int):
        try:
            for j in range(per_thread):
                i = (tid * 7 + j) % len(flat)
                q, b = flat[i]
                results[(tid, j)] = (i, server.submit(q, b))
        except Exception as ex:  # pragma: no cover — must not happen
            submit_errors.append(ex)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    # transient single-shot faults land in ~fault_fraction of requests:
    # every 1/fraction-th Filter execution fails once (deterministic
    # spacing — an immediate retry lands between boundaries and heals)
    every_n = max(1, int(round(1.0 / fault_fraction)))
    with failing_operator("Filter", n_times=n_faults, every_n=every_n):
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        server.shutdown()  # graceful drain: every request resolves
    assert not submit_errors, submit_errors
    assert len(results) == total
    # availability: zero worker deaths — every handle completed, every
    # outcome is a result or a typed ServeError
    for i, handle in results.values():
        assert handle.done()
        ex = handle.exception()
        if ex is not None:
            # availability contract: failures are TYPED, never a raw
            # injector exception or a dead handle
            assert isinstance(ex, ServeError), ex
        else:
            # retried results are bag-equal to the fault-free run
            assert _bag(handle.rows()) == expected[i], i
    snap = session.metrics_snapshot()
    assert snap["serve.completed"] + snap["serve.failed"] == total
    assert snap["serve.retries"] > 0          # faults actually landed
    # retry containment: the overwhelming majority heal (a request only
    # fails if ALL its retries re-land on injection boundaries)
    assert snap["serve.completed"] >= total * 0.95
    return snap


def test_soak_transient_faults_eight_clients():
    _soak(n_threads=8, per_thread=8)


def test_serve_error_lint_is_clean():
    """``scripts/check_serve_errors.py``'s lint (capslint's
    error-taxonomy pass, the JAX package's tool) over the port's
    ``serve/``: every error raised there is a ServeError, exceptions are
    stamped first-writer-wins, and the worker path reaches classify."""
    import dataclasses
    import os
    from caps_tpu.analysis.core import (AnalysisConfig, load_project,
                                        run_passes)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    serve = os.path.join(root, "caps_tpu_torch", "serve")
    cfg = dataclasses.replace(
        AnalysisConfig(), package_dir="caps_tpu_torch",
        serve_dir="caps_tpu_torch/serve",
        errors_rel="caps_tpu_torch/serve/errors.py",
        expected_serve_modules=frozenset(
            f for f in os.listdir(serve) if f.endswith(".py")),
        worker_roots=(("caps_tpu_torch/serve/server.py",
                       "QueryServer._worker_loop"),))
    assert {"server.py", "devices.py", "failure.py"} \
        <= cfg.expected_serve_modules
    assert run_passes(load_project(root, cfg),
                      only=["error-taxonomy"]) == []
