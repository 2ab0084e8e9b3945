"""Serving telemetry on the port: windowed SLOs, the flight recorder,
the Prometheus exposition and the chrome trace's device lanes — the
serving cases of ``tests/test_telemetry.py``.

Window rotation, quantiles, and burn-rate math run against a fake
``obs.clock`` so bucket expiry is asserted exactly with zero
real waiting.  The flight-recorder auto-dump triggers (breaker trip,
device quarantine, compaction failure) reuse the fault-injection
harness; the observed-statistics store is checked for fused-replay
parity against PROFILE's cardinalities; ``expose_text`` gets a golden
format test plus a line-grammar validation of a live server scrape.
"""
from __future__ import annotations

import re
import threading

import pytest

import caps_tpu_torch
from caps_tpu_torch.okapi.config import EngineConfig
from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.metrics import MetricsRegistry
from caps_tpu_torch.obs.telemetry import (
    FlightRecorder, RollingCounter, RollingHistogram, ServingTelemetry,
    SLOConfig,
)
from caps_tpu_torch.serve import (QueryServer, RetryPolicy, ServerConfig)
from caps_tpu_torch.serve.admission import AdmissionController
from caps_tpu_torch.testing.factory import create_graph
from caps_tpu_torch.testing.faults import device_loss, failing_operator

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
    """Same fake as tests/test_faults.py: ``sleep`` advances ``now``
    instantly; ``wait`` honors an already-fired event with no time
    passing."""

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


# -- rolling-window primitives (exact rotation semantics) --------------------

def test_rolling_counter_bucket_expiry_exact():
    c = RollingCounter(window_s=60.0, buckets=60)  # 1 s per slot
    t0 = 1_000.0
    c.inc(t0, 3)
    assert c.total(t0) == 3
    # anywhere inside the window the sample is live...
    assert c.total(t0 + 59.0) == 3
    # ...and the slot is cleared exactly when its epoch recycles
    assert c.total(t0 + 60.0) == 0
    # a gap far beyond the window clears everything in one step
    c.inc(t0 + 61.0, 5)
    assert c.total(t0 + 500.0) == 0


def test_rolling_counter_accumulates_across_slots():
    c = RollingCounter(window_s=10.0, buckets=10)
    t0 = 1_000.0
    for k in range(5):
        c.inc(t0 + k, 1)       # one per slot
    assert c.total(t0 + 4) == 5
    # advancing 6 more seconds expires exactly the first slot
    assert c.total(t0 + 10.0) == 4


def test_rolling_histogram_quantiles_and_rotation():
    h = RollingHistogram(window_s=60.0, buckets=60,
                         bounds=(0.001, 0.01, 0.1, 1.0))
    t0 = 1_000.0
    for _ in range(9):
        h.observe(t0, 0.0005)          # le 0.001 bucket
    h.observe(t0 + 30.0, 0.5)          # le 1.0 bucket, later slot
    assert h.count(t0 + 30.0) == 10
    # quantiles are bucket upper bounds: rank 5 of 10 falls in the
    # first bucket, rank 10 in the 1.0 bucket
    assert h.quantile(t0 + 30.0, 0.50) == 0.001
    assert h.quantile(t0 + 30.0, 0.99) == 1.0
    # rotate the early slot out: only the 0.5 sample survives
    assert h.count(t0 + 65.0) == 1
    assert h.quantile(t0 + 65.0, 0.50) == 1.0
    assert h.mean(t0 + 65.0) == 0.5
    # the +Inf tail serves the window max, not a fake bound
    h.observe(t0 + 65.0, 7.5)
    assert h.quantile(t0 + 65.0, 0.99) == 7.5
    # empty window: quantiles are None
    assert h.quantile(t0 + 300.0, 0.5) is None
    assert h.mean(t0 + 300.0) is None


# -- SLO / burn-rate math ----------------------------------------------------

def test_slo_burn_rate_math_exact(fake_clock):
    reg = MetricsRegistry()
    tel = ServingTelemetry(reg, window_s=60.0, buckets=60,
                           slo=SLOConfig(latency_target_s=0.1,
                                         latency_objective=0.9,
                                         availability_objective=0.9))
    for _ in range(8):
        tel.note_result("fam", 0.01, "ok")     # within target
    for _ in range(2):
        tel.note_result("fam", 0.5, "ok")      # over target
    for _ in range(2):
        tel.note_result("fam", 0.2, "error")
    rep = tel.slo_report()
    assert rep["latency_compliance"] == pytest.approx(0.8)
    # burn = (1 - 0.8) / (1 - 0.9) = 2.0: the error budget burns twice
    # as fast as it accrues
    assert rep["latency_burn_rate"] == pytest.approx(2.0)
    assert rep["availability"] == pytest.approx(10 / 12)
    assert rep["availability_burn_rate"] == pytest.approx(
        (1 - 10 / 12) / 0.1, rel=1e-3)
    assert rep["within_budget"] is False
    # the registry gauges serve the same numbers live
    snap = reg.snapshot()
    assert snap["slo.latency_burn_rate"] == pytest.approx(2.0)
    assert snap["slo.latency_compliance"] == pytest.approx(0.8)
    # ...and the incident rotates out of the window: budget stops burning
    fake_clock.advance(61.0)
    rep2 = tel.slo_report()
    assert rep2["latency_compliance"] == 1.0
    assert rep2["latency_burn_rate"] == 0.0
    assert rep2["within_budget"] is True


def test_slo_report_none_without_config(fake_clock):
    tel = ServingTelemetry(MetricsRegistry())
    tel.note_result("fam", 0.01, "ok")
    assert tel.slo_report() is None


def test_summary_rates_aborts_and_window_expiry(fake_clock):
    reg = MetricsRegistry()
    tel = ServingTelemetry(reg, window_s=60.0, buckets=60)
    for _ in range(6):
        tel.note_result("famA", 0.002, "ok")
    tel.note_result("famA", 0.002, "abort")
    tel.note_retry()
    tel.note_shed()
    s = tel.summary()
    assert s["requests"] == 7
    assert s["latency"]["count"] == 6        # aborts carry no latency
    assert s["rates_per_s"]["aborts"] > 0
    assert s["rates_per_s"]["shed"] > 0
    assert s["rates_per_s"]["retries"] > 0
    assert "famA" in s["families"]
    fake_clock.advance(61.0)
    s2 = tel.summary()
    assert s2["requests"] == 0 and s2["qps"] == 0.0
    assert s2["latency"]["count"] == 0 and s2["latency"]["p99_s"] is None


# -- the stale retry_after hint (satellite regression) -----------------------

def test_retry_after_prefers_window_over_stale_ema(fake_clock):
    reg = MetricsRegistry()
    tel = ServingTelemetry(reg, window_s=60.0, buckets=60)
    adm = AdmissionController(reg, workers=1, telemetry=tel)
    # a one-off slow burst: both the forever-EMA and the window see 10 s
    adm.observe_service(10.0)
    tel.note_service(10.0)
    assert adm.retry_after_s(depth=4) == pytest.approx(40.0)
    # load subsides; much later ONE fast request arrives.  The EMA still
    # remembers the burst (0.8 * 10 + 0.2 * 0.01 ≈ 8 s); the window has
    # rotated it out and reports the honest recent service time.
    fake_clock.advance(120.0)
    adm.observe_service(0.01)
    tel.note_service(0.01)
    assert adm.ema_service_s > 1.0                       # EMA is stale
    assert adm.retry_after_s(depth=4) == pytest.approx(0.04)
    adm.close()


def test_retry_after_falls_back_to_ema_without_samples(fake_clock):
    reg = MetricsRegistry()
    tel = ServingTelemetry(reg, window_s=60.0, buckets=60)
    adm = AdmissionController(reg, workers=1, telemetry=tel)
    adm.observe_service(2.0)
    # empty window (no note_service yet): the EMA carries the estimate
    assert adm.retry_after_s(depth=2) == pytest.approx(4.0)
    no_tel = AdmissionController(reg, workers=1)
    no_tel.observe_service(2.0)
    assert no_tel.retry_after_s(depth=2) == pytest.approx(4.0)
    adm.close()
    no_tel.close()


# -- flight recorder ---------------------------------------------------------

def test_flight_recorder_ring_bounds_and_dumps():
    fr = FlightRecorder(capacity=4, max_dumps=2)
    for k in range(6):
        fr.record({"i": k})
    snap = fr.snapshot()
    assert [r["i"] for r in snap] == [2, 3, 4, 5]   # oldest two evicted
    assert fr.recorded == 6
    d = fr.dump("manual")
    assert d["reason"] == "manual" and len(d["records"]) == 4
    # the dump is a copy: mutating it never touches the live ring
    d["records"].clear()
    assert len(fr.snapshot()) == 4
    assert list(fr.dumps) == []                     # store=False default
    for k in range(3):
        fr.dump(f"auto{k}", store=True)
    assert [x["reason"] for x in fr.dumps] == ["auto1", "auto2"]  # bounded


def test_breaker_trip_auto_dumps_with_attempt_histories():
    session = _session()
    graph = create_graph(session, SOCIAL)
    server = QueryServer(session, graph=graph, config=ServerConfig(
        workers=2, breaker_threshold=2, breaker_cooldown_s=30.0))
    try:
        graph.cypher(Q_ORDER, {"min": 0})  # warm the healthy plan
        with failing_operator("OrderBy", exc=RuntimeError("poison"),
                              n_times=None):
            for _ in range(2):             # threshold consecutive failures
                with pytest.raises(Exception):
                    server.run(Q_ORDER, {"min": 0})
        dumps = server.telemetry.flight_dumps
        assert dumps and dumps[-1]["reason"] == "breaker_trip"
        failing = [r for r in dumps[-1]["records"]
                   if r["outcome"] == "QueryFailed"]
        assert failing, dumps[-1]["records"]
        # the black box carries the full containment ladder per failure
        for rec in failing:
            assert rec["attempts"], rec
            assert {a["mode"] for a in rec["attempts"]} >= {"fused",
                                                            "replan"}
        assert session.metrics_snapshot()[
            "telemetry.flight_recorder.dumps"] >= 1
        # healthy traffic after the trip still records normally
        assert server.run(Q_COUNT).to_maps() == [{"c": 4}]
    finally:
        server.shutdown()


def test_breaker_trip_dump_is_written_before_the_client_fails():
    """The worker writes the breaker-trip dump before it completes the
    tripping request's handle: a dump that takes its time is still there
    when the client sees the failure."""
    session = _session()
    graph = create_graph(session, SOCIAL)
    server = QueryServer(session, graph=graph, config=ServerConfig(
        workers=2, breaker_threshold=1, breaker_cooldown_s=30.0))
    dump = server.telemetry.auto_dump

    def slow_dump(reason):
        threading.Event().wait(0.3)
        return dump(reason)

    server.telemetry.auto_dump = slow_dump
    try:
        graph.cypher(Q_ORDER, {"min": 0})
        with failing_operator("OrderBy", exc=RuntimeError("poison"),
                              n_times=None):
            with pytest.raises(Exception):
                server.run(Q_ORDER, {"min": 0})
        dumps = server.telemetry.flight_dumps
        assert [d["reason"] for d in dumps] == ["breaker_trip"]
        assert any(r["outcome"] == "QueryFailed"
                   for r in dumps[-1]["records"])
    finally:
        server.shutdown()


def test_device_quarantine_auto_dumps(fake_clock):
    session = _session()
    graph = create_graph(session, SOCIAL)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(
                             devices=2, device_failure_threshold=1,
                             device_cooldown_s=10.0,
                             retry=RetryPolicy(backoff_base_s=0.0,
                                               jitter=0.0)))
    r1 = server.devices.replicas[1]
    with device_loss(1):
        h = server.submit(Q_ORDER, {"min": 30})
        batch = server.batcher.next_batch(timeout=0)
        server._execute_batch(batch, r1)       # fails on 1, fails over
        assert [r["n"] for r in h.rows(timeout=5)] == ["Alice", "Bob",
                                                       "Dana"]
    reasons = [d["reason"] for d in server.telemetry.flight_dumps]
    assert "device_quarantine" in reasons
    server.shutdown()


def test_compaction_failure_auto_dumps(make_session):
    from caps_tpu_torch.relational.updates import versioned
    from caps_tpu_torch.testing.faults import flaky_compaction
    s = make_session()
    vg = versioned(s, create_graph(s, "CREATE (:Seed {k:-1})"))
    server = QueryServer(s, graph=vg, config=ServerConfig(
        workers=2, compaction_threshold_rows=2,
        compaction_interval_s=0.005))
    try:
        with flaky_compaction(s, error_rate=1.0, n_times=1) as budget:
            for i in range(4):
                server.submit(f"CREATE (:Item {{k:{i}}})").result(
                    timeout=30)
            deadline = clock.now() + 10.0
            while clock.now() < deadline and budget.injected == 0:
                clock.sleep(0.01)
        deadline = clock.now() + 5.0
        while clock.now() < deadline and not server.telemetry.flight_dumps:
            clock.sleep(0.01)
        assert budget.injected >= 1
        reasons = [d["reason"] for d in server.telemetry.flight_dumps]
        assert "compaction_failure" in reasons
    finally:
        server.shutdown()


# -- Prometheus text exposition ----------------------------------------------

#: one exposition sample line: name, optional labels, a value
_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+="[^"]*"(,[a-zA-Z0-9_]+='
    r'"[^"]*")*\})? [0-9eE.+\-]+$')


def _validate_exposition(text: str) -> int:
    """Line-grammar check of the text format; returns the sample count."""
    samples = 0
    assert text.endswith("\n")
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            assert re.match(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
                            r"(counter|gauge|histogram)$", line), line
            continue
        assert _SAMPLE.match(line), line
        samples += 1
    return samples


def test_expose_text_golden():
    reg = MetricsRegistry()
    reg.counter("serve.completed").inc(3)
    reg.gauge("telemetry.window_qps").set(2.5)
    h = reg.histogram("serve.latency_s", buckets=(0.3, 1.0))
    for v in (0.25, 0.5, 5.0):
        h.observe(v)
    assert reg.expose_text() == (
        "# TYPE serve_completed counter\n"
        "serve_completed 3\n"
        "# TYPE telemetry_window_qps gauge\n"
        "telemetry_window_qps 2.5\n"
        "# TYPE serve_latency_s histogram\n"
        'serve_latency_s_bucket{le="0.3"} 1\n'
        'serve_latency_s_bucket{le="1.0"} 2\n'
        'serve_latency_s_bucket{le="+Inf"} 3\n'
        "serve_latency_s_sum 5.75\n"
        "serve_latency_s_count 3\n")
    # extra windowed values render as gauges; non-numerics are skipped
    text = reg.expose_text(extra={"telemetry.extra_p99_s": 0.125,
                                  "bogus.text": "nope"})
    assert "telemetry_extra_p99_s 0.125" in text
    assert "bogus" not in text
    assert _validate_exposition(text) >= 6


def test_server_metrics_text_scrape_parses():
    session = _session()
    graph = create_graph(session, SOCIAL)
    server = QueryServer(session, graph=graph, config=ServerConfig(
        workers=2, slo=SLOConfig(latency_target_s=1.0)))
    try:
        for _ in range(3):
            server.run(Q_COUNT)
        text = server.metrics_text()
        samples = _validate_exposition(text)
        assert samples > 20
        lines = text.splitlines()
        assert "# TYPE serve_completed counter" in lines
        assert "serve_completed 3" in lines
        # cumulative-le histogram series with the +Inf terminator
        assert any(l.startswith('serve_latency_s_bucket{le="') for l in lines)
        assert 'serve_latency_s_count 3' in lines
        # the windowed gauges ride the same scrape
        assert any(l.startswith("telemetry_window_qps ") for l in lines)
        assert any(l.startswith("slo_latency_burn_rate ") for l in lines)
        # bucket series are monotonically non-decreasing
        cum = [int(l.rsplit(" ", 1)[1]) for l in lines
               if l.startswith('serve_latency_s_bucket')]
        assert cum == sorted(cum)
    finally:
        server.shutdown()


# -- observed-statistics store -----------------------------------------------

def test_stats_batching_occupancy(make_session):
    session = _session()
    graph = create_graph(session, SOCIAL)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(workers=1, max_batch=8))
    handles = [server.submit(Q_ORDER, {"min": 30}) for _ in range(4)]
    server.start()
    for h in handles:
        h.result(timeout=10)
    stats = server.stats()
    b = stats["batching"]
    assert b["batches"] == 1 and b["members"] == 4
    assert b["mean_occupancy"] == 4.0
    assert b["window_occupancy"] == 4.0
    server.shutdown()


def test_gauges_follow_live_servers_and_deregister_on_shutdown():
    """Regression: the windowed gauges dispatch to the newest
    LIVE server and deregister on shutdown — a dead server must not
    keep serving (or stay pinned by) the registry callbacks, mirroring
    the admission depth gauge's lifecycle."""
    session = _session()
    graph = create_graph(session, SOCIAL)
    reg = session.metrics_registry
    a = QueryServer(session, graph=graph, config=ServerConfig(
        workers=1, slo=SLOConfig(latency_target_s=5.0)))
    for _ in range(2):
        a.run(Q_COUNT)
    assert reg.snapshot()["telemetry.window_qps"] > 0
    b = QueryServer(session, graph=graph,
                    config=ServerConfig(workers=1))
    # the newest live server (b, no traffic yet) owns the window gauges
    assert reg.snapshot()["telemetry.window_qps"] == 0.0
    assert b.shutdown()
    # b left the live set: gauges revert to a's still-live window
    assert reg.snapshot()["telemetry.window_qps"] > 0
    assert reg.snapshot()["slo.availability"] == 1.0
    assert a.shutdown()
    snap = reg.snapshot()
    assert snap["telemetry.window_qps"] == 0.0
    assert reg._telemetry_live == []


def test_deadline_expiry_counts_as_abort_not_availability_error():
    """Regression: an expired budget is the budget's verdict,
    not the server's — it must not burn the availability SLO (the same
    CancellationError exemption the breaker and device ladder apply)."""
    from caps_tpu_torch.serve import DeadlineExceeded
    from caps_tpu_torch.testing.faults import slow_operator
    session = _session()
    graph = create_graph(session, SOCIAL)
    server = QueryServer(session, graph=graph, config=ServerConfig(
        workers=1, slo=SLOConfig(latency_target_s=5.0,
                                 availability_objective=0.9)))
    try:
        server.run(Q_ORDER, {"min": 0})       # warm the plan
        with slow_operator("Filter", 0.2):
            h = server.submit(Q_ORDER, {"min": 0}, deadline_s=0.05)
            with pytest.raises(DeadlineExceeded):
                h.result(timeout=10)
        rep = server.telemetry.slo_report()
        assert rep["availability"] == 1.0     # the abort never counted
        assert rep["availability_burn_rate"] == 0.0
        s = server.stats()["telemetry"]
        assert s["rates_per_s"]["aborts"] > 0
        assert s["rates_per_s"]["errors"] == 0.0
    finally:
        server.shutdown()


# -- chrome-trace device lanes -----------------------------------------------

def test_chrome_trace_pid_is_device_lane():
    from caps_tpu_torch.obs import chrome_trace_events, tracer as tracer_mod
    from caps_tpu_torch.obs.tracer import Tracer
    prev = tracer_mod._device_index_provider
    tracer_mod.set_device_index_provider(lambda: 3)
    try:
        tr = Tracer(enabled=True)
        with tr.span("query", kind="query"):
            with tr.span("op.Scan", kind="operator"):
                tr.event("tick")
    finally:
        tracer_mod.set_device_index_provider(prev)
    events = chrome_trace_events(tr.spans)
    assert {e["pid"] for e in events} == {3}
    # spans without a device attr inherit the parent's lane (fallback 0)
    from caps_tpu_torch.obs.tracer import Span
    root = Span(name="q", kind="query", attrs={"device": 1}, wall_s=0.01)
    root.children.append(Span(name="op.child", kind="operator",
                              wall_s=0.005))
    lone = Span(name="solo", kind="phase", wall_s=0.001)
    events = chrome_trace_events([root, lone])
    by_name = {e["name"]: e["pid"] for e in events}
    assert by_name == {"q": 1, "op.child": 1, "solo": 0}


def test_serve_devices_installs_tracer_provider():
    from caps_tpu_torch.obs import tracer as tracer_mod
    from caps_tpu_torch.serve import devices
    assert tracer_mod._device_index_provider \
        is devices.executing_device_index


def test_multi_replica_trace_renders_parallel_lanes():
    from caps_tpu_torch.obs import chrome_trace_events
    session = _session()
    graph = create_graph(session, SOCIAL)
    server = QueryServer(session, graph=graph, start=False,
                         config=ServerConfig(devices=2))
    r0, r1 = server.devices.replicas
    # each replica owns its session (and tracer): enable both
    r0.session.tracer.enabled = True
    r1.session.tracer.enabled = True
    try:
        for replica in (r0, r1):
            h = server.submit(Q_ORDER, {"min": 30})
            batch = server.batcher.next_batch(timeout=0)
            server._execute_batch(batch, replica)
            h.result(timeout=5)
    finally:
        r0.session.tracer.enabled = False
        r1.session.tracer.enabled = False
    # replica 1 executes on its CLONE session; collect spans from both
    spans = list(session.tracer.spans) + list(r1.session.tracer.spans)
    pids = {e["pid"] for e in chrome_trace_events(spans)}
    assert {0, 1} <= pids, pids
    server.shutdown()


# -- health_report / stats integration ---------------------------------------

def test_health_report_and_stats_telemetry(make_session):
    session = _session()
    graph = create_graph(session, SOCIAL)
    server = QueryServer(session, graph=graph, config=ServerConfig(
        workers=2, slo=SLOConfig(latency_target_s=5.0,
                                 latency_objective=0.95,
                                 availability_objective=0.99)))
    try:
        for _ in range(5):
            assert server.run(Q_COUNT).to_maps() == [{"c": 4}]
        report = server.health_report()
        assert report["status"] == "healthy"
        assert report["slo"]["within_budget"] is True
        assert report["slo"]["availability"] == 1.0
        win = report["window"]
        assert win["latency"]["count"] == 5
        assert win["latency"]["p99_s"] is not None
        assert win["qps"] > 0
        assert set(report) >= {"status", "slo", "window", "breakers",
                               "devices", "compaction"}
        stats = server.stats()
        assert stats["telemetry"]["requests"] == 5
        assert stats["slo"]["latency_burn_rate"] == 0.0
        # device 0 accumulated windowed busy time
        assert stats["telemetry"]["device_utilization"].get(0, 0) > 0
        # flight recorder saw every request
        dump = server.dump_flight_recorder()
        assert dump["reason"] == "manual"
        assert len(dump["records"]) == 5
        assert all(r["outcome"] == "ok" for r in dump["records"])
    finally:
        server.shutdown()


# -- telemetry window shape through config ------------------------------------

def test_config_window_threads_through_at_non_default_shape(fake_clock):
    """``ServerConfig.telemetry_window_s``/``telemetry_buckets`` reach
    every rolling instrument: at a 10 s window a sample expires exactly
    at +10 s (not the 60 s default), compile seconds included."""
    session = _session()
    server = QueryServer(session, config=ServerConfig(
        telemetry_window_s=10.0, telemetry_buckets=10), start=False)
    try:
        tel = server.telemetry
        assert tel.window_s == 10.0 and tel.buckets == 10
        tel.note_result("fam", 0.2, "ok")
        tel.note_compile(0.7)
        assert tel.summary()["requests"] == 1
        assert tel.window_compile_s() == pytest.approx(0.7)
        fake_clock.advance(9.0)  # still inside the 10 s window
        assert tel.summary()["requests"] == 1
        assert tel.summary()["compile"]["events"] == 1
        fake_clock.advance(2.0)  # past it: everything expired
        assert tel.summary()["requests"] == 0
        assert tel.window_compile_s() == 0.0
        assert tel.summary()["compile"] == {"events": 0, "seconds": 0.0}
        # at the DEFAULT window the same +11 s advance would NOT expire:
        # prove the non-default shape actually took effect
        reg = MetricsRegistry()
        default = ServingTelemetry(reg)
        default.note_result("fam", 0.2, "ok")
        fake_clock.advance(11.0)
        assert default.summary()["requests"] == 1
        default.close()
    finally:
        server.shutdown()


def test_window_compile_seconds_accumulate_and_rotate(fake_clock):
    reg = MetricsRegistry()
    tel = ServingTelemetry(reg, window_s=60.0, buckets=60)
    tel.note_compile(0.5)
    fake_clock.advance(30.0)
    tel.note_compile(0.25)
    assert tel.window_compile_s() == pytest.approx(0.75)
    # the telemetry.compile_s gauge reads the live window
    assert reg.snapshot()["telemetry.compile_s"] == pytest.approx(0.75)
    fake_clock.advance(31.0)  # first charge expired, second still live
    assert tel.window_compile_s() == pytest.approx(0.25)
    fake_clock.advance(30.0)
    assert tel.window_compile_s() == 0.0
    tel.close()
