"""Seeded chaos harness in the port (testing/chaos.py): the
counterpart of ``tests/test_chaos.py`` with ``backend="cpu"`` backends
— deterministic schedules, the runner pump, the chaos-owned injectors,
and the invariant checkers — plus the cross-package check that the same
seed composes the same schedule, digest for digest, in both packages.

The contracts under test:

* determinism — the same seed composes the byte-identical schedule
  (attested by the sha256 digest), a different seed a different one;
  the headline event is pinned at its fraction of the soak;
* schedule validity — every drawn event names a resolvable injector,
  lands inside the soak window, and carries params from the sampler
  menu; events sort by time;
* the runner is a pure pump — ``poll(elapsed)`` fires exactly the due
  events, in order, once; process-level events delegate to host
  actions; a schedule naming an injector the runner cannot apply is
  rejected AT CONSTRUCTION (never half-way into a soak);
* chaos-owned injectors — ``chaos_fault`` stamps ``caps_chaos_fault``
  (first-writer-wins) on the fresh WireError it raises and counts
  ``faults.injected.chaos_fault``; ``slow_backend`` delays frames to
  exactly ONE peer (matched by remote port) and leaves the rest of the
  fleet untouched;
* invariants — per-reader snapshot-version regressions, availability
  floors, fence violations, and oracle-digest mismatches each fail
  their check and count ``chaos.invariant_failures``.
"""
from __future__ import annotations

import pytest

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.metrics import MetricsRegistry, global_registry
from caps_tpu_torch.serve.errors import WireError
from caps_tpu_torch.serve.fleet import BackendSpec, FleetBackend
from caps_tpu_torch.serve.wire import WireClient
from caps_tpu_torch.testing.chaos import (DEFAULT_MENU, PATCH_INJECTORS,
                                          ChaosEvent, ChaosInvariants,
                                          ChaosRunner, ChaosSchedule,
                                          chaos_fault, slow_backend)

PEOPLE = "CREATE (a:Person {name: 'Alice', age: 33})"
Q = "MATCH (p:Person) RETURN p.name AS n"


# -- schedule determinism -----------------------------------------------------

def test_same_seed_composes_the_identical_schedule():
    reg = MetricsRegistry()
    a = ChaosSchedule.compose(42, 10.0, n_events=6,
                              headline="kill_router_active", registry=reg)
    b = ChaosSchedule.compose(42, 10.0, n_events=6,
                              headline="kill_router_active", registry=reg)
    assert a.digest() == b.digest()
    assert [e.as_dict() for e in a.events] \
        == [e.as_dict() for e in b.events]
    assert ChaosSchedule.compose(43, 10.0, n_events=6,
                                 registry=reg).digest() != a.digest()
    assert reg.snapshot()["chaos.schedules_composed"] == 3


def test_composed_events_are_valid_and_time_ordered():
    sched = ChaosSchedule.compose(
        7, 20.0, n_events=12, targets=("b0", "b1"),
        headline="kill_router_active", headline_at_frac=0.4,
        registry=MetricsRegistry())
    assert len(sched.events) == 13
    times = [e.at_s for e in sched.events]
    assert times == sorted(times)
    headline = [e for e in sched.events
                if e.injector == "kill_router_active"]
    assert len(headline) == 1
    assert headline[0].at_s == pytest.approx(8.0)  # pinned at 0.4×20s
    for ev in sched.events:
        assert ev.injector in set(DEFAULT_MENU) | {"kill_router_active"}
        assert 0.0 < ev.at_s < 20.0
        if ev.injector != "kill_router_active":
            assert ev.target in ("b0", "b1")


def test_digest_covers_every_event_field():
    base = ChaosSchedule(1, 5.0, [ChaosEvent(1.0, "chaos_fault", None,
                                             (("n_times", 1),))])
    for other in (
            ChaosSchedule(1, 5.0, [ChaosEvent(2.0, "chaos_fault", None,
                                              (("n_times", 1),))]),
            ChaosSchedule(1, 5.0, [ChaosEvent(1.0, "drop_connection",
                                              None, (("n_times", 1),))]),
            ChaosSchedule(1, 5.0, [ChaosEvent(1.0, "chaos_fault", "b0",
                                              (("n_times", 1),))]),
            ChaosSchedule(1, 5.0, [ChaosEvent(1.0, "chaos_fault", None,
                                              (("n_times", 2),))]),
            ChaosSchedule(1, 6.0, [ChaosEvent(1.0, "chaos_fault", None,
                                              (("n_times", 1),))])):
        assert other.digest() != base.digest()


# -- the runner pump ----------------------------------------------------------

def test_runner_fires_due_events_once_in_order():
    sched = ChaosSchedule(1, 10.0, [
        ChaosEvent(2.0, "kill_router_active", None, ()),
        ChaosEvent(5.0, "kill_backend", "b1", ()),
        ChaosEvent(8.0, "kill_backend", "b2", ()),
    ])
    fired = []
    reg = MetricsRegistry()
    actions = {"kill_router_active": lambda ev: fired.append("router"),
               "kill_backend": lambda ev: fired.append(ev.target)}
    with ChaosRunner(sched, actions=actions, registry=reg) as runner:
        assert runner.poll(1.0) == []
        assert runner.pending() == 3
        assert [e.at_s for e in runner.poll(5.0)] == [2.0, 5.0]
        assert runner.poll(5.0) == []          # never re-fires
        assert runner.poll(20.0)[0].at_s == 8.0
        assert runner.pending() == 0
    assert fired == ["router", "b1", "b2"]
    assert len(runner.applied) == 3
    assert reg.snapshot()["chaos.events_applied"] == 3


def test_runner_rejects_unresolvable_injectors_at_construction():
    sched = ChaosSchedule(1, 5.0, [
        ChaosEvent(1.0, "unplugged_rack", None, ())])
    with pytest.raises(KeyError, match="unplugged_rack"):
        ChaosRunner(sched, registry=MetricsRegistry())
    # the same schedule is fine once the host supplies the action
    ChaosRunner(sched, actions={"unplugged_rack": lambda ev: None},
                registry=MetricsRegistry())


def test_every_menu_injector_resolves_in_process():
    for name in DEFAULT_MENU:
        assert name in PATCH_INJECTORS


# -- chaos-owned injectors ----------------------------------------------------

@pytest.fixture
def backend():
    b = FleetBackend(BackendSpec(name="c0", backend="cpu",
                                 graph={"kind": "script",
                                        "create": PEOPLE}))
    yield b
    b.shutdown(drain=False)


def test_chaos_fault_stamps_marker_and_counts(backend):
    before = global_registry().snapshot().get(
        "faults.injected.chaos_fault", 0)
    with WireClient("127.0.0.1", backend.port) as client:
        assert client.call("ping")["name"] == "c0"
        with chaos_fault(n_times=1) as budget:
            with pytest.raises(WireError) as exc_info:
                client.call("query", query=Q)
            # attribution: the SCHEDULE injected this, first-writer-wins
            assert exc_info.value.caps_chaos_fault is True
            # budgeted: the next send goes through untouched
            assert [r["n"] for r in
                    client.call("query", query=Q)["rows"]] == ["Alice"]
        assert budget.injected == 1
    assert global_registry().snapshot()[
        "faults.injected.chaos_fault"] == before + 1


def test_slow_backend_delays_exactly_one_peer(backend):
    other = FleetBackend(BackendSpec(name="c1", backend="cpu",
                                     graph={"kind": "script",
                                            "create": PEOPLE}))
    try:
        sleeps = []
        orig_sleep = clock.sleep
        with WireClient("127.0.0.1", backend.port) as slow_c, \
                WireClient("127.0.0.1", other.port) as fast_c:
            slow_c.call("ping"), fast_c.call("ping")
            with slow_backend(backend.port, 0.01) as budget:
                # record rather than wait: the injector sleeps through
                # obs.clock, so the test observes without paying
                clock.sleep = sleeps.append
                try:
                    slow_c.call("query", query=Q)
                    fast_c.call("query", query=Q)
                    fast_c.call("query", query=Q)
                finally:
                    clock.sleep = orig_sleep
        # only frames TO the targeted port were delayed — the other
        # peer's traffic never consumed the budget
        assert sleeps == [0.01]
        assert budget.injected == 1
    finally:
        other.shutdown(drain=False)


# -- invariants ---------------------------------------------------------------

def test_invariants_all_green():
    inv = ChaosInvariants(registry=MetricsRegistry())
    inv.note_read("r0", True, version=1)
    inv.note_read("r0", True, version=2)
    inv.note_write_ack()
    inv.note_fence(refused=True)
    report = inv.report(availability_floor=0.9, oracle_digest="d",
                        observed_digest="d")
    assert report["ok"] is True
    assert all(report["checks"].values())
    assert report["availability"] == 1.0


def test_stale_read_is_a_version_regression_per_reader():
    reg = MetricsRegistry()
    inv = ChaosInvariants(registry=reg)
    inv.note_read("r0", True, version=3)
    inv.note_read("r1", True, version=1)   # another reader lags: fine
    inv.note_read("r0", True, version=2)   # r0 went BACK in time
    report = inv.report()
    assert report["checks"]["no_stale_reads"] is False
    assert report["stale_reads"] == 1
    assert reg.snapshot()["chaos.invariant_failures"] == 1


def test_availability_floor_and_fence_violations_fail_checks():
    reg = MetricsRegistry()
    inv = ChaosInvariants(registry=reg)
    inv.note_read("r0", True)
    inv.note_read("r0", False)
    inv.note_fence(refused=False)          # a zombie write APPLIED
    report = inv.report(availability_floor=0.9)
    assert report["availability"] == 0.5
    assert report["checks"]["availability"] is False
    assert report["checks"]["no_zombie_application"] is False
    assert reg.snapshot()["chaos.invariant_failures"] == 2


def test_acked_write_parity_requires_matching_digests():
    inv = ChaosInvariants(registry=MetricsRegistry())
    report = inv.report(oracle_digest="aa", observed_digest="bb")
    assert report["checks"]["acked_write_parity"] is False
    # no digests supplied → the check is absent, not vacuously true
    assert "acked_write_parity" not in ChaosInvariants(
        registry=MetricsRegistry()).report()["checks"]


# -- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 42, 2026])
@pytest.mark.parametrize("menu,targets,headline", [
    (DEFAULT_MENU, (), None),
    (tuple(sorted(PATCH_INJECTORS)) + ("kill_backend",), ("b0", "b1", "b2"),
     "kill_router_active"),
], ids=["default", "full"])
def test_same_seed_same_digest_as_the_reference(seed, menu, targets,
                                                headline):
    from caps_tpu.testing import chaos as jax_chaos
    kw = dict(menu=menu, targets=targets, n_events=12, headline=headline,
              registry=MetricsRegistry())
    port = ChaosSchedule.compose(seed, 30.0, **kw)
    ref = jax_chaos.ChaosSchedule.compose(seed, 30.0, **kw)
    assert port.as_dict() == ref.as_dict()
    assert port.digest() == ref.digest()
