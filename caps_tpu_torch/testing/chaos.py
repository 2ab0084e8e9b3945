"""Seeded chaos: deterministic fault schedules over the locked patch
points, with invariant checkers for live-fleet soaks.

The fault injectors of testing/faults.py each
prove ONE failure mode in a hand-scripted test.  This module composes
them: a :class:`ChaosSchedule` draws fault events — which injector,
which target, when — from a seeded PRNG, so a soak exercises fault
*combinations* while staying perfectly reproducible:

* same seed ⇒ the identical event list, byte-for-byte, attested by
  :meth:`ChaosSchedule.digest` (a sha256 over the canonical JSON of the
  schedule — `chip_smoke.py` prints it, CI can diff it);
* every in-process event resolves to a ``testing/faults.py``-style
  injector over the SAME locked patch points (``OPERATOR_PATCH._lock``,
  through ``faults._patched``)
  with the same budget discipline, so chaos and hand-scripted faults
  can never fight over a monkey-patch;
* process-level events (SIGKILL a backend, SIGKILL the *active
  router* — the headline scenario) are delegated to host-provided
  actions, keeping this module free of process management.

The :class:`ChaosRunner` is a pure *pump*: the soak loop calls
:meth:`~ChaosRunner.poll` with its own elapsed time and due events
fire — no hidden thread, no wall-clock reads, so a fake-clock test
drives an entire schedule in zero real time.

:class:`ChaosInvariants` collects the soak's observations and renders
the verdicts a chaos soak reports: zero acked-write loss (digest
parity against a serial oracle), no stale reads (per-reader snapshot
versions never regress), an availability floor, and no zombie
application (every fence probe refused).

Chaos-attributed faults are stamped ``caps_chaos_fault``
(first-writer-wins, like every containment marker) so a failure
surfacing through the serving tier's classify/retry ladder stays
attributable to the schedule that injected it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import random
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.metrics import MetricsRegistry, global_registry
from caps_tpu_torch.serve.errors import WireError
from caps_tpu_torch.testing.faults import _Budget, _count_injection, _patched

__all__ = [
    "ChaosEvent", "ChaosSchedule", "ChaosRunner", "ChaosInvariants",
    "chaos_fault", "slow_backend", "PATCH_INJECTORS", "DEFAULT_MENU",
]


# -- chaos-owned injectors ---------------------------------------------------


@contextlib.contextmanager
def chaos_fault(n_times: Optional[int] = 1, every_n: int = 1):
    """While active, eligible fleet wire sends fail with a fresh
    :class:`~caps_tpu_torch.serve.errors.WireError` stamped
    ``caps_chaos_fault`` — the generic chaos-attributed transport
    fault.  Unlike :func:`~caps_tpu_torch.testing.faults.drop_connection`
    the marker names the SCHEDULE as the origin, so a soak's failure
    report can separate injected chaos from organic breakage.  Patches
    the module attribute under the shared fault lock; injections count
    ``faults.injected.chaos_fault``.  Yields the budget."""
    budget = _Budget(n_times, every_n)

    def wrap(orig):
        def chaotic(sock, obj):
            if budget.take():
                _count_injection("chaos_fault")
                err = WireError("injected: chaos schedule dropped the "
                                "frame")
                if getattr(err, "caps_chaos_fault", None) is None:
                    # first-writer-wins marker discipline
                    err.caps_chaos_fault = True
                raise err
            return orig(sock, obj)
        return chaotic

    from caps_tpu_torch.serve import wire
    with _patched(wire, "send_frame", wrap):
        yield budget


@contextlib.contextmanager
def slow_backend(port: int, delay_s: float,
                 n_times: Optional[int] = None, every_n: int = 1):
    """While active, fleet wire sends TO ONE PEER (matched by remote
    port) sleep ``delay_s`` through ``obs.clock`` first — the targeted
    straggler.  :func:`~caps_tpu_torch.testing.faults.slow_network`
    slows every link; this slows exactly one backend, which is the shape
    the hedged-read path exists for (one slow replica must not own the
    fleet's p99).  Injections count ``faults.injected.slow_backend``;
    yields the budget."""
    port = int(port)
    budget = _Budget(n_times, every_n)

    def wrap(orig):
        def slowed(sock, obj):
            try:
                peer = sock.getpeername()[1]
            except OSError:
                peer = None
            if peer == port and budget.take():
                _count_injection("slow_backend")
                clock.sleep(delay_s)
            return orig(sock, obj)
        return slowed

    from caps_tpu_torch.serve import wire
    with _patched(wire, "send_frame", wrap):
        yield budget


# -- the schedule ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault: when (seconds from soak start), which
    injector, against which target (a backend/router name, or None for
    untargeted patch faults), with which parameters."""

    at_s: float
    injector: str
    target: Optional[str]
    params: Tuple[Tuple[str, Any], ...]

    def param(self, key: str, default: Any = None) -> Any:
        return dict(self.params).get(key, default)

    def as_dict(self) -> Dict[str, Any]:
        return {"at_s": self.at_s, "injector": self.injector,
                "target": self.target, "params": dict(self.params)}


def _freeze_params(params: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted(params.items()))


#: parameter samplers per injector — every drawn float is rounded so
#: the canonical JSON (and therefore the digest) is platform-stable
_PARAM_SAMPLERS: Dict[str, Callable[[random.Random], Dict[str, Any]]] = {
    "chaos_fault": lambda rng: {"n_times": rng.randint(1, 2)},
    "drop_connection": lambda rng: {"n_times": rng.randint(1, 2)},
    "slow_network": lambda rng: {
        "delay_s": round(rng.uniform(0.002, 0.02), 6),
        "n_times": rng.randint(1, 4)},
    "slow_backend": lambda rng: {
        "delay_s": round(rng.uniform(0.005, 0.05), 6),
        "n_times": rng.randint(2, 6)},
    "torn_wal": lambda rng: {"n_bytes": rng.randint(0, 8), "n_times": 1},
    "failing_fsync": lambda rng: {"n_times": 1},
    "kill_backend": lambda rng: {},
    "kill_router_active": lambda rng: {},
}

#: the untargeted patch-fault menu ``compose`` draws from by default —
#: transport and durability faults that any soak can absorb
DEFAULT_MENU: Tuple[str, ...] = (
    "chaos_fault", "drop_connection", "slow_network")


def _patch_injector(name: str) -> Callable[[ChaosEvent], Any]:
    from caps_tpu_torch.testing import faults

    def build(ev: ChaosEvent):
        if name == "chaos_fault":
            return chaos_fault(n_times=ev.param("n_times", 1))
        if name == "drop_connection":
            return faults.drop_connection(n_times=ev.param("n_times", 1))
        if name == "slow_network":
            return faults.slow_network(ev.param("delay_s", 0.005),
                                       n_times=ev.param("n_times", 1))
        if name == "torn_wal":
            return faults.torn_wal(n_bytes=ev.param("n_bytes", 6),
                                   n_times=ev.param("n_times", 1))
        if name == "failing_fsync":
            return faults.failing_fsync(n_times=ev.param("n_times", 1))
        raise KeyError(name)  # pragma: no cover — registry covers all
    return build


#: in-process injectors the runner can apply itself (each returns a
#: live context manager over the locked patch points); anything else
#: must come through the host's ``actions``
PATCH_INJECTORS: Dict[str, Callable[[ChaosEvent], Any]] = {
    name: _patch_injector(name)
    for name in ("chaos_fault", "drop_connection", "slow_network",
                 "torn_wal", "failing_fsync")}


class ChaosSchedule:
    """A deterministic, seed-addressed fault schedule."""

    def __init__(self, seed: int, duration_s: float,
                 events: Sequence[ChaosEvent]):
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.events: Tuple[ChaosEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.at_s, e.injector,
                                          e.target or "")))

    @classmethod
    def compose(cls, seed: int, duration_s: float, *,
                menu: Sequence[str] = DEFAULT_MENU,
                targets: Sequence[str] = (),
                n_events: int = 8,
                headline: Optional[str] = None,
                headline_at_frac: float = 0.4,
                registry: Optional[MetricsRegistry] = None
                ) -> "ChaosSchedule":
        """Draw ``n_events`` fault events from ``random.Random(seed)``
        over ``menu`` — which injector, which target, when — plus the
        optional ``headline`` event pinned at ``headline_at_frac`` of
        the soak (a router soak pins ``kill_router_active`` there).
        The draw order is fixed (time, injector, target per event, in
        sequence), so the same seed composes the identical schedule on
        any host."""
        rng = random.Random(int(seed))
        duration_s = float(duration_s)
        menu = list(menu)
        targets = list(targets)
        events: List[ChaosEvent] = []
        for _ in range(int(n_events)):
            at = round(rng.uniform(0.05, 0.95) * duration_s, 6)
            name = rng.choice(menu)
            target = rng.choice(targets) if targets else None
            sampler = _PARAM_SAMPLERS.get(name, lambda _rng: {})
            events.append(ChaosEvent(at, name, target,
                                     _freeze_params(sampler(rng))))
        if headline is not None:
            events.append(ChaosEvent(
                round(duration_s * float(headline_at_frac), 6),
                headline, None, ()))
        reg = registry if registry is not None else global_registry()
        reg.counter("chaos.schedules_composed").inc()
        return cls(seed, duration_s, events)

    def as_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed, "duration_s": self.duration_s,
                "events": [e.as_dict() for e in self.events]}

    def digest(self) -> str:
        """sha256 of the canonical JSON — same seed ⇒ same digest, on
        any host, or the run is not the run you think it is."""
        canon = json.dumps(self.as_dict(), sort_keys=True)
        return hashlib.sha256(canon.encode("utf-8")).hexdigest()


class ChaosRunner:
    """Apply a schedule's events as a soak's own clock passes them.

    A pure pump: :meth:`poll` fires every event whose ``at_s`` the
    caller-supplied elapsed time has passed.  Patch events enter their
    injector context managers on a shared exit stack (unwound when the
    runner exits — budgets usually retire them long before); events
    whose injector appears in ``actions`` are delegated to the host
    (process kills), with the event as the single argument."""

    def __init__(self, schedule: ChaosSchedule, *,
                 actions: Optional[Dict[str, Callable[[ChaosEvent],
                                                      Any]]] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.schedule = schedule
        self._actions = dict(actions or {})
        self._registry = registry if registry is not None \
            else global_registry()
        self._stack = contextlib.ExitStack()
        self._next = 0
        self.applied: List[ChaosEvent] = []
        unknown = [e.injector for e in schedule.events
                   if e.injector not in self._actions
                   and e.injector not in PATCH_INJECTORS]
        if unknown:
            raise KeyError(
                f"schedule names injectors this runner cannot apply: "
                f"{sorted(set(unknown))} — pass actions for them")

    def __enter__(self) -> "ChaosRunner":
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()

    def pending(self) -> int:
        return len(self.schedule.events) - self._next

    def poll(self, elapsed_s: float) -> List[ChaosEvent]:
        """Fire every not-yet-applied event due at ``elapsed_s``;
        returns the events fired by THIS call."""
        fired: List[ChaosEvent] = []
        events = self.schedule.events
        while self._next < len(events) \
                and events[self._next].at_s <= elapsed_s:
            ev = events[self._next]
            self._next += 1
            action = self._actions.get(ev.injector)
            if action is not None:
                action(ev)
            else:
                self._stack.enter_context(PATCH_INJECTORS[ev.injector](ev))
            self._registry.counter("chaos.events_applied").inc()
            self.applied.append(ev)
            fired.append(ev)
        return fired


# -- invariants --------------------------------------------------------------


class ChaosInvariants:
    """The soak's ledger of observations, rendered into verdicts.

    * **zero acked-write loss** — every acknowledged write must be in
      the surviving state: digest parity between the fleet's final read
      and a serial oracle replaying the same acked statements;
    * **no stale reads** — per reader, observed snapshot versions never
      regress (a cache or a rejoined peer served yesterday's graph);
    * **availability floor** — failed reads stay under the budgeted
      fraction (hedges that won do NOT count twice: one logical read,
      one outcome);
    * **no zombie application** — every fence probe from a deposed
      owner or router was refused (StaleEpoch), none applied.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry if registry is not None \
            else global_registry()
        self.reads_ok = 0
        self.reads_failed = 0
        self.stale_reads = 0
        self.acked_writes = 0
        self.fence_refusals = 0
        self.fence_violations = 0
        self._reader_versions: Dict[str, int] = {}

    def note_read(self, reader: str, ok: bool,
                  version: Optional[int] = None) -> None:
        if not ok:
            self.reads_failed += 1
            return
        self.reads_ok += 1
        if version is None:
            return
        last = self._reader_versions.get(reader)
        if last is not None and int(version) < last:
            self.stale_reads += 1
        self._reader_versions[reader] = max(
            int(version), last if last is not None else int(version))

    def note_write_ack(self) -> None:
        self.acked_writes += 1

    def note_fence(self, refused: bool) -> None:
        if refused:
            self.fence_refusals += 1
        else:
            self.fence_violations += 1

    def availability(self) -> float:
        total = self.reads_ok + self.reads_failed
        return (self.reads_ok / total) if total else 1.0

    def report(self, *, availability_floor: float = 0.0,
               oracle_digest: Optional[str] = None,
               observed_digest: Optional[str] = None) -> Dict[str, Any]:
        """The verdicts; failed checks count
        ``chaos.invariant_failures`` (one per failed check)."""
        checks: Dict[str, bool] = {
            "availability": self.availability() >= availability_floor,
            "no_stale_reads": self.stale_reads == 0,
            "no_zombie_application": self.fence_violations == 0,
        }
        if oracle_digest is not None or observed_digest is not None:
            checks["acked_write_parity"] = (
                oracle_digest is not None
                and oracle_digest == observed_digest)
        failures = sum(1 for ok in checks.values() if not ok)
        if failures:
            self._registry.counter("chaos.invariant_failures").inc(failures)
        return {"ok": failures == 0, "checks": checks,
                "availability": self.availability(),
                "reads_ok": self.reads_ok,
                "reads_failed": self.reads_failed,
                "stale_reads": self.stale_reads,
                "acked_writes": self.acked_writes,
                "fence_refusals": self.fence_refusals,
                "fence_violations": self.fence_violations}
