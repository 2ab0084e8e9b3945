"""Per-plan-family circuit breakers: stop burning device time on a
query family that fails deterministically.

One breaker instance guards one :class:`~caps_tpu_torch.serve.QueryServer`;
state is per *plan family* — the same key the micro-batcher groups by
(graph plan token, normalized query, parameter signature), because that
is the granularity at which a poisoned cached plan keeps hurting.

Classic three-state machine, all transitions driven by
``caps_tpu_torch.obs.clock`` (fake-clock testable):

* **closed** — serving normally; ``failure_threshold`` CONSECUTIVE
  request-level failures (a request that exhausted the worker's whole
  containment ladder) trip it to open.  Any success resets the count.
* **open** — requests of the family fast-fail with
  :class:`~caps_tpu_torch.serve.errors.CircuitOpen` carrying the remaining
  cooldown as ``retry_after_s``; the device never sees them.  Other
  families are untouched — that is the containment property the soak
  test asserts.
* **half-open** — after ``cooldown_s``, exactly ONE trial request is
  let through (concurrent arrivals keep fast-failing); its success
  closes the breaker, its failure re-opens it for another cooldown.

``serve.breaker.*`` metrics land in the server's registry; the summary
feeds ``QueryServer.stats()["health"]``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_lock

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: admit() verdicts
ALLOW = "allow"          # closed: execute normally
TRIAL = "trial"          # half-open probe: execute degraded, one at a time
REJECT = "reject"        # open: fast-fail with CircuitOpen


class _Family:
    __slots__ = ("state", "failures", "opened_t", "trial_in_flight",
                 "trips", "last_error")

    def __init__(self):
        self.state = CLOSED
        self.failures = 0
        self.opened_t = 0.0
        self.trial_in_flight = False
        self.trips = 0
        self.last_error: Optional[str] = None


class CircuitBreaker:
    """``metric_prefix`` scopes the counters: the plan-family breaker
    reports under ``serve.breaker.*`` (the default), while the device
    health ladder (serve/devices.py) reuses this exact state machine
    device-scoped under ``serve.device_breaker.*`` — quarantined is
    open, probing is half-open, one background canary per trial slot."""

    def __init__(self, registry, failure_threshold: int = 3,
                 cooldown_s: float = 5.0,
                 metric_prefix: str = "serve.breaker"):
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = float(cooldown_s)
        self._lock = make_lock("breaker.CircuitBreaker._lock")
        self._families: Dict[Any, _Family] = {}
        self._opened = registry.counter(f"{metric_prefix}.opened")
        self._closed_again = registry.counter(f"{metric_prefix}.closed")
        self._fast_fails = registry.counter(f"{metric_prefix}.fast_fail")
        registry.gauge(f"{metric_prefix}.open", fn=self.open_count)

    # -- serving-path API ----------------------------------------------

    def admit(self, key: Any) -> Tuple[str, float]:
        """Decide how a request of this family may execute.

        Returns ``(ALLOW, 0)``, ``(TRIAL, 0)`` (caller MUST report the
        outcome via record_success/record_failure so the trial slot
        frees), or ``(REJECT, retry_after_s)``."""
        now = clock.now()
        with self._lock:
            fam = self._families.get(key)
            if fam is None or fam.state == CLOSED:
                return ALLOW, 0.0
            if fam.state == OPEN:
                waited = now - fam.opened_t
                if waited < self.cooldown_s:
                    self._fast_fails.inc()
                    return REJECT, max(0.0, self.cooldown_s - waited)
                fam.state = HALF_OPEN
                fam.trial_in_flight = True
                return TRIAL, 0.0
            # HALF_OPEN: one probe at a time
            if fam.trial_in_flight:
                self._fast_fails.inc()
                return REJECT, self.cooldown_s
            fam.trial_in_flight = True
            return TRIAL, 0.0

    def record_success(self, key: Any) -> None:
        with self._lock:
            fam = self._families.get(key)
            if fam is None:
                return
            if fam.state in (HALF_OPEN, OPEN):
                self._closed_again.inc()
            fam.state = CLOSED
            fam.failures = 0
            fam.trial_in_flight = False
            fam.last_error = None

    def record_failure(self, key: Any,
                       error: Optional[BaseException] = None) -> bool:
        """Fold one request-level failure in.  Returns True when THIS
        failure tripped the family open (the caller then quarantines the
        cached plan — see server._recover)."""
        with self._lock:
            fam = self._families.setdefault(key, _Family())
            if error is not None:
                fam.last_error = type(error).__name__
            if fam.state == HALF_OPEN:
                # failed probe: straight back to open, fresh cooldown
                fam.state = OPEN
                fam.opened_t = clock.now()
                fam.trial_in_flight = False
                fam.trips += 1
                self._opened.inc()
                return True
            fam.failures += 1
            if fam.state == CLOSED and \
                    fam.failures >= self.failure_threshold:
                fam.state = OPEN
                fam.opened_t = clock.now()
                fam.trips += 1
                self._opened.inc()
                return True
            return False

    def abort_trial(self, key: Any) -> None:
        """Free a half-open trial slot without a verdict (the trial
        request was cancelled / expired before executing) — the next
        arrival gets the probe instead."""
        with self._lock:
            fam = self._families.get(key)
            if fam is not None and fam.state == HALF_OPEN:
                fam.trial_in_flight = False

    # -- inspection ----------------------------------------------------

    def state(self, key: Any) -> str:
        with self._lock:
            fam = self._families.get(key)
            return fam.state if fam is not None else CLOSED

    def open_count(self) -> int:
        with self._lock:
            return sum(1 for f in self._families.values()
                       if f.state != CLOSED)

    def summary(self) -> Dict[str, Any]:
        """Aggregate view for ``server.stats()``: state counts plus the
        non-closed families (key repr truncated — keys embed query
        text)."""
        with self._lock:
            counts = {CLOSED: 0, OPEN: 0, HALF_OPEN: 0}
            broken = []
            for key, fam in self._families.items():
                counts[fam.state] += 1
                if fam.state != CLOSED:
                    broken.append({"family": repr(key)[:120],
                                   "state": fam.state,
                                   "failures": fam.failures,
                                   "trips": fam.trips,
                                   "last_error": fam.last_error})
            return {"counts": counts, "broken": broken}
