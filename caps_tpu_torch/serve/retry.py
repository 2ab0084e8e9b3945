"""Transient-error retry with exponential backoff and deterministic jitter.

The policy object is pure arithmetic — it decides *how long* attempt N
backs off and *whether* a request's remaining deadline budget can afford
it; the serving worker (serve/server.py) owns the loop.  Two contracts
matter:

* **deadline-charged**: backoff sleeps spend the request's existing
  budget.  A retry never fires when the remaining budget is smaller
  than the next backoff — the give-up error carries the backoff as its
  ``retry_after_s`` hint (the client can retry with a fresh budget;
  the server won't burn a doomed sleep).
* **deterministic jitter**: the jitter term is a hash of (request id,
  attempt), not a PRNG draw — two runs of the same workload back off
  identically, so fault tests assert exact backoff sequences against a
  fake :mod:`caps_tpu_torch.obs.clock` with no real sleeping.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from caps_tpu_torch.obs import clock


def _jitter_unit(token: int, attempt: int) -> float:
    """Deterministic pseudo-uniform in [0, 1): a Knuth multiplicative
    hash of (token, attempt).  No PRNG state, no process seed — the
    same (request, attempt) always jitters the same way."""
    h = (token * 1_000_003 + attempt * 97 + 1) * 2_654_435_761
    return (h % (1 << 32)) / float(1 << 32)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Knobs for the worker-side transient retry loop (ServerConfig.retry).

    ``max_attempts`` counts *executions*, not re-executions: 3 means the
    original run plus at most two retries."""

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 2.0
    #: +/- fraction of the backoff spread by the deterministic jitter
    #: (0.1 = each backoff lands within ±10% of its nominal value)
    jitter: float = 0.1

    def backoff_s(self, attempt: int, token: int = 0) -> float:
        """Backoff charged before retry number ``attempt`` (1-based:
        attempt 1 is the first RE-execution).  ``token`` feeds the
        deterministic jitter — the server passes the request id, so
        coalesced requests retrying after one fault don't thundering-herd
        on identical sleeps."""
        raw = min(self.backoff_max_s,
                  self.backoff_base_s
                  * self.backoff_multiplier ** max(0, attempt - 1))
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * _jitter_unit(token, attempt)
                                        - 1.0)
        return raw

    def budget_allows(self, remaining_s: Optional[float],
                      backoff_s: float) -> bool:
        """True when a request with ``remaining_s`` of deadline budget
        can afford to sleep ``backoff_s`` and still have time to
        execute.  None = no deadline = always affordable."""
        if remaining_s is None:
            return True
        return remaining_s > backoff_s

    def sleep(self, backoff_s: float, scope=None) -> None:
        """The one sanctioned backoff wait (stubbed by fake clocks in
        tests).  With a :class:`~caps_tpu_torch.serve.deadline.CancelScope`
        the sleep is INTERRUPTIBLE: it blocks on the scope's cancel
        event via ``clock.wait``, so ``cancel()`` (or a non-drain
        shutdown cancelling in-flight requests) wakes the worker
        immediately instead of burning the rest of the backoff — the
        caller re-checks ``scope.cancelled`` on return."""
        if backoff_s <= 0:
            return
        if scope is None:
            clock.sleep(backoff_s)
            return
        clock.wait(scope.cancel_event, backoff_s)
