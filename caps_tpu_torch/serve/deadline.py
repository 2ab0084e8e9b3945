"""Per-request deadlines and cooperative cancellation.

A :class:`CancelScope` carries one request's budget (seconds from
submission) and its cancel flag.  The serving worker installs the scope
on the executing thread (:func:`cancel_scope`), and the engine calls
:func:`checkpoint` at pipeline phase boundaries — after parse, after
planning, at every relational-operator boundary during execute, and
around result materialization.  An expired or cancelled scope raises the
typed error *at the next checkpoint*: cancellation is cooperative, a
device program already dispatched is never torn down mid-flight (the
same contract as the fused executor's async streams).

Checkpoints are free when no scope is installed (one thread-local read),
so the unserved paths — plain ``session.cypher()`` calls — pay nothing.

Expiry leaves evidence: the raising checkpoint emits a
``deadline.exceeded`` event into the active tracer (when tracing is on)
and the exception propagating through open spans marks each of them with
an ``error`` attribute, so an expired query's trace shows exactly where
the budget went.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.tracer import active_tracer
from caps_tpu_torch.serve.errors import Cancelled, DeadlineExceeded


class CancelScope:
    """One request's cancellation state: a start time, an optional
    budget, and a cancel flag.  Thread-safe: the flag is an Event set by
    the client thread and read by the executing worker."""

    __slots__ = ("t0", "budget_s", "phase", "_cancelled")

    def __init__(self, budget_s: Optional[float] = None,
                 t0: Optional[float] = None):
        self.t0 = clock.now() if t0 is None else t0
        self.budget_s = budget_s
        #: last phase boundary this request crossed (queued | parse |
        #: plan | execute | materialize) — updated by checkpoint()
        self.phase = "queued"
        self._cancelled = threading.Event()

    def cancel(self) -> None:
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    @property
    def cancel_event(self) -> threading.Event:
        """The underlying cancel Event — the interruptible-wait handle
        retry backoff sleeps block on (``clock.wait``), so ``cancel()``
        wakes a backing-off worker immediately."""
        return self._cancelled

    def elapsed(self) -> float:
        return clock.now() - self.t0

    def remaining(self) -> Optional[float]:
        """Seconds of budget left (None = no deadline)."""
        if self.budget_s is None:
            return None
        return self.budget_s - self.elapsed()

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0.0

    def raise_if_done(self, phase: str) -> None:
        """Raise the typed error if this scope is cancelled or expired,
        attributing it to ``phase``; otherwise record the boundary."""
        self.phase = phase
        if self._cancelled.is_set():
            raise Cancelled(phase=phase)
        if self.expired():
            elapsed = self.elapsed()
            tracer = active_tracer()
            if tracer.enabled:
                tracer.event("deadline.exceeded", kind="event", phase=phase,
                             budget_s=self.budget_s, elapsed_s=elapsed)
            raise DeadlineExceeded(phase=phase, budget_s=self.budget_s,
                                   elapsed_s=elapsed)


_tls = threading.local()


def current_scope() -> Optional[CancelScope]:
    """The scope installed on the calling thread, or None."""
    return getattr(_tls, "scope", None)


@contextlib.contextmanager
def cancel_scope(scope: Optional[CancelScope]) -> Iterator[
        Optional[CancelScope]]:
    """Install ``scope`` for the duration (None = explicitly no scope,
    shadowing any outer one — nested sessions must not inherit a
    caller's budget by accident)."""
    prev = getattr(_tls, "scope", None)
    _tls.scope = scope
    try:
        yield scope
    finally:
        _tls.scope = prev


def checkpoint(phase: str) -> None:
    """Phase-boundary check the engine calls (relational/session.py,
    relational/ops.py).  No scope installed → one thread-local read and
    return."""
    scope = getattr(_tls, "scope", None)
    if scope is not None:
        scope.raise_if_done(phase)
