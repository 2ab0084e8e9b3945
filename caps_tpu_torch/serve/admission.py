"""Admission control: a bounded, priority-classed request queue.

The server never queues unboundedly.  ``offer`` either admits a request
or sheds it with a typed :class:`~caps_tpu_torch.serve.errors.Overloaded`
carrying a ``retry_after_s`` hint (queue depth x recent per-request
service time / worker count — the telemetry window's mean when it has
samples, the running EMA as fallback).  Two bounds apply:

* a global capacity (``max_queue``) across all priorities;
* optional per-priority limits, so background/batch traffic cannot
  starve interactive requests of queue space (interactive work can
  still use the whole queue when it is alone).

``take`` serves strict priority order (lower value first), FIFO within
a class.  ``take_compatible`` is the micro-batcher's entry: it removes
up to ``n`` further requests sharing a batch key, scanning every
priority class — a follower admitted at low priority rides an
interactive leader's batch for free.

All state lives behind one condition variable; the queue-depth gauge
and the admitted/shed counters land in the server's metrics registry
(``serve.*`` in ``session.metrics_snapshot()``).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_condition, make_lock
from caps_tpu_torch.obs.metrics import MetricsRegistry
from caps_tpu_torch.serve.errors import Overloaded, ServerClosed
from caps_tpu_torch.serve.request import Request

#: retry_after floor: even an empty estimate asks clients to back off a
#: scheduling quantum rather than hot-loop on the server.
_MIN_RETRY_S = 0.001

_gauge_guard = make_lock("admission._gauge_guard")


def _register_depth_gauge(registry: MetricsRegistry,
                          controller: "AdmissionController") -> None:
    """``serve.queue_depth`` reports the TOTAL queued across every live
    controller on this registry (a session may run several servers):
    controllers join the set here and
    leave it in :meth:`AdmissionController.close`, so the gauge never
    gets hijacked by the newest server or pinned by a dead one."""
    with _gauge_guard:
        live = getattr(registry, "_serve_live_controllers", None)
        if live is None:
            live = registry._serve_live_controllers = []
            registry.gauge("serve.queue_depth",
                           fn=lambda: sum(c._depth for c in live))
        live.append(controller)


def _deregister_depth_gauge(registry: MetricsRegistry,
                            controller: "AdmissionController") -> None:
    with _gauge_guard:
        live = getattr(registry, "_serve_live_controllers", [])
        if controller in live:
            live.remove(controller)


class AdmissionController:
    def __init__(self, registry: MetricsRegistry, max_queue: int = 64,
                 per_priority_limits: Optional[Dict[int, int]] = None,
                 workers: int = 1, telemetry=None):
        self.max_queue = max(1, int(max_queue))
        self.per_priority_limits = dict(per_priority_limits or {})
        self.workers = max(1, int(workers))
        self._cond = make_condition("admission.AdmissionController._cond")
        self._queues: Dict[int, Deque[Request]] = {}
        self._depth = 0
        self._closed = False
        #: EMA of per-request service seconds, updated by the server
        #: after each batch — the retry_after estimator's FALLBACK rate
        #: term (see retry_after_s).
        self.ema_service_s = 0.0
        #: optional windowed-telemetry handle (obs/telemetry.py
        #: ServingTelemetry): sheds are noted into the rolling window,
        #: and retry_after's rate term prefers the window's recent mean
        #: service time over the forever-EMA.
        self._telemetry = telemetry
        self._admitted = registry.counter("serve.admitted")
        self._shed = registry.counter("serve.shed")
        self._requeued = registry.counter("serve.requeued")
        self._registry = registry
        _register_depth_gauge(registry, self)

    # -- producer side -------------------------------------------------

    def depth(self, priority: Optional[int] = None) -> int:
        with self._cond:
            if priority is None:
                return self._depth
            q = self._queues.get(priority)
            return len(q) if q else 0

    def retry_after_s(self, depth: Optional[int] = None) -> float:
        """Back-off hint: queue depth × per-request service time /
        parallel streams.  The rate term prefers the telemetry window's
        recent mean service time; the forever-EMA is only the fallback
        for windows with no samples (cold start, long idle) — a one-off
        slow burst therefore stops inflating shed hints as soon as it
        rotates out of the window, instead of lingering in the EMA."""
        d = self._depth if depth is None else depth
        rate = self.ema_service_s
        if self._telemetry is not None:
            recent = self._telemetry.recent_service_s()
            if recent is not None:
                rate = recent
        return max(_MIN_RETRY_S, d * rate / self.workers)

    def observe_service(self, per_request_s: float) -> None:
        """Fold one batch's per-request service time into the EMA
        (locked: concurrent workers must not lose each other's
        updates)."""
        with self._cond:
            ema = self.ema_service_s
            self.ema_service_s = per_request_s if ema == 0.0 \
                else 0.8 * ema + 0.2 * per_request_s

    def set_active_workers(self, n: int) -> None:
        """Degraded-capacity accounting (device fault domains): the
        ``retry_after_s`` estimator divides queue depth by the number of
        PARALLEL streams actually draining it, so a quarantined device
        must fall out of the denominator — with W-1 of W devices live,
        clients are told to back off proportionally longer.  The server
        calls this on every quarantine/reinstate transition."""
        with self._cond:
            self.workers = max(1, int(n))

    def requeue(self, request: Request) -> None:
        """Return a CLAIMED request to the front of its priority class —
        the device-quarantine drain path: a worker whose device was just
        quarantined hands its unexecuted batch back to the dispatcher so
        another device's worker serves it.  Never sheds (the request was
        already admitted once) and works after ``close()`` (a graceful
        drain must still complete requeued work)."""
        with self._cond:
            q = self._queues.get(request.priority)
            if q is None:
                q = self._queues[request.priority] = deque()
            q.appendleft(request)
            self._depth += 1
            self._requeued.inc()
            self._cond.notify_all()

    def offer(self, request: Request) -> None:
        """Admit or shed.  Raises ServerClosed / Overloaded."""
        with self._cond:
            if self._closed:
                raise ServerClosed("server is shutting down")
            prio = request.priority
            limit = self.per_priority_limits.get(prio)
            q = self._queues.get(prio)
            prio_depth = len(q) if q else 0
            if self._depth >= self.max_queue or \
                    (limit is not None and prio_depth >= limit):
                self._shed.inc()
                if self._telemetry is not None:
                    self._telemetry.note_shed()
                raise Overloaded(
                    f"queue full (depth {self._depth}/{self.max_queue}, "
                    f"priority {prio}: {prio_depth}"
                    f"{'' if limit is None else '/%d' % limit})",
                    retry_after_s=self.retry_after_s(),
                    queue_depth=self._depth, priority=prio)
            if q is None:
                q = self._queues[prio] = deque()
            request.enqueued_t = clock.now()
            q.append(request)
            self._depth += 1
            self._admitted.inc()
            # notify_all, not notify: the condition is shared by idle
            # take() waiters AND batch-window wait_for_compatible()
            # waiters — a single wakeup could be swallowed by a window
            # waiter the new request doesn't match while an idle worker
            # sleeps through it
            self._cond.notify_all()

    # -- consumer side (workers) ---------------------------------------

    def _pop_next_locked(self) -> Optional[Request]:
        for prio in sorted(self._queues):
            q = self._queues[prio]
            if q:
                self._depth -= 1
                return q.popleft()
        return None

    def take(self, timeout: Optional[float] = None) -> Optional[Request]:
        """Next request in priority order, waiting up to ``timeout``.
        Returns None on timeout or when closed with an empty queue."""
        deadline = None if timeout is None else clock.now() + timeout
        with self._cond:
            while True:
                req = self._pop_next_locked()
                if req is not None:
                    return req
                if self._closed:
                    return None
                wait = None if deadline is None else deadline - clock.now()
                if wait is not None and wait <= 0:
                    return None
                self._cond.wait(wait)

    def take_compatible(self, batch_key: Tuple, n: int) -> List[Request]:
        """Remove up to ``n`` queued requests with this batch key (any
        priority, FIFO within each class, priority order across)."""
        out: List[Request] = []
        if n <= 0 or batch_key is None:
            return out
        with self._cond:
            for prio in sorted(self._queues):
                q = self._queues[prio]
                if not q:
                    continue
                keep: Deque[Request] = deque()
                while q:
                    r = q.popleft()
                    if len(out) < n and r.batch_key == batch_key:
                        out.append(r)
                    else:
                        keep.append(r)
                self._queues[prio] = keep
                if len(out) >= n:
                    break
            self._depth -= len(out)
        return out

    def wait_for_compatible(self, batch_key: Tuple, want: int,
                            window_s: float) -> None:
        """Block up to ``window_s`` for ``want`` compatible requests to
        be queued (the batching window).  Wakes early when satisfied."""
        if window_s <= 0 or want <= 0 or batch_key is None:
            return
        deadline = clock.now() + window_s
        with self._cond:
            while True:
                have = sum(1 for q in self._queues.values()
                           for r in q if r.batch_key == batch_key)
                if have >= want or self._closed:
                    return
                wait = deadline - clock.now()
                if wait <= 0:
                    return
                self._cond.wait(wait)

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        # leave the queue-depth gauge's live set: a closed controller
        # must not report stale depth or stay pinned by the callback
        _deregister_depth_gauge(self._registry, self)

    @property
    def closed(self) -> bool:
        return self._closed

    def drain_remaining(self) -> List[Request]:
        """Remove and return every queued request (non-drain shutdown
        completes them with Cancelled)."""
        with self._cond:
            out = [r for prio in sorted(self._queues)
                   for r in self._queues[prio]]
            self._queues.clear()
            self._depth = 0
            self._cond.notify_all()
        return out
