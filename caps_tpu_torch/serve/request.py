"""In-flight request objects and the client-facing result handle.

``QueryServer.submit`` returns a :class:`QueryHandle` immediately; the
worker pool completes it.  The handle is a minimal Future: ``result()``
blocks (with an optional wait timeout), ``cancel()`` is cooperative
(a queued request is dropped at dequeue, a running one stops at its next
engine checkpoint), and ``info`` carries the per-request serving
telemetry (queue wait, batch size, total latency) the bench and the
stress tests assert on.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

from caps_tpu_torch.serve.deadline import CancelScope
from caps_tpu_torch.serve.errors import Cancelled, WaitTimeout

#: Priority classes (lower value = served first).  INTERACTIVE is the
#: latency-sensitive default; BATCH work queues behind it and is the
#: first to shed under pressure (per-priority admission limits).
INTERACTIVE = 0
BATCH = 1

_request_ids = itertools.count(1)


class QueryHandle:
    """Future-style handle for one submitted query."""

    def __init__(self, request: "Request"):
        self._request = request
        self._done = threading.Event()
        self._result: Any = None
        self._rows: Optional[list] = None
        self._exception: Optional[BaseException] = None
        #: serving telemetry, filled in as the request progresses:
        #: queue_wait_s, batch_size, latency_s, worker
        self.info: Dict[str, Any] = {}

    # -- completion (worker side) --------------------------------------

    def _complete(self, result: Any = None, rows: Optional[list] = None,
                  exception: Optional[BaseException] = None) -> None:
        self._result = result
        self._rows = rows
        self._exception = exception
        self._done.set()

    # -- client side ---------------------------------------------------

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> bool:
        """Request cooperative cancellation.  Returns False if the
        request already completed (nothing to cancel)."""
        if self._done.is_set():
            return False
        self._request.scope.cancel()
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._done.wait(timeout):
            raise WaitTimeout("request not complete")
        return self._exception

    def result(self, timeout: Optional[float] = None) -> Any:
        """The CypherResult, or raises the request's typed error.
        ``timeout`` bounds the *wait*, not the query (that is what the
        request's deadline is for)."""
        if not self._done.wait(timeout):
            raise WaitTimeout("request not complete")
        if self._exception is not None:
            raise self._exception
        return self._result

    def rows(self, timeout: Optional[float] = None) -> list:
        """Materialized result rows (list of dicts).  Materialization
        happens on the worker when the server's ``materialize`` config
        is on (the default), else lazily here on the client thread."""
        result = self.result(timeout)
        if self._rows is None:
            self._rows = result.to_maps()
        return self._rows

    def __repr__(self):
        state = "done" if self._done.is_set() else "pending"
        return f"QueryHandle(#{self._request.request_id}, {state})"


class Request:
    """One admitted unit of work, owned by the queue then a worker."""

    __slots__ = ("request_id", "query", "params", "graph", "priority",
                 "scope", "batch_key", "mode", "handle", "enqueued_t",
                 "plan_key", "cache_key")

    def __init__(self, query: str, params: Mapping[str, Any], graph: Any,
                 priority: int, scope: CancelScope,
                 batch_key: Optional[Tuple], mode: Optional[str],
                 plan_key: Optional[Tuple] = None):
        self.request_id = next(_request_ids)
        self.query = query
        self.params = dict(params)
        self.graph = graph
        self.priority = priority
        self.scope = scope
        #: micro-batch compatibility key (serve/batcher.py); None =
        #: never batched (EXPLAIN/PROFILE, uncacheable graphs).  With
        #: ragged bucket batching this is the SHAPE key, wider than the
        #: plan family.
        self.batch_key = batch_key
        #: the exact plan-cache key family — what breakers, quarantine,
        #: and telemetry labels stay keyed by (defaults to batch_key for
        #: requests built before ragged batching existed)
        self.plan_key = plan_key if plan_key is not None else batch_key
        #: "explain" | "profile" | None — PROFILE is executed alone
        self.mode = mode
        self.handle = QueryHandle(self)
        self.enqueued_t = 0.0
        #: ``(result-cache key, snapshot version)`` stamped at admission
        #: when the read missed the result cache — completion offers the
        #: materialized rows back under exactly this key (serve/server.py)
        self.cache_key: Optional[Tuple] = None

    def drop_cancelled(self) -> bool:
        """Complete a dequeued-but-cancelled request without executing.
        Returns True when the request was dropped."""
        if self.scope.cancelled:
            self.handle._complete(
                exception=Cancelled(phase=self.scope.phase))
            return True
        return False
