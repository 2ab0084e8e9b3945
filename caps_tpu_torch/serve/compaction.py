"""Background compaction for versioned graphs behind the serving tier.

A versioned graph's delta store (relational/updates.py) is bounded by
design — scans overlay a small ragged delta on the fixed-shape base —
but only compaction keeps it that way: folding base + delta into a
fresh base snapshot resets the tombstone masks and the delta CSR to
empty.  Under serving load that fold must happen in the background,
off the request path, and its health must be *visible*: a compactor
that silently died turns a bounded overlay into an unbounded one.

:class:`Compactor` is that background task.  It watches one
``VersionedGraph``'s backlog (``delta_rows``) and folds whenever the
configured threshold is crossed; :class:`~caps_tpu_torch.serve.QueryServer`
starts one automatically when its default graph is versioned and a
threshold is configured, stops it on shutdown, and surfaces
:meth:`summary` under ``stats()["compaction"]`` (a failing compactor
degrades ``health()``).

Failure containment: a failed fold (device OOM mid-re-ingest, an
injected ``flaky_compaction`` fault) rolls back via the same
string-pool mark machinery as writes, counts ``compaction.failures``,
keeps the last error for ``summary()``, and retries on the next tick —
serving is never affected (readers keep their snapshots; writers keep
committing deltas)."""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from caps_tpu_torch.obs import clock
from caps_tpu_torch.serve.errors import CompactionFailed

#: idle states the summary reports
IDLE = "idle"
RUNNING = "running"
FAILING = "failing"
STOPPED = "stopped"


class Compactor:
    """Threshold-driven background compaction of one versioned graph."""

    def __init__(self, graph, registry, threshold_rows: Optional[int] = 512,
                 interval_s: float = 0.05, on_failure=None,
                 threshold_bytes: Optional[int] = None):
        if not getattr(graph, "graph_is_versioned", False):
            raise CompactionFailed(
                f"compaction needs a versioned graph, got "
                f"{type(graph).__name__}")
        self.graph = graph
        #: either trigger may be None (disabled); crossing EITHER live
        #: threshold folds.  Bytes come from ``graph.delta_nbytes()``
        #: (relational/updates.py) — a few huge property rows can now
        #: trigger compaction long before the row count would.
        self.threshold_rows = (max(1, int(threshold_rows))
                               if threshold_rows is not None else None)
        self.threshold_bytes = (max(1, int(threshold_bytes))
                                if threshold_bytes is not None else None)
        self.interval_s = float(interval_s)
        #: optional incident hook called with the exception after every
        #: failed fold — the server wires the telemetry flight-recorder
        #: auto-dump here (a dying compactor is a postmortem trigger)
        self._on_failure = on_failure
        self._failures = registry.counter("compaction.failures")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._state = IDLE
        self._last_error: Optional[str] = None
        self._consecutive_failures = 0

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "Compactor":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="caps-compactor", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._state = STOPPED

    # -- the loop ------------------------------------------------------

    def _over_threshold(self) -> bool:
        if self.threshold_rows is not None \
                and self.graph.delta_rows() >= self.threshold_rows:
            return True
        if self.threshold_bytes is not None \
                and self.graph.delta_nbytes() >= self.threshold_bytes:
            return True
        return False

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self._over_threshold():
                self._state = RUNNING
                try:
                    self.graph.compact()
                except Exception as ex:
                    # a failed fold never hurts serving: count it, keep
                    # the error visible, retry next tick (the rollback
                    # already ran inside compact())
                    self._failures.inc()
                    self._consecutive_failures += 1
                    self._last_error = f"{type(ex).__name__}: {ex}"
                    self._state = FAILING
                    if self._on_failure is not None:
                        try:
                            self._on_failure(ex)
                        except Exception:  # pragma: no cover — hook only
                            pass
                else:
                    self._consecutive_failures = 0
                    self._last_error = None
                    self._state = IDLE
            elif self._state != FAILING:
                self._state = IDLE
            # interruptible nap: stop() wakes the thread immediately
            clock.wait(self._stop, self.interval_s)

    # -- health --------------------------------------------------------

    @property
    def failing(self) -> bool:
        """True after a failed fold with no success since — the server's
        health() reports degraded while this holds."""
        return self._state == FAILING

    def summary(self) -> Dict[str, Any]:
        return {
            "state": self._state,
            "backlog_rows": self.graph.delta_rows(),
            "threshold_rows": self.threshold_rows,
            "backlog_bytes": self.graph.delta_nbytes(),
            "threshold_bytes": self.threshold_bytes,
            "consecutive_failures": self._consecutive_failures,
            "last_error": self._last_error,
        }
