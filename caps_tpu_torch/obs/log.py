"""Structured event log and the slow-query log.

The flight recorder (obs/telemetry.py) answers "what was in flight when
the incident happened"; nothing so far answers "what happened to
request X" or "why was that one query slow" after the fact.  This
module adds the durable, correlatable record stream:

* :class:`EventLog` — a bounded thread-safe ring of structured events,
  each a plain JSON-able dict stamped with monotonic + wall time and
  ALWAYS carrying ``request_id`` and ``family`` (``None`` when an event
  has no request — a compaction failure — but the fields are present,
  so every consumer can join on them; capslint's ``structured-log``
  pass enforces the two fields at every emit site).  An optional
  ``path`` tees every event to a JSON-lines file for off-process
  ingestion.
* :class:`SlowQueryLog` — a bounded ring of over-threshold request
  records (``ServerConfig.slow_query_threshold_s``).  Records share the
  flight recorder's shape (request_id, family, device, latency, phase,
  outcome, ledger) and add the plan text and per-operator stats, so a
  flight dump and a slow-log entry merge into one timeline.  Every
  capture counts ``slowlog.captured`` and emits a ``slow_query`` event
  into the event log.

The serving tier (serve/server.py) owns the wiring: it emits
compile-charge, breaker-trip, quarantine, and compaction events, and
feeds every finished request's record to the slow log.
"""
from __future__ import annotations

import collections
import json
from typing import Any, Dict, List, Optional

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_lock


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


class EventLog:
    """Bounded structured event ring with an optional JSON-lines sink.

    ``emit(event, request_id=..., family=..., **fields)`` appends one
    record; the two correlation keys are keyword-REQUIRED so a call
    site cannot forget them (and capslint's ``structured-log`` pass
    re-checks that statically across the package)."""

    def __init__(self, capacity: int = 1024, registry=None,
                 path: Optional[str] = None):
        self.capacity = max(1, int(capacity))
        self._records: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = make_lock("log.EventLog._lock")
        #: the file sink has its OWN lock: a slow disk must stall
        #: neither the ring appends on the serving path nor readers
        self._sink_lock = make_lock("log.EventLog._sink_lock")
        self._path = path
        self._file = None
        #: True after the sink raised (missing dir, disk full): the ring
        #: keeps working, the sink is disabled — observability plumbing
        #: must never fail a serving request
        self.sink_failed = False
        self.emitted = 0
        self._events_c = (registry.counter("obs.log_events")
                          if registry is not None else None)

    def emit(self, event: str, *, request_id, family,
             **fields) -> Dict[str, Any]:
        """Append one structured event.  ``request_id`` / ``family`` are
        the correlation keys (pass None explicitly for server-level
        events); extra fields must be JSON-able (non-JSON values are
        repr()'d rather than dropped)."""
        rec: Dict[str, Any] = {
            "event": event, "t": clock.now(), "wall": clock.wall(),
            "request_id": request_id, "family": family,
        }
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        with self._lock:
            self._records.append(rec)
            self.emitted += 1
        # sink write OUTSIDE the ring lock, failure-contained: a
        # misconfigured path or a stalling disk degrades to ring-only
        # logging instead of failing (or serializing) the finish path
        if self._path is not None and not self.sink_failed:
            line = json.dumps(rec, sort_keys=True)
            try:
                with self._sink_lock:
                    if self._file is None:
                        self._file = open(self._path, "a",
                                          encoding="utf-8")
                    self._file.write(line + "\n")
                    self._file.flush()
            except Exception:
                self.sink_failed = True
        # counter outside both locks (no lock-graph edge)
        if self._events_c is not None:
            self._events_c.inc()
        return rec

    def records(self, event: Optional[str] = None) -> List[Dict[str, Any]]:
        """Snapshot of the ring (newest last), optionally filtered by
        event name."""
        with self._lock:
            recs = [dict(r) for r in self._records]
        if event is not None:
            recs = [r for r in recs if r["event"] == event]
        return recs

    def for_request(self, request_id) -> List[Dict[str, Any]]:
        """Every ringed event correlated to one request id."""
        with self._lock:
            return [dict(r) for r in self._records
                    if r.get("request_id") == request_id]

    def write(self, path: str) -> str:
        """Dump the current ring as JSON-lines (one event per line)."""
        recs = self.records()
        with open(path, "w", encoding="utf-8") as f:
            for r in recs:
                f.write(json.dumps(r, sort_keys=True) + "\n")
        return path

    def close(self) -> None:
        """Close the file sink (idempotent; the ring stays readable)."""
        with self._sink_lock:
            f, self._file = self._file, None
        if f is not None:
            try:
                f.close()
            except Exception:  # pragma: no cover — teardown only
                pass


class SlowQueryLog:
    """Bounded ring of over-threshold request records.

    :meth:`consider` takes the request's flight-recorder record (same
    shape — mergeable with flight dumps) plus the execution detail only
    available at finish time (plan text, per-operator stats) and keeps
    it when ``latency_s`` crossed the threshold."""

    def __init__(self, threshold_s: float, capacity: int = 64,
                 registry=None, event_log: Optional[EventLog] = None):
        self.threshold_s = float(threshold_s)
        self.capacity = max(1, int(capacity))
        self._records: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = make_lock("log.SlowQueryLog._lock")
        self._event_log = event_log
        self.captured = 0
        self._captured_c = (registry.counter("slowlog.captured")
                            if registry is not None else None)

    def consider(self, record: Dict[str, Any],
                 plan: Optional[str] = None,
                 operators: Optional[List[Dict[str, Any]]] = None) -> bool:
        """Capture ``record`` if its latency crossed the threshold.
        Returns True when captured."""
        latency = record.get("latency_s") or 0.0
        if latency < self.threshold_s:
            return False
        rec = dict(record)
        rec["slow_threshold_s"] = self.threshold_s
        if plan is not None:
            rec["plan"] = plan
        if operators is not None:
            rec["operators"] = operators
        with self._lock:
            self._records.append(rec)
            self.captured += 1
        # counter + event emit OUTSIDE the ring lock (the event log has
        # its own lock; nesting them would add a needless graph edge)
        if self._captured_c is not None:
            self._captured_c.inc()
        if self._event_log is not None:
            self._event_log.emit(
                "slow_query", request_id=rec.get("request_id"),
                family=rec.get("family"), latency_s=latency,
                threshold_s=self.threshold_s,
                outcome=rec.get("outcome"),
                snapshot_version=rec.get("snapshot_version"))
        return True

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._records]
