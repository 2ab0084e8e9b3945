"""Windowed serving telemetry: rolling SLOs, a flight recorder, and the
observed-statistics store.

The metrics registry (obs/metrics.py) is cumulative-since-start and the
tracer (obs/tracer.py) is per-query — neither answers "what is p99 over
the last minute", "are we inside our latency SLO", or "what was in
flight when that breaker tripped".  This module adds the missing
time-local layer; the serving tier (serve/server.py) owns the wiring.

Four pieces:

* **rolling windows** — :class:`RollingCounter` / :class:`RollingHistogram`
  are rings of N buckets rotated lazily on :mod:`caps_tpu_torch.obs.clock`
  (``window_s / buckets`` seconds per slot).  Rotation is pure clock
  arithmetic, so a fake clock makes bucket expiry and quantile behavior
  exactly assertable.  Histograms keep the cumulative-``le`` bucket
  layout of obs/metrics.py; quantiles report the upper bound of the
  bucket the rank falls in (Prometheus ``histogram_quantile`` style),
  with the window max serving the +Inf tail.
* **SLO tracking** — :class:`SLOConfig` (a latency target + objectives)
  evaluated over the window by :meth:`ServingTelemetry.slo_report` into
  latency-compliance and availability **error-budget burn rates**:
  ``burn = (1 - compliance) / (1 - objective)`` — 1.0 means the error
  budget burns exactly as fast as it accrues, >1 means an incident.
* **flight recorder** — :class:`FlightRecorder`, a bounded thread-safe
  ring of per-request records (plan family, device, attempts history,
  phase timings, outcome).  The server records every finished request
  and dumps the ring automatically on breaker-trip / device-quarantine /
  compaction-failure events (``ServingTelemetry.auto_dump``; bounded
  ``flight_dumps`` list) and on demand via
  ``server.dump_flight_recorder()`` — the postmortem black box.
* **observed statistics** — :class:`OpStatsStore`: per
  (plan family, operator id) observed rows / bytes / wall / device time,
  recorded by the session from the same per-operator entries PROFILE
  reads (relational/ops.py stamps a stable ``op_id`` per plan node), so
  the numbers are fused-replay aware by construction.  An observation
  diverging from the planner's estimate (or, without one, from the
  running mean) by more than ``divergence_factor`` counts
  ``opstats.divergences`` — the cost model's re-plan trigger.

Windowed gauges (``telemetry.*`` / ``slo.*``) register in the server's
metrics registry with live callbacks, so they ride ``metrics_snapshot()``
and the Prometheus text exposition (``registry.expose_text()``) with no
extra plumbing.  All time goes through ``obs.clock``; all locks through
``obs.lockgraph`` — both capslint-checked.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_lock

#: latency-shaped default bucket bounds (seconds): sub-ms serving hits
#: through multi-second cold compiles all land in a real bucket
_LATENCY_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 0.5, 1.0,
                    5.0, 30.0)

#: batch-occupancy bucket bounds (members per batch)
_OCCUPANCY_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

#: guards each registry's live-telemetry set (gauge registration and
#: close() race from different servers' threads)
_gauge_guard = make_lock("telemetry._gauge_guard")


# -- rolling window primitives ----------------------------------------------


class RollingCounter:
    """Ring-of-buckets counter: ``inc`` lands in the current time slot,
    slots older than the window fall off as the clock advances.  NOT
    internally locked — the owner (:class:`ServingTelemetry`) serializes
    access; standalone users must do the same."""

    __slots__ = ("n", "bucket_s", "_epoch", "_slots")

    def __init__(self, window_s: float = 60.0, buckets: int = 60):
        self.n = max(1, int(buckets))
        self.bucket_s = float(window_s) / self.n
        self._epoch: Optional[int] = None
        self._slots = [0.0] * self.n

    def _advance(self, now: float) -> None:
        e = int(now // self.bucket_s)
        if self._epoch is None:
            self._epoch = e
            return
        if e <= self._epoch:
            return
        for k in range(1, min(self.n, e - self._epoch) + 1):
            self._slots[(self._epoch + k) % self.n] = 0.0
        self._epoch = e

    def inc(self, now: float, n: float = 1.0) -> None:
        self._advance(now)
        self._slots[self._epoch % self.n] += n

    def total(self, now: float) -> float:
        self._advance(now)
        return sum(self._slots)


class RollingHistogram:
    """Ring-of-buckets histogram: each time slot holds a cumulative-style
    ``le`` bucket array plus sum/count/max; reads merge the live slots.

    ``quantile`` returns the upper bound of the bucket the rank lands in
    (the window max for the +Inf tail) — coarse but monotone, exact to
    assert against, and identical in spirit to Prometheus
    ``histogram_quantile`` over the same layout.  NOT internally locked
    (see :class:`RollingCounter`)."""

    __slots__ = ("n", "bucket_s", "bounds", "_epoch", "_counts", "_sums",
                 "_ns", "_maxes")

    def __init__(self, window_s: float = 60.0, buckets: int = 60,
                 bounds: Sequence[float] = _LATENCY_BUCKETS):
        self.n = max(1, int(buckets))
        self.bucket_s = float(window_s) / self.n
        self.bounds = tuple(bounds)
        self._epoch: Optional[int] = None
        self._counts = [[0] * (len(self.bounds) + 1) for _ in range(self.n)]
        self._sums = [0.0] * self.n
        self._ns = [0] * self.n
        self._maxes: List[Optional[float]] = [None] * self.n

    def _advance(self, now: float) -> None:
        e = int(now // self.bucket_s)
        if self._epoch is None:
            self._epoch = e
            return
        if e <= self._epoch:
            return
        for k in range(1, min(self.n, e - self._epoch) + 1):
            i = (self._epoch + k) % self.n
            self._counts[i] = [0] * (len(self.bounds) + 1)
            self._sums[i] = 0.0
            self._ns[i] = 0
            self._maxes[i] = None
        self._epoch = e

    def observe(self, now: float, v: float) -> None:
        self._advance(now)
        i = self._epoch % self.n
        slot = self._counts[i]
        for b, le in enumerate(self.bounds):
            if v <= le:
                slot[b] += 1
                break
        else:
            slot[-1] += 1
        self._sums[i] += v
        self._ns[i] += 1
        m = self._maxes[i]
        if m is None or v > m:
            self._maxes[i] = v

    # -- merged reads ---------------------------------------------------

    def count(self, now: float) -> int:
        self._advance(now)
        return sum(self._ns)

    def mean(self, now: float) -> Optional[float]:
        self._advance(now)
        total = sum(self._ns)
        return (sum(self._sums) / total) if total else None

    def max(self, now: float) -> Optional[float]:
        self._advance(now)
        live = [m for m in self._maxes if m is not None]
        return max(live) if live else None

    def quantile(self, now: float, q: float) -> Optional[float]:
        self._advance(now)
        total = sum(self._ns)
        if not total:
            return None
        merged = [sum(slot[b] for slot in self._counts)
                  for b in range(len(self.bounds) + 1)]
        rank = max(1, math.ceil(q * total))
        cum = 0
        for b, le in enumerate(self.bounds):
            cum += merged[b]
            if cum >= rank:
                return le
        return self.max(now)  # +Inf tail: the honest window max


# -- SLO tracking ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """A serving SLO: ``latency_objective`` of requests complete within
    ``latency_target_s``, and ``availability_objective`` of requests
    complete at all (client cancellations excluded — they are the
    client's verdict, not the server's)."""

    latency_target_s: float = 1.0
    latency_objective: float = 0.99
    availability_objective: float = 0.999


def _burn_rate(compliance: float, objective: float) -> float:
    """Error-budget burn rate: observed error fraction over allowed
    error fraction.  1.0 = the budget burns exactly as fast as it
    accrues; 0.0 = no budget burning; an objective of 1.0 makes any
    miss an infinite burn, capped to a large finite sentinel."""
    allowed = 1.0 - objective
    observed = 1.0 - compliance
    if observed <= 0.0:
        return 0.0
    if allowed <= 0.0:
        return float(10 ** 6)
    return observed / allowed


# -- flight recorder ---------------------------------------------------------


class FlightRecorder:
    """Bounded thread-safe ring of per-request records — the black box.

    ``record`` appends one plain dict (oldest evicted past ``capacity``);
    ``dump(reason)`` snapshots the ring into a timestamped dict.  The
    recorder itself never interprets the records; the serving tier fills
    them (serve/server.py) and triggers dumps."""

    def __init__(self, capacity: int = 256, max_dumps: int = 8):
        self.capacity = max(1, int(capacity))
        self._records: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = make_lock("telemetry.FlightRecorder._lock")
        #: automatic dumps (breaker trip / device quarantine / compaction
        #: failure), newest last, bounded so a flapping trigger cannot
        #: grow memory without limit
        self.dumps: collections.deque = collections.deque(maxlen=max_dumps)
        self.recorded = 0

    def record(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._records.append(rec)
            self.recorded += 1

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._records]

    def dump(self, reason: str, store: bool = False) -> Dict[str, Any]:
        """Snapshot the ring.  ``store=True`` (the auto-dump path) also
        appends the dump to :attr:`dumps`."""
        d = {"reason": reason, "t": clock.now(), "wall": clock.wall(),
             "records": self.snapshot()}
        if store:
            with self._lock:
                self.dumps.append(d)
        return d


# -- observed per-operator statistics ----------------------------------------


class OpStatsStore:
    """Observed per-plan-node statistics, keyed
    ``(plan family, operator id)``.

    The session records every execution's per-operator entries here
    (relational/session.py) — the same entries PROFILE annotates, so
    fused-replay granularity carries over unchanged (rows under generic
    replay are the served sizes, exact under per-op sync).  The store is
    the substrate for cost-based planning (relational/cost.py): when an entry carries the planner's OWN
    estimate (``est_rows``, stamped by ``cost.annotate_plan``), the
    divergence check measures **model error** — an observation off the
    *estimate* by more than ``divergence_factor`` (either direction)
    ticks the per-key and registry divergence counters, and a family
    whose executions keep diverging becomes a **re-plan candidate**
    (``take_replan_candidates``): the session retires its cached plan
    through the quarantine path and re-plans with calibrated
    statistics.  Entries without an estimate keep the legacy behavior
    (the running mean stands in, drift past it diverges).

    Families are LRU-bounded (``max_families``): a long-lived server
    cycling through ad-hoc queries cannot grow the store without bound.
    """

    def __init__(self, registry=None, max_families: int = 128,
                 divergence_factor: float = 4.0,
                 replan_threshold: int = 2,
                 divergence_floor: int = 256,
                 bucket_fn=None):
        self.max_families = max(1, int(max_families))
        self.divergence_factor = max(1.0, float(divergence_factor))
        #: model error below this many rows (both sides) never counts:
        #: everything under the smallest shape bucket pads identically,
        #: so the mis-estimate has no device-cost consequence and a
        #: re-plan would be pure churn (tiny test graphs included)
        self.divergence_floor = max(0, int(divergence_floor))
        #: rows -> padded-bucket boundary (the session's shape lattice):
        #: model error that does not CHANGE the padded bucket changes no
        #: launch shape and no device cost, so it never diverges — this
        #: also absorbs fused-replay entries whose observed "rows" are
        #: the served (padded) size rather than the exact count
        self.bucket_fn = bucket_fn
        #: model-divergent EXECUTIONS (not op entries) a family needs
        #: before it is surfaced as a re-plan candidate
        self.replan_threshold = max(1, int(replan_threshold))
        self._families: Dict[str, Dict[str, Dict[str, Any]]] = {}
        #: total per-operator entries folded in (the health_report
        #: ``opstats`` section reads it without needing the registry)
        self.recorded = 0
        #: per-family model-divergent execution counts since the last
        #: candidate hand-off, and the pending candidate set
        self._diverged_execs: Dict[str, int] = {}
        self._replan_candidates: List[str] = []
        self._lock = make_lock("telemetry.OpStatsStore._lock")
        self._recorded_c = (registry.counter("opstats.recorded")
                            if registry is not None else None)
        self._diverged_c = (registry.counter("opstats.divergences")
                            if registry is not None else None)
        self._replan_cand_c = (registry.counter("replan.candidates")
                               if registry is not None else None)
        if registry is not None:
            registry.gauge("opstats.families", fn=self.family_count)

    def record(self, family: str,
               op_metrics: Sequence[Dict[str, Any]]) -> None:
        """Fold one execution's per-operator entries in (entries are the
        dicts relational/ops.py appends to the runtime context)."""
        if not op_metrics:
            return
        diverged = 0
        model_diverged = False
        new_candidate = False
        with self._lock:
            self.recorded += len(op_metrics)
            fam = self._families.pop(family, None)
            if fam is None:
                fam = {}
            self._families[family] = fam  # LRU touch: newest position
            while len(self._families) > self.max_families:
                dropped = next(iter(self._families))
                self._families.pop(dropped)
                self._diverged_execs.pop(dropped, None)
            for entry in op_metrics:
                op_id = f"{entry.get('op_id', -1)}:{entry.get('op', '?')}"
                st = fam.get(op_id)
                rows = int(entry.get("rows") or 0)
                model_est = entry.get("est_rows")
                if st is None:
                    st = fam[op_id] = {
                        "op": entry.get("op", "?"), "executions": 0,
                        "rows_total": 0, "rows_last": 0, "rows_mean": 0.0,
                        "rows_min": rows, "rows_max": rows,
                        "bytes_total": 0, "wall_s_total": 0.0,
                        "device_s_total": 0.0, "divergences": 0}
                f = self.divergence_factor
                if model_est is not None:
                    # model error: actual vs the PLANNER's estimate —
                    # checked on every execution, first included (the
                    # model's error is known immediately), but only when
                    # the error is big enough to matter in DEVICE terms:
                    # above the bucket floor AND landing the launch in a
                    # different padded bucket than the estimate priced
                    # (see __init__ — costs are padded rows, so error
                    # inside one bucket is free by construction)
                    est = float(model_est)
                    st["est_rows"] = int(est)
                    st["est_err"] = round((rows + 1.0) / (est + 1.0), 4)
                    ratio = (rows + 1.0) / (est + 1.0)
                    if (ratio > f or ratio < 1.0 / f) \
                            and max(rows, est) >= self.divergence_floor \
                            and self._bucket_changed(rows, est):
                        st["divergences"] += 1
                        diverged += 1
                        model_diverged = True
                elif st["executions"] > 0:
                    # legacy drift check against the running mean
                    est = st["rows_mean"]
                    ratio = (rows + 1.0) / (est + 1.0)
                    if ratio > f or ratio < 1.0 / f:
                        st["divergences"] += 1
                        diverged += 1
                st["executions"] += 1
                st["rows_total"] += rows
                st["rows_last"] = rows
                st["rows_mean"] = st["rows_total"] / st["executions"]
                st["rows_min"] = min(st["rows_min"], rows)
                st["rows_max"] = max(st["rows_max"], rows)
                st["bytes_total"] += int(entry.get("bytes_in") or 0)
                st["wall_s_total"] += float(entry.get("seconds") or 0.0)
                if entry.get("device_s") is not None:
                    st["device_s_total"] += float(entry["device_s"])
            if model_diverged:
                n = self._diverged_execs.get(family, 0) + 1
                if n >= self.replan_threshold:
                    self._diverged_execs[family] = 0
                    if family not in self._replan_candidates:
                        self._replan_candidates.append(family)
                        new_candidate = True
                else:
                    self._diverged_execs[family] = n
        if self._recorded_c is not None:
            self._recorded_c.inc(len(op_metrics))
        if diverged and self._diverged_c is not None:
            self._diverged_c.inc(diverged)
        if new_candidate and self._replan_cand_c is not None:
            self._replan_cand_c.inc()

    def _bucket_changed(self, rows: int, est: float) -> bool:
        """True when actual and estimate pad to different shape-bucket
        boundaries (always True without a lattice)."""
        if self.bucket_fn is None:
            return True
        try:
            return (self.bucket_fn(max(1, int(rows)))
                    != self.bucket_fn(max(1, int(est))))
        except Exception:  # pragma: no cover — advisory only
            return True

    def take_replan_candidates(self) -> List[str]:
        """Families whose executions crossed the model-divergence
        threshold since the last call — handed off exactly once (the
        session retires their cached plans and re-plans with updated
        statistics; relational/session.py ``_maybe_replan``)."""
        with self._lock:
            out, self._replan_candidates = self._replan_candidates, []
            return out

    def reset_family(self, family: str) -> None:
        """Drop one family's recorded per-operator history (divergence
        counts survive in the registry counters).  Called when the
        family's cached plan retires for re-planning: the history was
        measured under the plan the model just declared mis-planned,
        and operator ids do NOT transfer across plan shapes — a re-plan
        calibrated against the old plan's operators would inherit its
        aliased row means and re-diverge forever (plan churn).  The
        re-plan prices from the refreshed statistics prior; history
        restarts under the new plan's operators."""
        with self._lock:
            self._families.pop(family, None)
            self._diverged_execs.pop(family, None)

    # -- reads ----------------------------------------------------------

    def family_count(self) -> int:
        with self._lock:
            return len(self._families)

    def families(self) -> List[str]:
        with self._lock:
            return list(self._families)

    def stats(self, family: Optional[str] = None) -> Dict[str, Any]:
        """Deep-copied view: ``{family: {op_id: stats}}``, or one
        family's ``{op_id: stats}`` when ``family`` is given."""
        with self._lock:
            if family is not None:
                return {k: dict(v)
                        for k, v in self._families.get(family, {}).items()}
            return {f: {k: dict(v) for k, v in ops.items()}
                    for f, ops in self._families.items()}

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            ops = sum(len(v) for v in self._families.values())
            div = sum(st["divergences"] for v in self._families.values()
                      for st in v.values())
            est = sum(1 for v in self._families.values()
                      for st in v.values() if "est_rows" in st)
            return {"families": len(self._families), "operators": ops,
                    "recorded": self.recorded, "divergences": div,
                    "estimated_operators": est,
                    "pending_replans": len(self._replan_candidates)}


# -- the serving telemetry hub -----------------------------------------------


class ServingTelemetry:
    """Windowed serving telemetry for one :class:`QueryServer`.

    Owns the rolling instruments (latency, queue wait, service time,
    batch occupancy, outcome/shed/retry counters, per-device busy time,
    per-plan-family latency — LRU-bounded), the SLO evaluation, and the
    flight recorder.  Registers live ``telemetry.*`` / ``slo.*`` gauges
    in ``registry`` so the windowed view rides ``metrics_snapshot()``
    and ``registry.expose_text()``.  A session may run several servers:
    the gauges dispatch to the NEWEST
    telemetry in the registry's live set, and :meth:`close` (called by
    ``QueryServer.shutdown``) leaves the set — a shut-down server
    neither reports stale windows nor stays pinned by the callbacks
    (the same lifecycle contract as admission's queue-depth gauge).
    Per-server views are always available on ``server.health_report()``
    / ``stats()["telemetry"]``, which read this object directly.

    One lock serializes all window state; every public method reads the
    clock itself, so fake-clock tests drive rotation exactly."""

    MAX_FAMILIES = 64

    def __init__(self, registry, window_s: float = 60.0, buckets: int = 60,
                 slo: Optional[SLOConfig] = None,
                 flight_recorder_size: int = 256):
        self.window_s = float(window_s)
        self.buckets = max(1, int(buckets))
        self.slo = slo
        self._lock = make_lock("telemetry.ServingTelemetry._lock")
        self._start_t = clock.now()

        def hist(bounds=_LATENCY_BUCKETS):
            return RollingHistogram(self.window_s, self.buckets, bounds)

        def ctr():
            return RollingCounter(self.window_s, self.buckets)

        self._latency = hist()
        self._queue_wait = hist()
        self._service = hist()
        self._occupancy = hist(_OCCUPANCY_BUCKETS)
        self._ok = ctr()
        self._errors = ctr()
        self._aborts = ctr()
        self._within_slo = ctr()
        self._shed = ctr()
        self._retries = ctr()
        # compile charges (obs/compile.py): events + seconds over the
        # window — a warmed server shows 0.0 here, a re-compile storm
        # shows up immediately
        self._compile_events = ctr()
        self._compile_s = ctr()
        self._device_busy: Dict[int, RollingCounter] = {}
        self._family_latency: Dict[str, RollingHistogram] = {}
        self.recorder = FlightRecorder(capacity=flight_recorder_size)
        self._dumps_c = registry.counter("telemetry.flight_recorder.dumps")
        self._registry = registry
        self._register_gauges(registry)

    # -- registry gauges (live windowed values) -------------------------

    def _register_gauges(self, registry) -> None:
        """Join the registry's live-telemetry set; on the set's first
        member, register the ``telemetry.*`` gauges with callbacks that
        dispatch to the NEWEST live member (``slo.*`` gauges register
        when the first SLO-configured member joins).  The closures
        capture only the registry's list — never a telemetry instance —
        so :meth:`close` fully unpins a shut-down server."""
        with _gauge_guard:
            live = getattr(registry, "_telemetry_live", None)
            if live is None:
                live = registry._telemetry_live = []
            live.append(self)
            need_base = not getattr(registry, "_telemetry_gauges", False)
            if need_base:
                registry._telemetry_gauges = True
            need_slo = (self.slo is not None and not getattr(
                registry, "_telemetry_slo_gauges", False))
            if need_slo:
                registry._telemetry_slo_gauges = True

        def window_gauge(method_name, *args):
            def read():
                t = live[-1] if live else None
                if t is None:
                    return 0.0
                v = getattr(t, method_name)(*args)
                return v if v is not None else 0.0
            return read

        def slo_gauge(field: str):
            def read():
                for t in reversed(live):
                    if t.slo is not None:
                        rep = t.slo_report()
                        return rep[field] if rep is not None else 0.0
                return 0.0
            return read

        if need_base:
            registry.gauge("telemetry.window_qps", fn=window_gauge("qps"))
            registry.gauge("telemetry.latency_p50_s",
                           fn=window_gauge("latency_quantile", 0.50))
            registry.gauge("telemetry.latency_p95_s",
                           fn=window_gauge("latency_quantile", 0.95))
            registry.gauge("telemetry.latency_p99_s",
                           fn=window_gauge("latency_quantile", 0.99))
            registry.gauge("telemetry.queue_wait_p95_s",
                           fn=window_gauge("queue_wait_quantile", 0.95))
            registry.gauge("telemetry.batch_occupancy",
                           fn=window_gauge("batch_occupancy"))
            registry.gauge("telemetry.shed_rate",
                           fn=window_gauge("shed_rate"))
            registry.gauge("telemetry.retry_rate",
                           fn=window_gauge("retry_rate"))
            registry.gauge("telemetry.error_rate",
                           fn=window_gauge("error_rate"))
            registry.gauge("telemetry.compile_s",
                           fn=window_gauge("window_compile_s"))
        if need_slo:
            registry.gauge("slo.latency_compliance",
                           fn=slo_gauge("latency_compliance"))
            registry.gauge("slo.availability", fn=slo_gauge("availability"))
            registry.gauge("slo.latency_burn_rate",
                           fn=slo_gauge("latency_burn_rate"))
            registry.gauge("slo.availability_burn_rate",
                           fn=slo_gauge("availability_burn_rate"))

    def close(self) -> None:
        """Leave the registry's live set: gauges stop reading this
        window and the callbacks stop pinning the server (flight ring
        included).  Idempotent; called by ``QueryServer.shutdown``."""
        with _gauge_guard:
            live = getattr(self._registry, "_telemetry_live", None)
            if live is not None and self in live:
                live.remove(self)

    def latency_quantile(self, q: float) -> Optional[float]:
        with self._lock:
            return self._latency.quantile(clock.now(), q)

    def queue_wait_quantile(self, q: float) -> Optional[float]:
        with self._lock:
            return self._queue_wait.quantile(clock.now(), q)

    # -- recording (the server's hooks) ---------------------------------

    def note_queue_wait(self, wait_s: float) -> None:
        with self._lock:
            self._queue_wait.observe(clock.now(), wait_s)

    def note_service(self, per_request_s: float) -> None:
        with self._lock:
            self._service.observe(clock.now(), per_request_s)

    def note_batch(self, n: int) -> None:
        with self._lock:
            self._occupancy.observe(clock.now(), float(n))

    def note_shed(self) -> None:
        with self._lock:
            self._shed.inc(clock.now())

    def note_retry(self) -> None:
        with self._lock:
            self._retries.inc(clock.now())

    def note_compile(self, seconds: float) -> None:
        """One request's compile charge (the per-query
        ``compile_s_charged`` the session stamps — obs/compile.py)."""
        now = clock.now()
        with self._lock:
            self._compile_events.inc(now)
            self._compile_s.inc(now, max(0.0, float(seconds)))

    def note_device_busy(self, device_index: int, busy_s: float) -> None:
        with self._lock:
            c = self._device_busy.get(device_index)
            if c is None:
                c = self._device_busy[device_index] = RollingCounter(
                    self.window_s, self.buckets)
            c.inc(clock.now(), busy_s)

    def note_result(self, family: Optional[str], latency_s: float,
                    outcome: str) -> None:
        """One finished request.  ``outcome``: ``"ok"`` (latency lands in
        the window histograms and counts toward SLO compliance),
        ``"error"`` (counts against availability), or ``"abort"``
        (client cancel / expired budget — tracked, excluded from
        availability)."""
        now = clock.now()
        with self._lock:
            if outcome == "ok":
                self._ok.inc(now)
                self._latency.observe(now, latency_s)
                if family is not None:
                    fh = self._family_latency.pop(family, None)
                    if fh is None:
                        fh = RollingHistogram(self.window_s, self.buckets)
                    self._family_latency[family] = fh
                    while len(self._family_latency) > self.MAX_FAMILIES:
                        self._family_latency.pop(
                            next(iter(self._family_latency)))
                    fh.observe(now, latency_s)
                if self.slo is None or \
                        latency_s <= self.slo.latency_target_s:
                    self._within_slo.inc(now)
            elif outcome == "abort":
                self._aborts.inc(now)
            else:
                self._errors.inc(now)

    # -- windowed reads -------------------------------------------------

    def _span(self, now: float) -> float:
        """Seconds of window actually covered so far (rates divide by
        this, so a 2-second-old server reports honest per-second
        rates)."""
        bucket_s = self.window_s / self.buckets
        return max(bucket_s, min(self.window_s, now - self._start_t))

    def recent_service_s(self) -> Optional[float]:
        """Windowed mean per-request service time — the admission
        controller's preferred retry_after rate term (None when the
        window holds no samples; the caller falls back to its EMA)."""
        with self._lock:
            return self._service.mean(clock.now())

    def qps(self) -> float:
        now = clock.now()
        with self._lock:
            return round((self._ok.total(now) + self._errors.total(now)
                          + self._aborts.total(now)) / self._span(now), 4)

    def shed_rate(self) -> float:
        now = clock.now()
        with self._lock:
            return round(self._shed.total(now) / self._span(now), 4)

    def retry_rate(self) -> float:
        now = clock.now()
        with self._lock:
            return round(self._retries.total(now) / self._span(now), 4)

    def error_rate(self) -> float:
        now = clock.now()
        with self._lock:
            return round(self._errors.total(now) / self._span(now), 4)

    def window_compile_s(self) -> float:
        """Compile seconds charged inside the window (0.0 warmed)."""
        with self._lock:
            return round(self._compile_s.total(clock.now()), 6)

    def batch_occupancy(self) -> float:
        """Window-averaged micro-batch occupancy (members per batch);
        0.0 with no batches in the window."""
        with self._lock:
            m = self._occupancy.mean(clock.now())
            return round(m, 4) if m is not None else 0.0

    def summary(self) -> Dict[str, Any]:
        """The windowed view ``stats()["telemetry"]`` exposes."""
        now = clock.now()
        with self._lock:
            span = self._span(now)
            ok = self._ok.total(now)
            errors = self._errors.total(now)
            aborts = self._aborts.total(now)
            lat = self._latency
            fams = sorted(self._family_latency.items(),
                          key=lambda kv: kv[1].count(now), reverse=True)
            return {
                "window_s": self.window_s,
                "span_s": round(span, 4),
                "requests": int(ok + errors + aborts),
                "qps": round((ok + errors + aborts) / span, 4),
                "latency": {
                    "count": lat.count(now),
                    "p50_s": lat.quantile(now, 0.50),
                    "p95_s": lat.quantile(now, 0.95),
                    "p99_s": lat.quantile(now, 0.99),
                    "mean_s": lat.mean(now),
                    "max_s": lat.max(now),
                },
                "queue_wait": {
                    "p50_s": self._queue_wait.quantile(now, 0.50),
                    "p95_s": self._queue_wait.quantile(now, 0.95),
                },
                "batch_occupancy": self._occupancy.mean(now) or 0.0,
                "compile": {
                    "events": int(self._compile_events.total(now)),
                    "seconds": round(self._compile_s.total(now), 6),
                },
                "rates_per_s": {
                    "completed": round(ok / span, 4),
                    "errors": round(errors / span, 4),
                    "aborts": round(aborts / span, 4),
                    "shed": round(self._shed.total(now) / span, 4),
                    "retries": round(self._retries.total(now) / span, 4),
                },
                "device_utilization": {
                    idx: round(min(1.0, c.total(now) / span), 4)
                    for idx, c in sorted(self._device_busy.items())},
                "families": {
                    fam[:120]: {"count": h.count(now),
                                "p99_s": h.quantile(now, 0.99)}
                    for fam, h in fams[:8]},
            }

    def slo_report(self) -> Optional[Dict[str, Any]]:
        """The windowed SLO evaluation (None when no SLO is configured).
        With no completed requests in the window, compliance is 1.0 and
        nothing burns — an idle server is not an incident."""
        if self.slo is None:
            return None
        now = clock.now()
        with self._lock:
            ok = self._ok.total(now)
            errors = self._errors.total(now)
            within = self._within_slo.total(now)
        compliance = (within / ok) if ok else 1.0
        served = ok + errors
        availability = (ok / served) if served else 1.0
        lat_burn = _burn_rate(compliance, self.slo.latency_objective)
        avail_burn = _burn_rate(availability,
                                self.slo.availability_objective)
        return {
            "latency_target_s": self.slo.latency_target_s,
            "latency_objective": self.slo.latency_objective,
            "latency_compliance": round(compliance, 6),
            "latency_burn_rate": round(lat_burn, 4),
            "availability_objective": self.slo.availability_objective,
            "availability": round(availability, 6),
            "availability_burn_rate": round(avail_burn, 4),
            "within_budget": lat_burn <= 1.0 and avail_burn <= 1.0,
        }

    # -- flight recorder ------------------------------------------------

    @property
    def flight_dumps(self) -> List[Dict[str, Any]]:
        """Automatic dumps captured so far (newest last, bounded)."""
        return list(self.recorder.dumps)

    def auto_dump(self, reason: str) -> Dict[str, Any]:
        """Dump the flight ring on a serving incident (breaker trip,
        device quarantine, compaction failure) — stored in
        :attr:`flight_dumps` and counted."""
        self._dumps_c.inc()
        return self.recorder.dump(reason, store=True)

    def dump_flight_recorder(self, reason: str = "manual"
                             ) -> Dict[str, Any]:
        """On-demand snapshot of the flight ring (not stored in the
        auto-dump list)."""
        self._dumps_c.inc()
        return self.recorder.dump(reason, store=False)
