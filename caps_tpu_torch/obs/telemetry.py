"""Observed per-operator statistics (``OpStatsStore``).

The counterpart of the observed-statistics part of
``caps_tpu/obs/telemetry.py``: per (plan family, operator id) observed
rows / bytes / wall time, recorded by the session from the per-operator
entries ``relational/ops.py`` appends, so the numbers are fused-replay
aware by construction.  When an entry carries the planner's own
estimate (``est_rows``, stamped by ``relational/cost.py
annotate_plan``) the divergence check measures model error, and a
family whose executions keep diverging becomes a re-plan candidate
(``take_replan_candidates``).  Its counters (``opstats.recorded``,
``opstats.divergences``, ``replan.candidates``) and the
``opstats.families`` gauge go to the session's metrics registry.

The serving half of the reference module (``ServingTelemetry``,
``FlightRecorder``, ``SLOConfig``, the rolling counters) comes with the
serving tier (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from caps_tpu_torch.obs.lockgraph import make_lock


class OpStatsStore:
    """Observed per-plan-node statistics, keyed
    ``(plan family, operator id)``.

    An observation off the planner's estimate by more than
    ``divergence_factor`` (either direction), above ``divergence_floor``
    rows and in a different padded bucket, ticks the divergence
    counters; ``replan_threshold`` such executions make the family a
    re-plan candidate.  Entries without an estimate fall back to the
    running mean.  Families are LRU-bounded (``max_families``)."""

    def __init__(self, registry=None,
                 max_families: int = 128,
                 divergence_factor: float = 4.0,
                 replan_threshold: int = 2,
                 divergence_floor: int = 256,
                 bucket_fn=None):
        self.max_families = max(1, int(max_families))
        self.divergence_factor = max(1.0, float(divergence_factor))
        #: model error below this many rows (both sides) never counts:
        #: everything under the smallest shape bucket pads identically
        self.divergence_floor = max(0, int(divergence_floor))
        #: rows -> padded-bucket boundary (the session's shape lattice):
        #: model error that does not change the padded bucket changes no
        #: launch shape and never diverges
        self.bucket_fn = bucket_fn
        #: model-divergent EXECUTIONS a family needs before it is
        #: surfaced as a re-plan candidate
        self.replan_threshold = max(1, int(replan_threshold))
        self._families: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self.recorded = 0
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
                    # model error: actual vs the planner's estimate, on
                    # every execution, counted only when it changes the
                    # padded bucket above the floor
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
                    # drift check against the running mean
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
        threshold since the last call — handed off exactly once."""
        with self._lock:
            out, self._replan_candidates = self._replan_candidates, []
            return out

    def reset_family(self, family: str) -> None:
        """Drop one family's recorded per-operator history: operator ids
        do not transfer across plan shapes, so a re-planned family's
        history restarts under the new plan's operators."""
        with self._lock:
            self._families.pop(family, None)
            self._diverged_execs.pop(family, None)

    # -- reads ----------------------------------------------------------

    def stats(self, family: Optional[str] = None) -> Dict[str, Any]:
        """Deep-copied view: ``{family: {op_id: stats}}``, or one
        family's ``{op_id: stats}`` when ``family`` is given."""
        with self._lock:
            if family is not None:
                return {k: dict(v)
                        for k, v in self._families.get(family, {}).items()}
            return {f: {k: dict(v) for k, v in ops.items()}
                    for f, ops in self._families.items()}

    def family_count(self) -> int:
        with self._lock:
            return len(self._families)

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
