"""Compile telemetry: per-plan-family accounting of every compile boundary.

The counterpart of ``caps_tpu/obs/compile.py``.  Eager PyTorch compiles
nothing, but the engine pays the same first-run costs at the same
boundaries, and this ledger charges the host seconds of a shape's first
run at each of them:

* the **cold plan phase** in ``relational/session.py`` — parse → IR →
  logical → relational planning (kind ``"plan"``);
* a **fused record run** in ``backends/cuda/session.py`` — the
  record-mode execution that reads every data-dependent size (kind
  ``"fused_record"``);
* the **count-closure build** in ``relational/count_pattern.py`` — a
  miss in ``fused_count_fns`` builds and first-runs one closure (kind
  ``"count_fused"``);
* the **multiway join's first-seen step shape** in
  ``relational/wcoj.py`` (kind ``"wcoj"``).

Each boundary *charges* a :class:`CompileLedger`: wall seconds, a shape
signature, and first-seen-vs-re-compile per (family, kind, shape).

Attribution is thread-local: the session installs :func:`attributed`
around query execution with the plan-cache family (the normalized query
text), so charges made anywhere below land on the right family AND
accumulate into a per-query charge list the session stamps into
``result.metrics["compile_s_charged"]``.  Charges with no scope
installed (direct kernel use) fall back to a process-global ledger on
:func:`caps_tpu_torch.obs.metrics.global_registry`.

Charges also emit ``compile.<kind>`` tracer events into the active
tracer, so a traced cold query shows its compile spans next to the
phase spans.  All time goes through ``obs.clock``; instrumented modules
use the :func:`charged` context manager.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_lock
from caps_tpu_torch.obs.tracer import active_tracer

#: family used when a charge arrives with no attribution scope installed
UNATTRIBUTED = "(unattributed)"


class CompileLedger:
    """Per-plan-family compile accounting.

    ``charge()`` folds one compile boundary in: per family it keeps
    total/last wall seconds, per-kind counts, and a shape-signature set
    — a charge whose ``(kind, shape)`` was already seen for the family
    counts as a **re-compile** (a quarantined plan re-planning, a fused
    memo re-recording after ``forget``), the number AOT warmup and the
    persistent compile cache will be judged against.  Families are
    LRU-bounded so ad-hoc query churn cannot grow the ledger without
    bound.  Counters (``compile.events`` / ``compile.seconds`` /
    ``compile.recompiles``) and the ``compile.families`` gauge register
    in ``registry`` and ride ``metrics_snapshot()`` and the Prometheus
    exposition."""

    def __init__(self, registry=None, max_families: int = 256,
                 max_shapes: int = 32):
        self.max_families = max(1, int(max_families))
        self.max_shapes = max(1, int(max_shapes))
        self._families: Dict[str, Dict[str, Any]] = {}
        self._lock = make_lock("compile.CompileLedger._lock")
        self._events_c = (registry.counter("compile.events")
                         if registry is not None else None)
        self._seconds_c = (registry.counter("compile.seconds")
                          if registry is not None else None)
        self._recompiles_c = (registry.counter("compile.recompiles")
                             if registry is not None else None)
        if registry is not None:
            registry.gauge("compile.families", fn=self.family_count)

    def charge(self, family: str, kind: str, seconds: float,
               shape: Optional[str] = None) -> Dict[str, Any]:
        """Record one compile boundary crossing.  Returns the charge
        record (family, kind, seconds, shape, recompile, first_seen)."""
        seconds = max(0.0, float(seconds))
        now = clock.now()
        skey = f"{kind}|{shape}"
        with self._lock:
            ent = self._families.pop(family, None)
            first_seen = ent is None
            if ent is None:
                ent = {"first_t": now, "compiles": 0, "recompiles": 0,
                       "total_s": 0.0, "last_s": 0.0, "last_kind": kind,
                       "by_kind": {}, "shapes": {},
                       "shapes_evicted": False}
            self._families[family] = ent  # LRU touch: newest position
            while len(self._families) > self.max_families:
                self._families.pop(next(iter(self._families)))
            recompile = skey in ent["shapes"]
            shapes = ent["shapes"]
            shapes[skey] = shapes.get(skey, 0) + 1
            while len(shapes) > self.max_shapes:
                # the shape set is bounded: once anything is evicted,
                # a re-charge of an evicted shape can no longer be told
                # from a first compile — say so instead of silently
                # undercounting recompiles (readers see the flag)
                shapes.pop(next(iter(shapes)))
                ent["shapes_evicted"] = True
            ent["compiles"] += 1
            if recompile:
                ent["recompiles"] += 1
            ent["total_s"] += seconds
            ent["last_s"] = seconds
            ent["last_kind"] = kind
            bk = ent["by_kind"].setdefault(kind,
                                           {"count": 0, "seconds": 0.0})
            bk["count"] += 1
            bk["seconds"] += seconds
        # counters OUTSIDE the ledger lock (no lock-graph edge onto the
        # per-counter locks — same discipline as OpStatsStore)
        if self._events_c is not None:
            self._events_c.inc()
            self._seconds_c.inc(seconds)
            if recompile:
                self._recompiles_c.inc()
        return {"family": family, "kind": kind,
                "seconds": seconds, "shape": shape,
                "recompile": recompile, "first_seen": first_seen}

    # -- reads ----------------------------------------------------------

    def family_count(self) -> int:
        with self._lock:
            return len(self._families)

    def families(self) -> List[str]:
        with self._lock:
            return list(self._families)

    def seconds_for(self, family: str) -> float:
        with self._lock:
            ent = self._families.get(family)
            return float(ent["total_s"]) if ent is not None else 0.0

    def stats(self, family: Optional[str] = None) -> Dict[str, Any]:
        """Deep-copied per-family view (one family's entry when
        ``family`` is given, ``{}`` if it never compiled)."""
        def copy(ent):
            out = dict(ent)
            out["by_kind"] = {k: dict(v) for k, v in ent["by_kind"].items()}
            out["shapes"] = dict(ent["shapes"])
            return out
        with self._lock:
            if family is not None:
                ent = self._families.get(family)
                return copy(ent) if ent is not None else {}
            return {f: copy(ent) for f, ent in self._families.items()}

    def summary(self, top: int = 8) -> Dict[str, Any]:
        """The rollup ``stats()["compile"]`` / ``health_report()``
        expose: totals plus the ``top`` families by compile seconds."""
        with self._lock:
            events = sum(e["compiles"] for e in self._families.values())
            recompiles = sum(e["recompiles"]
                             for e in self._families.values())
            total_s = sum(e["total_s"] for e in self._families.values())
            fams = sorted(self._families.items(),
                          key=lambda kv: kv[1]["total_s"], reverse=True)
            evicted = any(e.get("shapes_evicted")
                          for e in self._families.values())
            by_family = {
                f[:120]: {"compiles": e["compiles"],
                          "recompiles": e["recompiles"],
                          "total_s": round(e["total_s"], 6),
                          "last_kind": e["last_kind"]}
                for f, e in fams[:top]}
        return {"families": len(self._families), "events": events,
                "recompiles": recompiles, "total_s": round(total_s, 6),
                # True = some family's shape set overflowed its bound,
                # so `recompiles` is a LOWER bound, not an exact count
                "recompiles_lower_bound": evicted,
                "by_family": by_family}


# -- thread-local attribution -------------------------------------------------

_tls = threading.local()

_global_lock = make_lock("compile._global_lock")
_global_ledger: Optional[CompileLedger] = None


def global_compile_ledger() -> CompileLedger:
    """The fallback ledger for charges made outside any attribution
    scope (direct kernel use) — counters land in the process-global
    metrics registry."""
    global _global_ledger
    with _global_lock:
        if _global_ledger is None:
            from caps_tpu_torch.obs.metrics import global_registry
            _global_ledger = CompileLedger(registry=global_registry())
        return _global_ledger


def current_charges() -> Optional[List[Dict[str, Any]]]:
    """The calling thread's live charge list (None outside any
    :func:`attributed` scope).  Instrumented callers that wrap a region
    ALREADY containing charge sites read this to subtract the nested
    charges and avoid double-counting (the CUDA session's fused-record
    boundary contains the count-fused / dist-join build boundaries)."""
    scope = getattr(_tls, "scope", None)
    return scope[2] if scope is not None else None


@contextlib.contextmanager
def attributed(ledger: CompileLedger, family: str):
    """Attribute every :func:`charge` on this thread to ``ledger`` under
    ``family`` (the plan-cache family — normalized query text).  Nesting
    (FROM GRAPH / CONSTRUCT subqueries) shares the OUTER scope's charge
    list, so a request's total compile seconds include its subqueries'.
    Yields the charge list the session stamps into result metrics."""
    prev = getattr(_tls, "scope", None)
    charges: List[Dict[str, Any]] = prev[2] if prev is not None else []
    _tls.scope = (ledger, family, charges)
    try:
        yield charges
    finally:
        _tls.scope = prev


def charge(kind: str, seconds: float, shape: Optional[str] = None,
           family: Optional[str] = None) -> Dict[str, Any]:
    """Charge one compile boundary to the thread's attributed ledger
    (or the process-global fallback).  Emits a ``compile.<kind>`` event
    into the active tracer when tracing is on."""
    scope = getattr(_tls, "scope", None)
    if scope is not None:
        ledger, fam, charges = scope
    else:
        ledger, fam, charges = global_compile_ledger(), None, None
    if family is not None:
        fam = family
    if fam is None:
        fam = UNATTRIBUTED
    rec = ledger.charge(fam, kind, seconds, shape=shape)
    if charges is not None:
        charges.append(rec)
    tracer = active_tracer()
    if tracer.enabled:
        tracer.event(f"compile.{kind}", kind="event", family=fam[:120],
                     seconds=rec["seconds"], shape=shape,
                     recompile=rec["recompile"])
    return rec


@contextlib.contextmanager
def charged(kind: str, shape: Optional[str] = None,
            family: Optional[str] = None):
    """Time a region and charge it as one compile boundary.  The clock
    reads live HERE, not at the instrumented site."""
    t0 = clock.now()
    try:
        yield
    finally:
        charge(kind, clock.now() - t0, shape=shape, family=family)
