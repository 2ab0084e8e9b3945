"""Metrics registry: counters, gauges, histograms.

The counterpart of ``caps_tpu/obs/metrics.py``: the session's named
counters (``plan_cache.*``, ``cost.*``, ``wcoj.*``, ``replan.*``,
``stats.*``, ``opstats.*``, ``updates.*``, ``compaction.*``,
``compile.*``, ``serve.*``), its gauges (``mem.*``, ``telemetry.*``,
``slo.*``) and its histograms, behind one snapshot API
(``session.metrics_snapshot()``) and the Prometheus text exposition
(:meth:`MetricsRegistry.expose_text`).

Two scopes:

* each session owns a :class:`MetricsRegistry` (its plan cache routes
  hits/misses/evictions/invalidations through it);
* one process-global registry (:func:`global_registry`) collects
  instrumentation that has no session handle (the fault injectors'
  ``faults.injected.*``).

Snapshots are flat ``{name: number}`` dicts; :func:`diff_snapshots`
subtracts two of them so callers measure an interval without
hand-rolling before/after counters.

All instruments are thread-safe (fine-grained per-instrument locks,
plus a registry lock for get-or-create): the serving tier
(``serve/``) updates them from many threads at once.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

from caps_tpu_torch.obs.lockgraph import make_lock

Number = Union[int, float]

_EXPO_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _expo_name(name: str) -> str:
    """A dotted registry name as a Prometheus metric name: the exposition
    grammar allows ``[a-zA-Z_:][a-zA-Z0-9_:]*``, so dots (and anything
    else) become underscores and a leading digit gets prefixed."""
    n = _EXPO_BAD.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return n or "_"


def _expo_num(v: Number) -> str:
    """A sample value in exposition syntax (Go-style float parsing on the
    scrape side accepts plain ints, decimals, and scientific notation)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


class Counter:
    """Monotonically increasing value (int or float — ``saved_s``-style
    second counters are floats).

    Thread-safe: ``inc`` is a read-modify-write, and serving threads
    (serve/) increment shared counters concurrently — a naked
    ``+=`` loses updates under thread switches, so each counter carries
    its own lock (fine-grained: hot counters never contend with each
    other)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0
        self._lock = make_lock("metrics.Counter._lock")

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Point-in-time value: set directly, or backed by a callback so the
    snapshot always reads the live source (e.g. cache entry counts)."""

    __slots__ = ("name", "_value", "fn")

    def __init__(self, name: str, fn: Optional[Callable[[], Number]] = None):
        self.name = name
        self._value: Number = 0
        self.fn = fn

    def set(self, v: Number) -> None:
        self._value = v

    @property
    def value(self) -> Number:
        if self.fn is not None:
            try:
                return self.fn()
            except Exception:
                return self._value
        return self._value


_DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0)


class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` buckets, Prometheus
    style) plus count/sum/min/max."""

    __slots__ = ("name", "buckets", "counts", "count", "sum", "min", "max",
                 "_lock")

    def __init__(self, name: str,
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        # observe() updates five fields; a torn update (count bumped,
        # sum not) would corrupt mean/percentile math under concurrency
        self._lock = make_lock("metrics.Histogram._lock")

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def snapshot(self) -> Dict[str, Number]:
        with self._lock:
            out: Dict[str, Number] = {"count": self.count,
                                      "sum": round(self.sum, 9)}
            if self.count:
                out["min"] = self.min
                out["max"] = self.max
                out["mean"] = self.sum / self.count
            return out

    def raw(self):
        """``(bounds, per-bucket counts copy, count, sum)`` read under
        the lock — the Prometheus exposition path's consistent view."""
        with self._lock:
            return self.buckets, list(self.counts), self.count, self.sum


class MetricsRegistry:
    """Name → instrument map with get-or-create accessors.

    Names are dotted (``plan_cache.hits``, ``collectives.ppermute.calls``);
    ``snapshot()`` flattens everything into one dict (histograms expand
    to ``name.count`` / ``name.sum`` / ...)."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # guards the name→instrument maps (get-or-create races would
        # hand two threads two different Counter objects for one name,
        # silently splitting the count; snapshot() iterates the maps)
        self._lock = make_lock("metrics.MetricsRegistry._lock")

    # -- get-or-create -------------------------------------------------

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.get(name)
                if c is None:
                    c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str,
              fn: Optional[Callable[[], Number]] = None) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, fn)
            elif fn is not None:
                g.fn = fn
            return g

    def histogram(self, name: str,
                  buckets: Sequence[float] = _DEFAULT_BUCKETS) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.get(name)
                if h is None:
                    h = self._histograms[name] = Histogram(name, buckets)
        return h

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    # -- snapshots -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            histograms = list(self._histograms.items())
        out: Dict[str, Any] = {}
        for name, c in counters:
            out[name] = c.value
        for name, g in gauges:
            out[name] = g.value
        for name, h in histograms:
            for k, v in h.snapshot().items():
                out[f"{name}.{k}"] = v
        return out

    def expose_text(self, extra: Optional[Mapping[str, Number]] = None
                    ) -> str:
        """The whole registry in Prometheus text exposition format
        (version 0.0.4): counters and gauges as single samples,
        histograms as cumulative ``_bucket{le=...}`` series plus
        ``_sum``/``_count``.  Dotted names sanitize to underscore form
        (``serve.completed`` → ``serve_completed``).  ``extra`` renders
        additional ``{name: value}`` pairs as gauges — the serving
        tier's windowed values ride this when they are not already
        registered as live-callback gauges."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            histograms = sorted(self._histograms.items())
        lines = []
        for name, c in counters:
            n = _expo_name(name)
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {_expo_num(c.value)}")
        for name, g in gauges:
            n = _expo_name(name)
            v = g.value
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue  # a callback gauge may surface non-numerics
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_expo_num(v)}")
        for name, h in histograms:
            n = _expo_name(name)
            bounds, counts, count, total = h.raw()
            lines.append(f"# TYPE {n} histogram")
            cum = 0
            for le, cnt in zip(bounds, counts):
                cum += cnt
                lines.append(f'{n}_bucket{{le="{_expo_num(le)}"}} {cum}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {count}')
            lines.append(f"{n}_sum {_expo_num(total)}")
            lines.append(f"{n}_count {count}")
        for name, v in sorted((extra or {}).items()):
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            n = _expo_name(name)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_expo_num(v)}")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    """The process-wide registry (instrumentation without a session)."""
    return _GLOBAL


def diff_snapshots(before: Dict[str, Any],
                   after: Dict[str, Any]) -> Dict[str, Any]:
    """``after - before`` on every numeric key (keys new in ``after``
    diff against 0; non-numeric values pass through from ``after``)."""
    out: Dict[str, Any] = {}
    for k, v in after.items():
        b = before.get(k, 0)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            out[k] = v
        elif isinstance(b, (int, float)) and not isinstance(b, bool):
            out[k] = v - b
        else:
            out[k] = v
    return out


def merge_snapshots(snaps: Sequence[Dict[str, Any]]) -> Dict[str, Number]:
    """Sum numeric keys across per-process snapshots — the fleet-wide
    aggregation behind one Prometheus scrape (serve/router.py
    ``metrics_text``).  Counters and gauges add; non-numeric values are
    dropped (per-process detail stays on the per-process scrape)."""
    out: Dict[str, Number] = {}
    for snap in snaps:
        for k, v in snap.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            out[k] = out.get(k, 0) + v
    if "rescache.hit_ratio" in out:
        # ratios don't sum: recompute the fleet-wide result-cache hit
        # ratio from the summed hit/miss counters
        h = out.get("rescache.hits", 0)
        m = out.get("rescache.misses", 0)
        out["rescache.hit_ratio"] = (h / (h + m)) if (h + m) else 0.0
    return out
