"""caps_tpu_torch observability: tracing, metrics, EXPLAIN/PROFILE plumbing.

The counterpart of ``caps_tpu/obs/``: structured spans (query → phase →
relational operator) with wall time, device time, output cardinality
and bytes moved; a metrics registry for the session's counters, gauges
and histograms; the compile and memory ledgers; the lock-order graph;
and exporters (JSON-lines, ``chrome://tracing``).  The Cypher
``EXPLAIN`` / ``PROFILE`` query prefixes (relational/session.py) are the
user-facing entry points; ``session.metrics_snapshot()`` is the
programmatic one.

Design constraints:

* near-zero overhead when disabled — a disabled tracer returns a shared
  no-op span; per-operator instrumentation costs one attribute check
  and adds no synchronizing call;
* never silently wrong numbers — fused-replay runs tag per-operator
  times as host dispatch and report device time as a per-replay
  aggregate span (backends/cuda/session.py ``_annotate_profile``);
* one clock — timestamps come from :mod:`caps_tpu_torch.obs.clock`.

The serving tier (``serve/``) reads the event and slow-query logs
(``obs/log.py``) and the windowed telemetry of ``obs/telemetry.py``
(rolling counters and histograms, SLOs, the flight recorder).
"""
from caps_tpu_torch.obs import clock, lockgraph
from caps_tpu_torch.obs.compile import (CompileLedger, attributed as
                                        compile_attributed, charge as
                                        compile_charge, charged as
                                        compile_charged,
                                        global_compile_ledger)
from caps_tpu_torch.obs.export import (chrome_trace_events,
                                       write_chrome_trace, write_jsonl)
from caps_tpu_torch.obs.ledger import (MemoryLedger, device_memory,
                                       snapshot_footprint)
from caps_tpu_torch.obs.log import EventLog, SlowQueryLog
from caps_tpu_torch.obs.metrics import (MetricsRegistry, diff_snapshots,
                                        global_registry)
from caps_tpu_torch.obs.profile import (find_executed_rows, profile_tree,
                                        render_profile, tag_timing)
from caps_tpu_torch.obs.telemetry import (FlightRecorder, OpStatsStore,
                                          RollingCounter, RollingHistogram,
                                          ServingTelemetry, SLOConfig)
from caps_tpu_torch.obs.tracer import (NULL_SPAN, NullSpan, Span, Tracer,
                                       activate, active_tracer)

__all__ = [
    "clock", "lockgraph", "Span", "NullSpan", "NULL_SPAN", "Tracer",
    "activate", "active_tracer", "MetricsRegistry", "global_registry",
    "diff_snapshots", "write_jsonl", "write_chrome_trace",
    "chrome_trace_events", "profile_tree", "render_profile", "tag_timing",
    "find_executed_rows", "OpStatsStore", "SLOConfig", "ServingTelemetry",
    "FlightRecorder", "RollingCounter", "RollingHistogram",
    "CompileLedger", "compile_attributed", "compile_charge",
    "compile_charged", "global_compile_ledger",
    "MemoryLedger", "device_memory", "snapshot_footprint",
    "EventLog", "SlowQueryLog",
]
