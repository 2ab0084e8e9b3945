"""Observability: the part of ``caps_tpu/obs/`` the cost model reads.

Only the observed-statistics store (:class:`OpStatsStore`) and a set of
named counters (:class:`Counters`, standing in for the metrics registry)
are here; the tracer, the registry, the compile ledger, PROFILE, the
lock graph and the exporters are ROADMAP Queue 1 item 5.
"""
from caps_tpu_torch.obs.telemetry import Counters, OpStatsStore  # noqa: F401
