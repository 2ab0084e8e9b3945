"""caps_tpu_torch serving tier: concurrent multi-client query service.

The counterpart of ``caps_tpu/serve/``: the layer between many client
threads and one engine session whose graph lives on the card:

    serve/errors.py     typed failure surface (Overloaded w/ retry_after,
                        DeadlineExceeded w/ phase attribution, Cancelled)
    serve/deadline.py   per-request budgets + cooperative cancel scopes,
                        checkpointed at engine phase boundaries
    serve/request.py    Request + the client-facing QueryHandle future
    serve/admission.py  bounded priority queue: admit or shed, never
                        queue unboundedly; graceful drain
    serve/batcher.py    micro-batching of plan-cache-compatible requests
    serve/failure.py    failure taxonomy: classify(exc) ->
                        TRANSIENT | POISONED_PLAN | FATAL
    serve/retry.py      RetryPolicy: deadline-charged backoff with
                        deterministic jitter
    serve/breaker.py    per-plan-family circuit breakers (quarantine +
                        degraded-ladder gating, health summary)
    serve/devices.py    device fault domains: per-device replica
                        sessions on their own streams + replicated
                        graphs, the health ladder (healthy ->
                        quarantined -> probing), background canary
                        probes, graph replication
    serve/server.py     QueryServer: worker pool (one worker per device
                        replica, or one serialized stream), serve.*
                        metrics, containment ladder, device failover,
                        snapshot pinning for versioned graphs
    serve/compaction.py background compaction of a versioned default
                        graph (delta-store backlog folding), health in
                        stats()["compaction"]
    serve/warmup.py     server warmup: run the hot plan families at
                        start (explicit list or persistent plan store —
                        relational/plan_store.py), outcome in
                        stats()["warmup"] / health_report()

Not ported yet (ROADMAP): shard groups (``serve/shards.py``, item 12)
and the fleet (``wire``, ``fleet``, ``router``, ``ha``, item 11).

Engine hooks this package owns: ``RelationalCypherSession.cypher_batch``
(one batched pass over a cached plan), the deadline checkpoints in
``relational/session.py`` / ``relational/ops.py``, and the fused
executor's batched-replay accounting (``backends/cuda/fused.py``).

``errors`` and ``deadline`` load eagerly (the engine imports them);
the server stack loads on first attribute access so importing the
relational layer never pulls in the whole tier.
"""
from caps_tpu_torch.serve.deadline import (CancelScope, cancel_scope, checkpoint,
                                     current_scope)
from caps_tpu_torch.serve.errors import (Cancelled, CancellationError, CircuitOpen,
                                   CompactionFailed, DeadlineExceeded,
                                   Overloaded, QueryFailed, ServeError,
                                   ServerClosed, WaitTimeout)
from caps_tpu_torch.serve.failure import (FATAL, POISONED_PLAN, TRANSIENT,
                                    attribute_device, classify, device_fault,
                                    device_of)

_LAZY = {
    "QueryServer": "caps_tpu_torch.serve.server",
    "ServerConfig": "caps_tpu_torch.serve.server",
    "AdmissionController": "caps_tpu_torch.serve.admission",
    "MicroBatcher": "caps_tpu_torch.serve.batcher",
    "batch_key": "caps_tpu_torch.serve.batcher",
    "QueryHandle": "caps_tpu_torch.serve.request",
    "Request": "caps_tpu_torch.serve.request",
    "INTERACTIVE": "caps_tpu_torch.serve.request",
    "BATCH": "caps_tpu_torch.serve.request",
    "RetryPolicy": "caps_tpu_torch.serve.retry",
    "CircuitBreaker": "caps_tpu_torch.serve.breaker",
    # re-exported from obs/telemetry.py: the serving SLO config rides
    # ServerConfig, so clients naturally look for it here
    "SLOConfig": "caps_tpu_torch.obs.telemetry",
    "Compactor": "caps_tpu_torch.serve.compaction",
    "WarmupConfig": "caps_tpu_torch.serve.warmup",
    "ServerWarmup": "caps_tpu_torch.serve.warmup",
    "ReplicaSet": "caps_tpu_torch.serve.devices",
    "DeviceReplica": "caps_tpu_torch.serve.devices",
    "replicate_graph": "caps_tpu_torch.serve.devices",
    "executing_device_index": "caps_tpu_torch.serve.devices",
}

__all__ = [
    "ServeError", "ServerClosed", "Overloaded", "CancellationError",
    "DeadlineExceeded", "Cancelled", "CircuitOpen", "QueryFailed",
    "WaitTimeout", "CompactionFailed", "CancelScope", "cancel_scope",
    "checkpoint",
    "current_scope", "classify", "TRANSIENT", "POISONED_PLAN", "FATAL",
    "device_fault", "attribute_device", "device_of",
    *sorted(_LAZY),
]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
