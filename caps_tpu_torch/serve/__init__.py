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
    serve/shards.py     shard groups: one hash-partitioned graph behind
                        N member sessions (capacity members mixed into
                        the ReplicaSet) — single-shard routing,
                        mesh-sharded cross-shard execution, group-level
                        health ladder with background member rebuild,
                        host-memory partition paging
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
    serve/wire.py       fleet wire protocol: length-prefixed JSON
                        frames, typed-error round trip, WireClient
    serve/fleet.py      fleet backends: one QueryServer per process
                        behind a socket listener (in-process threads or
                        spawned interpreters, each with its own CUDA
                        context), snapshot export/install, the WAL and
                        write lease of durable fleets (durability/)
    serve/router.py     stateless consistent-hash router: plan-family
                        affinity, load-aware spill, ring-degrading
                        failover, snapshot shipping, fleet-wide scrape,
                        end-to-end deadline budgets, hedged reads
    serve/ha.py         router high availability: epoch-fenced
                        active/standby routers on a second lease
                        namespace, zombie-router fencing, the
                        RouterSet client facade

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
    # sharded serving (serve/shards.py): partitioned graphs behind the
    # same server
    "ShardGroup": "caps_tpu_torch.serve.shards",
    "ShardGroupConfig": "caps_tpu_torch.serve.shards",
    "GraphPartition": "caps_tpu_torch.serve.shards",
    "partition_graph": "caps_tpu_torch.serve.shards",
    "executing_shard": "caps_tpu_torch.serve.shards",
    "ShardingUnsupported": "caps_tpu_torch.serve.errors",
    "ShardMemberDown": "caps_tpu_torch.serve.errors",
    # fleet serving (serve/wire.py, serve/fleet.py, serve/router.py):
    # multi-process scale-out behind a consistent-hash router
    "WireError": "caps_tpu_torch.serve.errors",
    "FleetUnavailable": "caps_tpu_torch.serve.errors",
    "StaleEpoch": "caps_tpu_torch.serve.errors",
    "WalWriteError": "caps_tpu_torch.serve.errors",
    "error_from_payload": "caps_tpu_torch.serve.errors",
    "WireClient": "caps_tpu_torch.serve.wire",
    "BackendSpec": "caps_tpu_torch.serve.fleet",
    "FleetBackend": "caps_tpu_torch.serve.fleet",
    "spawn_backend": "caps_tpu_torch.serve.fleet",
    "rows_digest": "caps_tpu_torch.serve.fleet",
    "HashRing": "caps_tpu_torch.serve.router",
    "RouterConfig": "caps_tpu_torch.serve.router",
    "FleetRouter": "caps_tpu_torch.serve.router",
    # router HA (serve/ha.py): replicated routers behind one lease
    "HARouter": "caps_tpu_torch.serve.ha",
    "RouterSet": "caps_tpu_torch.serve.ha",
    "RouterSpec": "caps_tpu_torch.serve.ha",
    "spawn_router": "caps_tpu_torch.serve.ha",
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
