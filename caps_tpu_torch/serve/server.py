"""QueryServer: the multi-client query-serving tier (the counterpart of
``caps_tpu/serve/server.py``).

Turns an engine session into a service: clients ``submit()`` queries
from any thread and get Future-style handles back; a worker pool
executes them through the session's prepared-plan path with

* **admission control** — a bounded priority queue that sheds load with
  a typed ``Overloaded`` (retry_after hint) instead of queuing
  unboundedly (serve/admission.py);
* **micro-batching** — compatible in-flight requests (same normalized
  query / plan-cache key family) execute as one batched pass over the
  cached plan (serve/batcher.py, ``session.cypher_batch``);
* **deadlines + cooperative cancellation** — per-request budgets
  checked at engine phase boundaries (serve/deadline.py), with the
  expiry phase attributed in the error and the trace;
* **device fault domains** — with ``ServerConfig.devices=N`` the pool
  runs one worker per device replica (serve/devices.py): each worker
  owns a device with its own session (per-device plan cache, string
  pool, fused memos) and a replicated copy of the served graph, so N
  dispatch streams run in parallel.  Transient failures retry on a
  DIFFERENT device; ``device_failure_threshold`` consecutive
  device-attributed failures quarantine the device (its claimed work
  drains back to the dispatcher, capacity degrades to N-1, and the
  admission controller's retry_after estimator is told so), and a
  background canary probe reinstates it after ``device_cooldown_s``.

With ``devices=None`` (the default) execution is serialized through one
dispatch stream: workers share replica 0 — the caller's own session, on
a stream of its own on a card — and overlap admission, timeout handling,
and materialization while one executes.  A worker reads a batch's rows
after the batch's last member dispatched, so an exact-replay batch
waits for the card once.

With ``shards=N`` the server also fronts ONE hash-partitioned graph
behind a shard group of N member sessions (``serve/shards.py``):
single-shard queries route to the owning member, cross-shard patterns
ride the group's mesh session, and the failure ladder runs at group
level.

**Writes.**  Against a versioned default graph
(relational/updates.py), reads pin the latest committed snapshot AT
ADMISSION and finish on it — batch members, retries, degraded
re-executions, and cross-device failovers all replay that exact
version (no torn reads); write statements keep the mutable handle
(mode ``"write"``: never batched, pinned to device 0), commit
failure-atomically, and flow through the same classify/retry ladder as
reads — a transient mid-commit fault rolled back completely, so the
retry is safe.  ``ServerConfig.compaction_threshold_rows`` enables the
background compactor (serve/compaction.py), surfaced in
``stats()["compaction"]``.

Serving metrics land in the session's registry under ``serve.*``
(queue depth gauge, admitted/shed/completed/requeued counters, latency +
queue-wait + batch-size histograms, device quarantine/reinstate
transitions) and show up in ``session.metrics_snapshot()`` next to
everything else.

**Windowed telemetry** (obs/telemetry.py) sits on top of the cumulative
counters: rolling p50/p95/p99 latency, queue wait, batch occupancy,
shed/retry/abort rates and per-device utilization over the last
``telemetry_window_s`` seconds; an optional SLO (``ServerConfig.slo``)
evaluated into error-budget burn rates; a bounded per-request **flight
recorder** dumped automatically on breaker trips, device quarantines,
and compaction failures (``server.dump_flight_recorder()`` on demand).
``health_report()`` is the structured rollup, ``stats()["telemetry"]``
/ ``stats()["slo"]`` / ``stats()["batching"]`` the stats view, and
``server.metrics_text()`` the Prometheus text exposition of the whole
registry (windowed gauges included).

**Resource accounting** (obs/compile.py + obs/ledger.py + obs/log.py):
every finished request carries a ``ledger`` dict on its handle (bytes
in/out, compile seconds charged, peak rows) and in its flight record;
the per-plan-family compile ledger surfaces in ``stats()["compile"]`` /
``health_report()`` and drives ``warmup_report()`` (which hot families
never compiled here — what the warmup warms); byte footprints (plan
cache, string pool, base+delta per snapshot, the card's memory) in
``stats()["memory"]``; and a structured event log (``server.events()``)
plus a slow-query log (``ServerConfig.slow_query_threshold_s`` →
``server.slow_queries()``, records mergeable with flight dumps)
correlate it all by request id / plan family / snapshot version.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Mapping, Optional

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_lock
from caps_tpu_torch.obs.log import EventLog, SlowQueryLog
from caps_tpu_torch.obs.telemetry import ServingTelemetry, SLOConfig
from caps_tpu_torch.relational.result_cache import (
    CachedRows, ResultCacheConfig, graph_version, result_cache_key,
)
from caps_tpu_torch.serve import batcher as _batcher
from caps_tpu_torch.serve.admission import AdmissionController
from caps_tpu_torch.serve.batcher import MicroBatcher
from caps_tpu_torch.serve.breaker import REJECT, TRIAL, CircuitBreaker
from caps_tpu_torch.serve.deadline import CancelScope, cancel_scope
from caps_tpu_torch.serve.devices import DeviceReplica, ReplicaSet
from caps_tpu_torch.serve.errors import (
    Cancelled, CancellationError, CircuitOpen, DeadlineExceeded, Overloaded,
    QueryFailed,
)
from caps_tpu_torch.serve.failure import (
    FATAL, TRANSIENT, attribute_device, classify, device_of,
    quarantine_plan_state,
)
from caps_tpu_torch.serve.request import INTERACTIVE, QueryHandle, Request
from caps_tpu_torch.serve.shards import ShardGroup, ShardGroupConfig
from caps_tpu_torch.serve.retry import RetryPolicy
from caps_tpu_torch.serve.warmup import ServerWarmup, WarmupConfig

_UNSET = object()

#: batch-size histogram buckets (powers of two up to the queue bound)
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

#: degraded execution ladder (failure containment): 0 = the normal
#: serving path (cached plan, fused replay); 1 = plan-cache bypass —
#: a fresh plan, fused execution re-records from scratch; 2 = fresh plan
#: AND per-operator unfused execution (no shared cached state at all).
_LADDER = ("fused", "replan", "unfused")

#: upper bound on a quarantined worker's nap between probe checks —
#: keeps it responsive to shutdown without hot-spinning
_PROBE_NAP_S = 0.05


def _fresh_copy(ex: BaseException) -> BaseException:
    """A fresh same-type exception for fanning one batch-level setup
    failure out to every member (handles must never share one mutable
    error object).  The classification markers ride along — a copy that
    lost ``caps_transient`` would send its member down the quarantine
    ladder while the original retried.  Exception types with
    non-reconstructible constructors fall back to the original
    instance."""
    try:
        fresh = type(ex)(*ex.args)
    except Exception:
        return ex
    for attr in ("caps_transient", "caps_device_fault", "caps_failed_op",
                 "caps_device_index"):
        val = getattr(ex, attr, None)
        if val is not None:
            try:
                setattr(fresh, attr, val)
            except Exception:  # pragma: no cover — slotted exception
                return ex
    return fresh


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    #: worker threads when ``devices`` is None: execution then runs one
    #: serialized device stream, extra workers overlap admission and
    #: materialization.  With ``devices=N`` the pool is one worker per
    #: device and this field is ignored.
    workers: int = 2
    #: device replicas (serve/devices.py): N parallel dispatch streams,
    #: each worker owning a replica with a replicated graph and its own
    #: cached state.  None = one stream on the caller's session.  The
    #: replicas run on the session's device: one card each when the
    #: process sees N cards, else clones on the session's card (each on
    #: a stream of its own); a CPU session's replicas are CPU sessions.
    devices: Optional[int] = None
    #: global queue bound — beyond it submit() sheds with Overloaded
    max_queue: int = 64
    #: optional per-priority queue caps, e.g. {BATCH: 16} keeps
    #: background traffic from filling the queue
    per_priority_limits: Optional[Dict[int, int]] = None
    #: max requests coalesced into one micro-batch
    max_batch: int = 8
    #: seconds a batch leader waits for followers (0 = batch only what
    #: is already queued — no added leader latency)
    batch_window_s: float = 0.0
    #: ragged bucket batching (serve/batcher.py + relational/shapes.py):
    #: the batch key widens from the exact plan family to the parameter
    #: SHAPE-BUCKET signature, so different queries' shape-compatible
    #: launches pack into one shared batch window.  Members keep their
    #: own cached plans (results stay exact) and their own plan-family
    #: breakers/quarantine (``Request.plan_key``).
    ragged_batching: bool = False
    #: AOT warmup at server start (serve/warmup.py): precompile the hot
    #: families — from an explicit list or a persistent plan store —
    #: through the normal compile boundaries, so the compile ledger
    #: proves coverage before traffic arrives.  None = no warmup.
    warmup: Optional["WarmupConfig"] = None
    #: shard-group capacity members (serve/shards.py): with ``shards=N``
    #: the server fronts ONE hash-partitioned graph — the ``shard_graph``
    #: passed at construction, defaulting to the default graph — behind
    #: a group of N member sessions: single-shard queries route to the
    #: owning member, cross-shard patterns ride the group's mesh
    #: session, and the failure ladder runs at GROUP level (a dead shard
    #: degrades its group, never the server).  Replica members
    #: (``devices``) keep serving every other graph.
    shards: Optional[int] = None
    #: knobs for the group (partition property, paging budget, ladder
    #: thresholds); ``members`` is overridden by ``shards``
    shard_config: Optional["ShardGroupConfig"] = None
    #: default per-request budget (None = no deadline)
    default_deadline_s: Optional[float] = None
    default_priority: int = INTERACTIVE
    #: materialize rows on the worker (handle.rows() is then free)
    materialize: bool = True
    #: transient-error retry (serve/retry.py): exponential backoff with
    #: deterministic jitter, charged against the request's deadline;
    #: with multiple devices the re-execution fails over to a DIFFERENT
    #: healthy device
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    #: consecutive request-level failures (whole containment ladder
    #: exhausted) before a plan family's circuit breaker opens
    breaker_threshold: int = 3
    #: seconds an open breaker fast-fails a family before letting one
    #: half-open trial through
    breaker_cooldown_s: float = 5.0
    #: consecutive DEVICE-attributed failures (serve/failure.py
    #: ``device_fault``) before a device replica is quarantined; only
    #: meaningful with ``devices >= 2`` (there is no failover target
    #: for a single device)
    device_failure_threshold: int = 3
    #: seconds a quarantined device sits out before each background
    #: half-open canary probe
    device_cooldown_s: float = 1.0
    #: delta-store backlog (rows) that triggers background compaction of
    #: a versioned default graph (serve/compaction.py); None disables
    #: the row trigger (explicit ``graph.compact()`` still works)
    compaction_threshold_rows: Optional[int] = None
    #: delta-store backlog (bytes — ``graph.delta_nbytes()``) that
    #: triggers background compaction; crossing EITHER threshold folds.
    #: A few huge property rows can now trigger compaction long before
    #: the row count would.
    compaction_threshold_bytes: Optional[int] = None
    #: cadence of the compactor's backlog checks
    compaction_interval_s: float = 0.05
    #: structured slow-query log (obs/log.py): any request whose total
    #: latency crosses this captures a full record — plan text, per-op
    #: stats, ledger (bytes in/out, compile seconds, peak rows) — in
    #: ``server.slow_queries()``; None disables capture
    slow_query_threshold_s: Optional[float] = None
    #: bounded ring size of captured slow-query records
    slow_query_log_size: int = 64
    #: bounded ring size of the structured event log (compile charges,
    #: breaker trips, quarantines, compaction failures, slow queries —
    #: ``server.events()``)
    event_log_capacity: int = 1024
    #: optional JSON-lines sink: every structured event also appends to
    #: this file (off-process ingestion)
    event_log_path: Optional[str] = None
    #: serving SLO (obs/telemetry.py): a latency target + objectives
    #: evaluated over the telemetry window into error-budget burn rates
    #: (``health_report()``, ``slo.*`` gauges); None = no SLO evaluation
    #: (windowed telemetry is still collected)
    slo: Optional[SLOConfig] = None
    #: rolling telemetry window: ``telemetry_buckets`` ring slots
    #: spanning ``telemetry_window_s`` seconds, rotated on obs.clock
    telemetry_window_s: float = 60.0
    telemetry_buckets: int = 60
    #: bounded ring of per-request flight records (the postmortem black
    #: box, dumped on breaker-trip / quarantine / compaction-failure
    #: and via ``dump_flight_recorder()``)
    flight_recorder_size: int = 256
    #: snapshot-keyed result cache (relational/result_cache.py):
    #: hot repeated reads return at ADMISSION — no worker slot, no device
    #: dwell, no batch window (flight records stamp outcome="cache_hit").
    #: None = every read pays the device path.
    result_cache: Optional["ResultCacheConfig"] = None


class QueryServer:
    """Concurrent serving facade over one session.

    >>> server = QueryServer(session, graph=g)
    >>> h = server.submit("MATCH (n:Person) WHERE n.age > $a "
    ...                   "RETURN n.name AS name", {"a": 30})
    >>> h.rows()
    [...]
    >>> server.shutdown()
    """

    def __init__(self, session, graph=None,
                 config: Optional[ServerConfig] = None, start: bool = True,
                 shard_graph=None):
        self.session = session
        self.config = config or ServerConfig()
        self._shard_graph = shard_graph
        self._default_graph = graph if graph is not None \
            else session._ambient
        registry = session.metrics_registry
        #: windowed telemetry + SLO + flight recorder (obs/telemetry.py):
        #: rolling p50/p95/p99, error-budget burn rates, the per-request
        #: black box, and the live ``telemetry.*``/``slo.*`` gauges
        self.telemetry = ServingTelemetry(
            registry, window_s=self.config.telemetry_window_s,
            buckets=self.config.telemetry_buckets, slo=self.config.slo,
            flight_recorder_size=self.config.flight_recorder_size)
        #: structured event log (obs/log.py): compile charges, breaker
        #: trips, quarantines, compaction failures, slow queries — every
        #: event correlated by request id / plan family
        self.event_log = EventLog(capacity=self.config.event_log_capacity,
                                  registry=registry,
                                  path=self.config.event_log_path)
        #: divergence-triggered re-planning (relational/session.py
        #: ``_maybe_replan``): the session retires a cached family whose
        #: executions keep diverging from the cost model's estimates;
        #: this listener lands the ``replan.*`` transitions in the
        #: structured event log so the loop is observable end-to-end
        #: (the re-plan's compile charge follows as ``compile.charged``)
        listeners = getattr(session, "replan_listeners", None)
        if listeners is not None:
            listeners.append(self._on_replan)
        #: slow-query log: over-threshold requests captured with plan
        #: text, per-op stats, and the resource ledger (None = disabled)
        self.slow_log = None
        if self.config.slow_query_threshold_s is not None:
            self.slow_log = SlowQueryLog(
                self.config.slow_query_threshold_s,
                capacity=self.config.slow_query_log_size,
                registry=registry, event_log=self.event_log)
        #: memory ledger (obs/ledger.py): account the served graph so
        #: ``stats()["memory"]`` carries its base/delta footprint.
        #: Tracked under THIS server as owner: several servers on one
        #: session each hold their own "default" slot, and shutdown
        #: releases only ours — a short-lived sibling can never drop a
        #: live server's accounting.
        ledger = getattr(session, "memory_ledger", None)
        if ledger is not None:
            ledger.track("default", self._default_graph, owner=self)
        #: snapshot-keyed result cache (relational/result_cache.py):
        #: consulted at admission, fed at completion.  Attached to the
        #: session so the memory ledger's mem.result_cache_bytes gauge
        #: sees it.
        self.result_cache = None
        if self.config.result_cache is not None \
                and self.config.result_cache.enabled:
            from caps_tpu_torch.relational.result_cache import ResultCache
            self.result_cache = ResultCache(self.config.result_cache,
                                            registry=registry)
            session.result_cache = self.result_cache
        #: shard-group capacity members (serve/shards.py): one group of
        #: ``config.shards`` member sessions fronting the partitioned
        #: ``shard_graph`` (default: the server's default graph).  Built
        #: BEFORE the replica set so both kinds of member sit behind the
        #: same dispatch/claim machinery.
        self.shard_groups: List[ShardGroup] = []
        if self.config.shards:
            target = shard_graph if shard_graph is not None \
                else self._default_graph
            gcfg = self.config.shard_config or ShardGroupConfig()
            gcfg = dataclasses.replace(gcfg, members=self.config.shards)
            self.shard_groups.append(ShardGroup(
                session, target, gcfg, registry=registry,
                event_log=self.event_log,
                index=(self.config.devices or 1),
                on_change=lambda: self.admission.set_active_workers(
                    self.devices.live_count() or 1)))
        self.admission = AdmissionController(
            registry, max_queue=self.config.max_queue,
            per_priority_limits=self.config.per_priority_limits,
            workers=(self.config.devices or self.config.workers)
            + len(self.shard_groups),
            telemetry=self.telemetry)
        self.batcher = MicroBatcher(self.admission,
                                    max_batch=self.config.max_batch,
                                    window_s=self.config.batch_window_s)
        self.retry_policy = self.config.retry or RetryPolicy()
        self.breaker = CircuitBreaker(
            registry, failure_threshold=self.config.breaker_threshold,
            cooldown_s=self.config.breaker_cooldown_s)
        #: the device fault domains: replica 0 is the caller's session;
        #: replicas 1..N-1 are clones with re-ingested graph copies.
        #: Quarantine/reinstate transitions re-tell the admission
        #: controller how many parallel streams are actually live.
        #: replicas never eagerly ingest a group-served default graph —
        #: capacity lives on the group's members, that is the point
        replica_default = graph
        if self.shard_groups and \
                self.shard_groups[0].serves(self._default_graph):
            replica_default = None
        self.devices = ReplicaSet(
            session, graph=replica_default,
            n_devices=self.config.devices or 1,
            registry=registry,
            failure_threshold=self.config.device_failure_threshold,
            cooldown_s=self.config.device_cooldown_s,
            on_change=lambda: self.admission.set_active_workers(
                self.devices.live_count() or 1),
            groups=self.shard_groups)
        #: AOT warmup driver (serve/warmup.py) — None unless configured.
        #: ``start()`` runs it (inline or background per its config);
        #: progress/outcome ride ``stats()["warmup"]``.
        self.warmer = (ServerWarmup(self, self.config.warmup)
                       if self.config.warmup is not None else None)
        self._completed = registry.counter("serve.completed")
        self._failed = registry.counter("serve.failed")
        self._cancelled = registry.counter("serve.cancelled")
        self._deadline_exceeded = registry.counter("serve.deadline_exceeded")
        self._batches = registry.counter("serve.batches")
        self._retries = registry.counter("serve.retries")
        self._quarantines = registry.counter("serve.quarantined")
        self._degraded_runs = registry.counter("serve.degraded_exec")
        self._batch_hist = registry.histogram("serve.batch_size",
                                              buckets=_BATCH_BUCKETS)
        self._latency = registry.histogram("serve.latency_s")
        self._queue_wait = registry.histogram("serve.queue_wait_s")
        self._registry = registry
        self._threads: List[threading.Thread] = []
        self._started = False
        #: requests currently claimed by workers — a non-drain shutdown
        #: cancels their scopes so backoff sleeps and engine checkpoints
        #: end them promptly
        self._inflight: set = set()
        self._inflight_lock = make_lock("server.QueryServer"
                                        "._inflight_lock")
        #: background compaction of a versioned default graph
        #: (serve/compaction.py) — None unless configured AND the graph
        #: is versioned
        self.compactor = None
        if ((self.config.compaction_threshold_rows is not None
             or self.config.compaction_threshold_bytes is not None)
                and getattr(self._default_graph, "graph_is_versioned",
                            False)):
            from caps_tpu_torch.serve.compaction import Compactor
            self.compactor = Compactor(
                self._default_graph, registry,
                threshold_rows=self.config.compaction_threshold_rows,
                threshold_bytes=self.config.compaction_threshold_bytes,
                interval_s=self.config.compaction_interval_s,
                on_failure=self._compaction_failed)
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "QueryServer":
        """Start the worker pool (idempotent).  ``start=False`` at
        construction lets tests and benchmarks pre-load the queue so the
        first batch demonstrably coalesces.  With ``devices=N`` the pool
        is one worker per device replica; otherwise ``workers`` threads
        share replica 0 (one serialized stream)."""
        if self._started:
            return self
        self._started = True
        if self.warmer is not None:
            # inline warmup (background=False) completes BEFORE the
            # worker pool spins up — the first admitted request then
            # finds a fully compiled hot set; background warmup runs
            # concurrently with serving and reports progress in stats()
            self.warmer.start()
        if self.config.devices is not None:
            bindings = list(self.devices.replicas)
        else:
            bindings = [self.devices.replicas[0]] \
                * max(1, self.config.workers)
        # one dispatch stream per shard group, plus its background
        # maintenance loop (probe + rebuild off the serving path)
        bindings.extend(self.shard_groups)
        for group in self.shard_groups:
            group.start_maintenance()
        for i, replica in enumerate(bindings):
            t = threading.Thread(
                target=self._worker_loop, args=(replica,),
                name=f"caps-serve-{i}-dev{replica.index}", daemon=True)
            self._threads.append(t)
            t.start()
        if self.compactor is not None:
            self.compactor.start()
        return self

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> bool:
        """Stop accepting work.  ``drain=True`` (default) completes
        everything already queued before workers exit; ``drain=False``
        fails queued requests with ``Cancelled`` AND cancels in-flight
        ones (their backoff sleeps wake immediately — serve/retry.py).
        ``timeout`` bounds the TOTAL wait for workers; returns False
        (with the worker handles retained, so a later call can finish
        the join) when they are still running at the deadline."""
        self.admission.close()
        if not drain:
            for req in self.admission.drain_remaining():
                req.scope.cancel()
                req.handle._complete(
                    exception=Cancelled(phase="queued"))
                self._cancelled.inc()
            with self._inflight_lock:
                inflight = list(self._inflight)
            for req in inflight:
                req.scope.cancel()
        elif not self._started and self.admission.depth() > 0:
            # never-started server with a backlog: draining means the
            # queued work still completes — spin the workers up; they
            # exit once the (closed) queue is empty
            self.start()
        if not self._started:
            self._release_resources()
            return True
        deadline = None if timeout is None else clock.now() + timeout
        for t in self._threads:
            t.join(None if deadline is None
                   else max(0.0, deadline - clock.now()))
        still_running = [t for t in self._threads if t.is_alive()]
        self._threads = still_running
        if self.compactor is not None:
            self.compactor.stop()
        if not still_running:
            # fully stopped: the windowed gauges must not keep reading
            # (or pinning) this server's telemetry — same contract as
            # the admission depth gauge's deregistration
            self._release_resources()
        return not still_running

    def _release_resources(self) -> None:
        """Full-stop cleanup: the warmer persists its store (before the
        event log closes, so a save failure still events), telemetry
        gauges leave the live set, the event-log file sink closes, and
        the memory ledger drops this server's graph slot (only if a
        newer server has not re-tracked it) so a dead server stops
        inflating ``mem.tracked_graph_bytes``."""
        if self.warmer is not None:
            self.warmer.finalize()
        for group in self.shard_groups:
            group.close()
        listeners = getattr(self.session, "replan_listeners", None)
        if listeners is not None and self._on_replan in listeners:
            listeners.remove(self._on_replan)
        self.telemetry.close()
        self.event_log.close()
        ledger = getattr(self.session, "memory_ledger", None)
        if ledger is not None:
            ledger.untrack_if("default", self._default_graph, owner=self)
        if self.result_cache is not None:
            # detach only OUR cache — a newer server may have attached
            # its own meanwhile (same discipline as untrack_if above)
            if getattr(self.session, "result_cache", None) \
                    is self.result_cache:
                self.session.result_cache = None
            self.result_cache.clear()

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # -- client API ----------------------------------------------------

    def submit(self, query: str,
               parameters: Optional[Mapping[str, Any]] = None, *,
               graph=None, deadline_s: Any = _UNSET,
               priority: Optional[int] = None) -> QueryHandle:
        """Enqueue a query; returns immediately with a handle.

        Raises :class:`ServerClosed` after shutdown began and
        :class:`Overloaded` when admission sheds the request —
        synchronous, so the caller's backpressure is immediate.
        ``deadline_s`` is the request's total budget (queue wait
        included); ``deadline_s=None`` explicitly disables the
        server-default deadline for this request."""
        if deadline_s is _UNSET:
            deadline_s = self.config.default_deadline_s
        if priority is None:
            priority = self.config.default_priority
        graph = graph if graph is not None else self._default_graph
        params = dict(parameters or {})
        scope = CancelScope(budget_s=deadline_s)
        if getattr(graph, "graph_is_versioned", False):
            # snapshot isolation at ADMISSION: a read pins the latest
            # committed snapshot here and finishes on it — coalesced
            # batch members, retries, degraded re-executions, and
            # cross-device failovers all replay against this exact
            # version, whatever writes commit meanwhile.  Writes keep
            # the handle (they serialize on its commit lock and always
            # see the latest state).  Resolve BEFORE keying so the
            # admission path computes the batch key exactly once.
            from caps_tpu_torch.relational.updates import is_update_query
            if not is_update_query(query):
                graph = graph.current()
        # Shard-group graphs never reach the branch above: the group
        # versions its partitions INTERNALLY (serve/shards.py), so
        # writes pass through untouched and commit via the group's own
        # lineage inside ShardGroup.execute.
        group = self.devices.group_for(graph)
        if group is not None:
            # group-level admission: a QUARANTINED group sheds its
            # traffic here with an honest retry hint (the remaining
            # rebuild cooldown) instead of queueing work nobody can
            # serve — replica members keep serving everything else
            retry_after = group.shed_retry_after()
            if retry_after is not None:
                self.telemetry.note_shed()
                raise Overloaded(
                    f"shard group {group.name!r} is quarantined "
                    f"(rebuild pending; retry after {retry_after:.3f}s)",
                    retry_after_s=retry_after,
                    queue_depth=self.admission.depth(), priority=priority)
        mode, plan_key, key = _batcher.request_keys(
            graph, query, params, ragged=self.config.ragged_batching,
            lattice=getattr(self.session, "shape_lattice", None))
        req = Request(query, params, graph, priority, scope, key, mode,
                      plan_key=plan_key)
        if getattr(graph, "snapshot_version", None) is not None:
            req.handle.info["snapshot_version"] = graph.snapshot_version
        if self.result_cache is not None and mode is None \
                and plan_key is not None:
            # result-cache fast path, BEFORE the queue: a hit returns
            # without consuming a worker slot, device dwell, or batch
            # window.  Writes/EXPLAIN/PROFILE (mode set) and
            # unanchorable graphs (plan_key None) never consult it.
            ck = result_cache_key(graph, query, params)
            if ck is not None:
                version = graph_version(graph)
                rows = self.result_cache.lookup(ck, version)
                if rows is not None:
                    self._serve_cache_hit(req, rows)
                    return req.handle
                # miss: completion offers the rows back under this key
                req.cache_key = (ck, version)
        self.admission.offer(req)  # may raise ServerClosed / Overloaded
        return req.handle

    def run(self, query: str,
            parameters: Optional[Mapping[str, Any]] = None,
            **kwargs) -> Any:
        """submit + result(): the blocking convenience call."""
        return self.submit(query, parameters, **kwargs).result()

    def stats(self) -> Dict[str, Any]:
        """The ``serve.*`` slice of the metrics registry, unprefixed,
        plus the failure-containment summary (``health``, per-family
        breaker states), the per-device fault-domain view
        (``devices``: health, request counts, quarantine/reinstate
        transition counters per replica), the windowed telemetry and SLO
        views (``telemetry`` / ``slo``), micro-batch occupancy
        (``batching``), the per-family compile ledger (``compile``),
        byte footprints (``memory``), and the slow-query count
        (``slow_queries``)."""
        snap = self._registry.snapshot()
        out = {k[len("serve."):]: v for k, v in snap.items()
               if k.startswith("serve.")}
        out["health"] = self.health()
        out["breakers"] = self.breaker.summary()
        out["devices"] = self.devices.summary()
        out["shards"] = self.devices.group_summaries()
        out["compaction"] = (self.compactor.summary()
                             if self.compactor is not None else None)
        out["telemetry"] = self.telemetry.summary()
        out["slo"] = self.telemetry.slo_report()
        out["batching"] = self._batching_stats(snap)
        out["compile"] = self._compile_summary()
        out["memory"] = self._memory_report()
        out["warmup"] = (self.warmer.report()
                         if self.warmer is not None else None)
        out["slow_queries"] = (len(self.slow_log.records())
                               if self.slow_log is not None else None)
        return out

    def _compile_summary(self) -> Optional[Dict[str, Any]]:
        ledger = getattr(self.session, "compile_ledger", None)
        return ledger.summary() if ledger is not None else None

    def _memory_report(self) -> Optional[Dict[str, Any]]:
        ledger = getattr(self.session, "memory_ledger", None)
        return ledger.report() if ledger is not None else None

    def _batching_stats(self, snap: Dict[str, Any]) -> Dict[str, Any]:
        """Micro-batch occupancy: cumulative members/batch from the
        ``serve.batch_size`` histogram plus the window-averaged
        occupancy, and the fused executor's batch counters."""
        batches = snap.get("serve.batch_size.count", 0)
        members = snap.get("serve.batch_size.sum", 0.0)
        out = {
            "batches": batches,
            "members": int(members),
            "mean_occupancy": round(members / batches, 4) if batches
            else 0.0,
            "window_occupancy": self.telemetry.batch_occupancy(),
        }
        fused = getattr(self.session, "fused", None)
        if fused is not None:
            out["fused_batches"] = fused.batches
            out["fused_batch_members"] = fused.batch_members
        return out

    def health_report(self) -> Dict[str, Any]:
        """Structured serving health: the one-word :meth:`health` string
        plus the windowed SLO evaluation (error-budget burn rates), the
        telemetry window summary, and the breaker / device / compaction
        detail — everything a capacity dashboard or an alerting rule
        needs in one call."""
        return {
            "status": self.health(),
            "slo": self.telemetry.slo_report(),
            "window": self.telemetry.summary(),
            "breakers": self.breaker.summary(),
            "devices": self.devices.summary(),
            # per-group shard health: member ladder states, rebuild
            # counts, paging gauges (serve/shards.py)
            "shards": self.devices.group_summaries(),
            "compaction": (self.compactor.summary()
                           if self.compactor is not None else None),
            # the resource-accounting sections: per-family
            # compile ledger, byte footprints, and the observed-stats
            # rollup (the item-4 re-plan signal) — visible without
            # scraping the registry
            "compile": self._compile_summary(),
            "memory": self._memory_report(),
            "opstats": self.session.op_stats.summary(),
            # AOT warmup progress/outcome (serve/warmup.py) — the
            # cold-start story next to the compile ledger it spends
            "warmup": (self.warmer.report()
                       if self.warmer is not None else None),
        }

    def warmup_report(self, families: Optional[List[str]] = None
                      ) -> Dict[str, Any]:
        """Warmup coverage: which hot plan families have NEVER compiled
        on this process — what the warmup (serve/warmup.py) warms at
        server start.

        ``families`` defaults to the families the observed-statistics
        store has seen execute (``session.op_stats``); pass an explicit
        list (e.g. the hot families from a previous process's dump) to
        plan a cold start.  A family counts as compiled when the compile
        ledger holds ANY charge for it (cold plan phase included), so on
        a warmed server ``cold_families`` is empty."""
        ledger = getattr(self.session, "compile_ledger", None)
        hot = (list(families) if families is not None
               else self.session.op_stats.families())
        compiled = set(ledger.families()) if ledger is not None else set()
        for group in self.shard_groups:
            # a family that only ever compiled on a shard group (its
            # members' sessions or its cross-shard session) is covered:
            # that is where its traffic executes
            compiled |= group.compiled_families()
        cold = [f for f in hot if f not in compiled]
        return {
            "hot_families": len(hot),
            "compiled_hot_families": len(hot) - len(cold),
            "cold_families": cold,
            "compile_s_by_family": {
                f[:120]: round(ledger.seconds_for(f), 6)
                for f in hot if f in compiled} if ledger is not None
            else {},
        }

    def events(self, event: Optional[str] = None) -> List[Dict[str, Any]]:
        """Snapshot of the structured event log (obs/log.py), optionally
        filtered by event name."""
        return self.event_log.records(event)

    def slow_queries(self) -> List[Dict[str, Any]]:
        """Captured slow-query records (empty when
        ``slow_query_threshold_s`` is unset)."""
        return self.slow_log.records() if self.slow_log is not None else []

    def metrics_text(self) -> str:
        """Prometheus text-exposition of the session registry — the
        windowed ``telemetry.*``/``slo.*`` gauges are registered with
        live callbacks, so the scrape includes them automatically."""
        return self._registry.expose_text()

    def dump_flight_recorder(self, reason: str = "manual"
                             ) -> Dict[str, Any]:
        """On-demand snapshot of the per-request flight ring (plan
        family, device, attempts history, phase timings, outcome per
        record).  Automatic dumps (breaker trip, device quarantine,
        compaction failure) accumulate in
        ``server.telemetry.flight_dumps``."""
        return self.telemetry.dump_flight_recorder(reason)

    def health(self) -> str:
        """One-word serving health: ``healthy`` (all plan families
        closed, all devices serving), ``degraded`` (>= 1 family breaker
        open / half-open OR >= 1 device quarantined / probing — the rest
        keeps serving at reduced capacity), or ``lame-duck`` (shutdown
        began: draining, accepting nothing new).  Per-device detail is
        in :meth:`device_health` / ``stats()["devices"]``."""
        if self.admission.closed:
            return "lame-duck"
        if self.breaker.open_count() or self.devices.quarantined_count():
            return "degraded"
        if any(g.health() != "healthy" for g in self.shard_groups):
            # a degraded group still serves its healthy shards, but
            # capacity planning must see the lost member
            return "degraded"
        if self.compactor is not None and self.compactor.failing:
            # serving still works, but the delta overlay has stopped
            # shrinking — capacity planning must see it
            return "degraded"
        return "healthy"

    def device_health(self) -> Dict[int, str]:
        """Per-device health ladder states:
        ``{device_index: healthy | quarantined | probing}``."""
        return self.devices.health()

    # -- worker pool ---------------------------------------------------

    def _worker_loop(self, replica: DeviceReplica) -> None:
        while True:
            if not self.devices.is_healthy(replica):
                if not self._quarantined_idle(replica):
                    return
                continue
            # blocking take: idle workers sleep on the queue's condition
            # variable (close() wakes them) instead of polling
            batch = self.batcher.next_batch(timeout=None)
            if not batch:
                if self.admission.closed:
                    return
                continue
            try:
                self._execute_batch(batch, replica)
            except BaseException as ex:  # pragma: no cover — last resort
                for req in batch:
                    if not req.handle.done():
                        req.handle._complete(exception=ex)

    def _quarantined_idle(self, replica: DeviceReplica) -> bool:
        """What a worker does while ITS device is quarantined: the other
        workers keep draining the shared queue (capacity degrades to the
        live devices); this one drives the BACKGROUND half-open probe on
        the ladder's cooldown cadence — user requests are never spent as
        probes.  Returns False when the worker should exit (shutdown
        with nothing left this worker could help with)."""
        if self.admission.closed:
            if self.devices.live_count() == 0:
                # nobody can serve the backlog: fail it loudly instead
                # of hanging the drain forever
                for req in self.admission.drain_remaining():
                    self._finish(req, QueryFailed(
                        "shutdown with no healthy devices left to drain "
                        "the queue"))
            if self.admission.depth() == 0:
                return False
        verdict, retry_after = self.devices.try_probe(replica)
        if verdict == TRIAL:
            self.devices.probe(replica)
        else:
            clock.sleep(min(max(retry_after, 1e-3), _PROBE_NAP_S))
        return True

    def _observed(self):
        """Activate the session tracer for worker-side checks (queue
        admission, materialization) so their deadline events land in
        the trace like the engine-side ones do.  Reuses the session's
        own activation helper (one enabled-check contract)."""
        session_observed = getattr(self.session, "_observed", None)
        if session_observed is not None:
            return session_observed()
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def _tracked(self, reqs: List[Request]):
        """In-flight bookkeeping: shutdown(drain=False) cancels these
        scopes so retries and backoff sleeps end promptly."""
        with self._inflight_lock:
            self._inflight.update(reqs)
        try:
            yield
        finally:
            with self._inflight_lock:
                self._inflight.difference_update(reqs)

    def _admit_for_execution(self, batch: List[Request]) -> List[Request]:
        """Drop members that were cancelled or expired while queued and
        complete their handles; record queue wait for the rest."""
        live: List[Request] = []
        now = clock.now()
        for req in batch:
            if req.drop_cancelled():
                self._cancelled.inc()
                continue
            try:
                with self._observed():
                    req.scope.raise_if_done("queued")
            except CancellationError as ex:
                self._count_failure(ex)
                req.handle._complete(exception=ex)
                continue
            wait_s = now - req.enqueued_t
            req.handle.info["queue_wait_s"] = wait_s
            self._queue_wait.observe(wait_s)
            self.telemetry.note_queue_wait(wait_s)
            live.append(req)
        return live

    def _family(self, req: Request):
        """The circuit breaker's key: the EXACT plan-cache key family
        (not the ragged bucket key — a poisoned plan must trip only its
        own family's breaker), or a per-query fallback for requests
        that can never anchor one (EXPLAIN/PROFILE, uncacheable
        graphs)."""
        if req.plan_key is not None:
            return req.plan_key
        return ("solo", req.mode, req.query)

    def _requeue(self, reqs: List[Request]) -> None:
        """Drain claimed-but-unexecuted work back to the dispatcher —
        the quarantine path: another device's worker serves it.  Front
        of the queue, original order preserved."""
        for req in reversed(reqs):
            self.admission.requeue(req)

    def _execute_batch(self, batch: List[Request],
                       replica: DeviceReplica) -> None:
        live = self._admit_for_execution(batch)
        if not live:
            return
        if not self.devices.is_healthy(replica):
            # the device was quarantined between the claim and now (a
            # cross-device retry recorded the tripping failure): hand
            # the whole batch back to the dispatcher
            self._requeue(live)
            return
        # non-replicable graphs (union/catalog) pin to device 0; shard-
        # group graphs redirect to their group whoever claimed them
        replica = self.devices.replica_for(replica, live[0].graph)
        if isinstance(replica, ShardGroup) and \
                not self.devices.is_healthy(replica):
            # the batch's shard GROUP quarantined between admission and
            # the claim: requeue — the in-flight group requests drain
            # back to the dispatcher and complete once the rebuild
            # reinstates it (or expire on their own deadlines); new
            # traffic sheds at submit.  The nap keeps a healthy claimer
            # from hot-spinning on work only the rebuilt member can
            # serve.  Scoped to groups: a batch PINNED to a quarantined
            # device 0 still executes and fails through the retry
            # ladder — the client gets an answer, not an infinite loop.
            self._requeue(live)
            clock.sleep(_PROBE_NAP_S)
            return
        with self._tracked(live):
            self._execute_live(live, replica)

    def _execute_live(self, live: List[Request],
                      replica: DeviceReplica) -> None:
        if len({self._family(r) for r in live}) > 1:
            # ragged bucket batch: members belong to DIFFERENT plan
            # families.  Breaker admission is per member — an open
            # family fast-fails only its own members, a half-open one's
            # member runs alone as that family's probe, and the rest
            # proceed as the shared batch below.
            live = self._admit_ragged(live, replica)
            if not live:
                return
            return self._dispatch_batch(live, replica)
        family = self._family(live[0])
        verdict, retry_after = self.breaker.admit(family)
        if verdict == REJECT:
            # open breaker: fast-fail the whole family without touching
            # the device — a FRESH exception per member (handles must
            # never share one mutable error object)
            for req in live:
                self._finish(req, CircuitOpen(
                    f"plan family circuit breaker is open "
                    f"(retry after {retry_after:.3f}s)",
                    retry_after_s=retry_after))
            return
        if verdict == TRIAL:
            # half-open: exactly ONE probe executes (degraded replan —
            # the cached entry was quarantined when the breaker opened).
            # Its verdict decides the rest of the batch: success closes
            # the breaker and the siblings serve normally below; failure
            # re-opens it and the siblings fast-fail.  A probe that was
            # cancelled / expired decided NOTHING — the next member
            # becomes the probe instead of being failed with a
            # breaker error it never earned.
            healed = False
            while live:
                probe, live = live[0], live[1:]
                probe.handle.info["batch_size"] = 1
                self._batches.inc()
                self._batch_hist.observe(1)
                self.telemetry.note_batch(1)
                outcome = self._execute_single(probe, 1, replica)
                if isinstance(outcome, BaseException):
                    outcome = self._recover(probe, outcome, 1, replica)
                if isinstance(outcome, CancellationError):
                    self.breaker.abort_trial(family)
                    self._finish(probe, outcome)
                    continue
                if isinstance(outcome, BaseException):
                    self.breaker.record_failure(family, outcome)
                    self._finish(probe, outcome)
                    for req in live:
                        self._finish(req, CircuitOpen(
                            f"plan family circuit breaker re-opened by a "
                            f"failed half-open trial (retry after "
                            f"{self.breaker.cooldown_s:.3f}s)",
                            retry_after_s=self.breaker.cooldown_s))
                    # the probe (and its fast-failed siblings) are in the
                    # ring by now: the dump carries their attempt history
                    self.telemetry.auto_dump("breaker_trip")
                    self.event_log.emit(
                        "breaker.trip", request_id=probe.request_id,
                        family=self._family_label(probe),
                        trigger="failed_half_open_trial")
                    return
                self.breaker.record_success(family)
                self._finish(probe, outcome)
                healed = True
                break
            if not live or not healed:
                return
        self._dispatch_batch(live, replica)

    def _admit_ragged(self, live: List[Request],
                      replica: DeviceReplica) -> List[Request]:
        """Per-member breaker admission for a mixed-family (ragged
        bucket) batch: open families fast-fail their members, a
        half-open family's first member executes ALONE as its probe
        (success closes the breaker, failure re-opens it — exactly the
        single-family trial semantics, scoped to one member), everyone
        else is returned for the shared dispatch."""
        kept: List[Request] = []
        for req in live:
            family = self._family(req)
            verdict, retry_after = self.breaker.admit(family)
            if verdict == REJECT:
                self._finish(req, CircuitOpen(
                    f"plan family circuit breaker is open "
                    f"(retry after {retry_after:.3f}s)",
                    retry_after_s=retry_after))
                continue
            if verdict == TRIAL:
                req.handle.info["batch_size"] = 1
                self._batches.inc()
                self._batch_hist.observe(1)
                self.telemetry.note_batch(1)
                outcome = self._execute_single(req, 1, replica)
                if isinstance(outcome, BaseException):
                    outcome = self._recover(req, outcome, 1, replica)
                if isinstance(outcome, CancellationError):
                    self.breaker.abort_trial(family)
                elif isinstance(outcome, BaseException):
                    self.breaker.record_failure(family, outcome)
                    self._finish(req, outcome)
                    self.telemetry.auto_dump("breaker_trip")
                    self.event_log.emit(
                        "breaker.trip", request_id=req.request_id,
                        family=self._family_label(req),
                        trigger="failed_half_open_trial")
                    continue
                else:
                    self.breaker.record_success(family)
                self._finish(req, outcome)
                continue
            kept.append(req)
        return kept

    def _dispatch_batch(self, live: List[Request],
                        replica: DeviceReplica) -> None:
        """One shared device dispatch of breaker-admitted requests, with
        per-member outcome bookkeeping (breaker records land on each
        member's OWN plan family — a ragged batch mixes several)."""
        n = len(live)
        self._batches.inc()
        self._batch_hist.observe(n)
        self.telemetry.note_batch(n)
        for req in live:
            req.handle.info["batch_size"] = n
            req.handle.info["device"] = replica.index
        with replica.lock:
            # service time starts INSIDE the lock: time spent queued
            # behind another batch on this device's stream is queueing,
            # not service, and must not inflate the retry_after estimator
            t0 = clock.now()
            if n > 1:
                try:
                    with replica.activate():
                        graph = replica.graph_for(live[0].graph)
                        outcomes = replica.session.cypher_batch(
                            graph, [(r.query, r.params) for r in live],
                            scopes=[r.scope for r in live])
                except BaseException as ex:  # replication / setup failed
                    outcomes = [ex] + [_fresh_copy(ex)
                                       for _ in live[1:]]
            else:
                req = live[0]
                try:
                    with cancel_scope(req.scope), replica.activate():
                        graph = replica.graph_for(req.graph)
                        outcomes = [replica.session.cypher_on_graph(
                            graph, req.query, req.params)]
                except BaseException as ex:
                    outcomes = [ex]
            exec_s = clock.now() - t0
        # feed the admission controller's retry_after estimator and the
        # telemetry window (service-time + per-device utilization)
        self.admission.observe_service(exec_s / n)
        self.telemetry.note_service(exec_s / n)
        self.telemetry.note_device_busy(replica.index, exec_s)
        # per-device fault-domain bookkeeping on the RAW outcomes: the
        # device that produced a failure owns it, whatever device the
        # recovery below lands on
        for outcome in outcomes:
            if isinstance(outcome, BaseException):
                attribute_device(outcome, replica.index)
        self._note_device_outcomes(replica, outcomes)
        # successful members complete FIRST: a failed sibling's recovery
        # (backoff sleeps + serialized re-executions) must not sit
        # between a finished result and the client waiting on it
        pending = []
        for req, outcome in zip(live, outcomes):
            if isinstance(outcome, BaseException):
                pending.append((req, outcome))
            else:
                self.breaker.record_success(self._family(req))
                self._finish(req, outcome)
        for req, exc in pending:
            outcome = self._recover(req, exc, 0, replica)
            # breaker bookkeeping on the request's FINAL outcome — onto
            # the member's OWN plan family; cancellation/deadline expiry
            # is the budget's verdict, not the family's
            tripped = False
            if isinstance(outcome, BaseException):
                if not isinstance(outcome, CancellationError):
                    tripped = self.breaker.record_failure(
                        self._family(req), outcome)
                    if tripped and not req.handle.info.get("quarantined"):
                        # this failure tripped the family open: evict its
                        # shared cached state so the half-open trial (and
                        # the eventual recovery) re-plans from scratch —
                        # unless the recovery ladder already did
                        self._quarantine(req, replica)
            else:
                self.breaker.record_success(self._family(req))
            self._finish(req, outcome)
            if tripped:
                # AFTER the finish: the tripping request is in the
                # flight ring, so the dump carries its attempt history
                self.telemetry.auto_dump("breaker_trip")
                self.event_log.emit(
                    "breaker.trip", request_id=req.request_id,
                    family=self._family_label(req),
                    trigger="failure_threshold")

    def _note_device_outcomes(self, replica: DeviceReplica,
                              outcomes: List[Any]) -> None:
        """Feed one batch of raw outcomes to the device health ladder.
        Cancellation/deadline expiry is the budget's verdict — it says
        nothing about the device."""
        for outcome in outcomes:
            replica.note(requests=1)
            if isinstance(outcome, CancellationError):
                continue
            if isinstance(outcome, BaseException):
                tripped = self.devices.record_failure(replica, outcome)
                if tripped and isinstance(replica, ShardGroup):
                    # a member (or the whole group) tripped its ladder:
                    # black-box it — the group keeps serving healthy
                    # shards while the background rebuild runs
                    from caps_tpu_torch.serve.shards import member_of
                    self.telemetry.auto_dump(f"shard_{tripped}_quarantine")
                    self.event_log.emit(
                        "shard.quarantine", request_id=None, family=None,
                        group=replica.name, level=tripped,
                        member=member_of(outcome),
                        error=type(outcome).__name__)
                elif tripped:
                    # this failure quarantined the device: black-box the
                    # in-flight picture for the postmortem
                    self.telemetry.auto_dump("device_quarantine")
                    self.event_log.emit(
                        "device.quarantine", request_id=None, family=None,
                        device=replica.index,
                        error=type(outcome).__name__)
            else:
                self.devices.record_success(replica)

    # -- failure containment (retry / quarantine / degraded ladder) ----

    def _recover(self, req: Request, exc: BaseException, level: int,
                 replica: DeviceReplica) -> Any:
        """Containment ladder for ONE failed request: classify the
        error, then either return it (fatal / cancelled), retry with
        deadline-charged backoff on a DIFFERENT healthy device
        (transient — the failed device may be the problem; a lone
        device retries on itself), or quarantine the cached plan and
        climb the degraded ladder on the same device (poisoned).
        Returns the final outcome — a CypherResult or the exception to
        complete the handle with.  Never raises."""
        policy = self.retry_policy
        attempts = [self._attempt_entry(exc, level, replica)]
        executions = 1
        #: every device index that failed during THIS recovery, in
        #: order: with several members unhealthy mid-window a later
        #: retry must exclude ALL of them, not just the latest
        #: (ReplicaSet.retry_target takes the whole collection)
        failed_devices = [replica.index]
        current: BaseException = exc
        while True:
            if isinstance(current, CancellationError):
                break  # the budget's verdict stands
            kind = attempts[-1]["classified"]
            if kind == FATAL:
                break
            if kind == TRANSIENT:
                if executions >= policy.max_attempts:
                    current = QueryFailed(
                        f"still failing transiently after {executions} "
                        f"attempts: {type(current).__name__}: {current}",
                        attempts=tuple(attempts),
                        retry_after_s=policy.backoff_s(executions,
                                                       req.request_id))
                    break
                backoff = policy.backoff_s(executions, req.request_id)
                if not policy.budget_allows(req.scope.remaining(), backoff):
                    # a retry never fires when the remaining deadline
                    # budget cannot cover the next backoff: give up NOW
                    # with the backoff as the client's retry hint
                    current = QueryFailed(
                        f"transient failure, but remaining deadline "
                        f"budget < next backoff ({backoff:.3f}s): "
                        f"{type(current).__name__}: {current}",
                        attempts=tuple(attempts), retry_after_s=backoff)
                    break
                attempts[-1]["backoff_s"] = backoff
                self._retries.inc()
                self.telemetry.note_retry()
                tracer = self.session.tracer
                if tracer.enabled:
                    tracer.event("retry.attempt", attempt=executions,
                                 backoff_s=backoff, mode=_LADDER[level],
                                 device=replica.index,
                                 error=type(current).__name__)
                policy.sleep(backoff, scope=req.scope)
                if req.scope.cancelled:
                    # cancel() fired DURING the backoff: the wait woke
                    # immediately (serve/retry.py) and the request ends
                    # here — no doomed re-execution, no burned sleep
                    current = Cancelled(phase="backoff")
                    break
                # device failover: re-execute on a different healthy
                # device when one exists — routed through replica_for,
                # so non-replicable graphs keep retrying on device 0
                # and shard-group graphs come back to their group
                replica = self.devices.replica_for(
                    self.devices.retry_target(
                        exclude_index=failed_devices), req.graph)
            else:  # POISONED_PLAN: quarantine once, then climb the ladder
                if level >= len(_LADDER) - 1:
                    current = QueryFailed(
                        f"degraded ladder exhausted after {executions} "
                        f"attempts: {type(current).__name__}: {current}",
                        attempts=tuple(attempts))
                    break
                if level == 0:
                    self._quarantine(req, replica)
                level += 1
                self._degraded_runs.inc()
            executions += 1
            outcome = self._execute_single(req, level, replica)
            if not isinstance(outcome, BaseException):
                attempts.append({"mode": _LADDER[level], "ok": True,
                                 "device": replica.index})
                req.handle.info["attempts"] = attempts
                return outcome
            attempts.append(self._attempt_entry(outcome, level, replica))
            if replica.index not in failed_devices:
                failed_devices.append(replica.index)
            current = outcome
        req.handle.info["attempts"] = attempts
        return current

    @staticmethod
    def _attempt_entry(exc: BaseException, level: int,
                       replica: DeviceReplica) -> Dict[str, Any]:
        """One attempt-history record.  A fresh dict per attempt per
        request — failure context lives HERE, never as mutations of the
        exception object (which a badly-behaved injector might share
        across batch members)."""
        dev = device_of(exc)
        entry = {"mode": _LADDER[level], "error": type(exc).__name__,
                 "message": str(exc)[:200], "classified": classify(exc),
                 "device": replica.index if dev is None else dev}
        failed_op = getattr(exc, "caps_failed_op", None)
        if failed_op is not None:
            entry["op"] = failed_op
        return entry

    def _execute_single(self, req: Request, level: int,
                        replica: DeviceReplica) -> Any:
        """One (re-)execution of a single request at a ladder level on
        ``replica``'s device.  Returns the result or the raised
        exception; device-ladder bookkeeping included."""
        with replica.lock:
            t0 = clock.now()
            try:
                with cancel_scope(req.scope), replica.activate():
                    graph = replica.graph_for(req.graph)
                    if level == 0:
                        out: Any = replica.session.cypher_on_graph(
                            graph, req.query, req.params)
                    else:
                        out = replica.session.cypher_degraded(
                            graph, req.query, req.params,
                            no_plan_cache=True, no_fused=(level >= 2))
            except BaseException as ex:
                attribute_device(ex, replica.index)
                out = ex
            finally:
                exec_s = clock.now() - t0
        self.admission.observe_service(exec_s)
        self.telemetry.note_service(exec_s)
        self.telemetry.note_device_busy(replica.index, exec_s)
        self._note_device_outcomes(replica, [out])
        return out

    def _quarantine(self, req: Request, replica: DeviceReplica) -> None:
        """Evict the request family's shared cached state ON THE REPLICA
        THAT SERVED IT: that session's plan-cache entry
        (relational/plan_cache.py) and its fused size memos
        (backends/cuda/fused.py) — a poisoned entry must not
        keep failing every future hit, and per-device caches mean the
        eviction never touches another device's compiled state.
        Stamped on the handle so one request quarantines at most once
        (the ladder and a breaker trip must not double-count)."""
        req.handle.info["quarantined"] = True
        self._quarantines.inc()
        if self.result_cache is not None and req.plan_key is not None:
            # a quarantined family may have produced poisoned rows — its
            # cached results (and every shared memoized intermediate)
            # must go with the plan (relational/result_cache.py)
            self.result_cache.evict_family(req.plan_key[1])
        if isinstance(replica, ShardGroup):
            # group-routed: evict on the session that actually served
            # this family (owning member or the cross-shard session)
            replica.quarantine_family(req.query, req.params)
            self.event_log.emit(
                "plan.quarantine", request_id=req.request_id,
                family=self._family_label(req), device=replica.index)
            return
        session = replica.session
        try:
            graph = replica.graph_for(req.graph)
        except Exception:  # pragma: no cover — containment must not fail
            return
        # the shared eviction sequence (serve/failure.py): plan-cache
        # quarantine + fused memo drop under the replica's exec lock
        quarantine_plan_state(session, graph, req.query, req.params,
                              exec_lock=replica.lock)
        tracer = session.tracer
        if tracer.enabled:
            tracer.event("plan.quarantined", query=req.query,
                         device=replica.index)
        self.event_log.emit(
            "plan.quarantine", request_id=req.request_id,
            family=self._family_label(req), device=replica.index)

    def _finish(self, req: Request, outcome: Any) -> None:
        """Materialize (deadline-checked) and complete one handle."""
        if isinstance(outcome, BaseException):
            self._count_failure(outcome)
            self._flight(req, outcome)
            req.handle._complete(exception=outcome)
            return
        rows = None
        try:
            with cancel_scope(req.scope), self._observed():
                if self.config.materialize:
                    req.scope.raise_if_done("materialize")
                    rows = outcome.to_maps()
                    req.scope.raise_if_done("materialize")
        except BaseException as ex:
            self._count_failure(ex)
            self._flight(req, ex)
            req.handle._complete(exception=ex)
            return
        self._note_ledger(req, outcome)
        self._store_result(req, rows)
        req.handle.info["latency_s"] = req.scope.elapsed()
        self._latency.observe(req.handle.info["latency_s"])
        self._completed.inc()
        self._flight(req, None, outcome)
        req.handle._complete(result=outcome, rows=rows)

    def _serve_cache_hit(self, req: Request, rows: list) -> None:
        """Complete a request AT ADMISSION from the result cache: no
        worker slot, no device dwell, no batch window.  The flight
        record stamps ``outcome="cache_hit"`` / ``phase="cache"`` so the
        black box distinguishes memory-served reads from device-served
        ones, and windowed telemetry counts the hit as an ok result
        (hits ARE served traffic — qps/availability must see them)."""
        info = req.handle.info
        try:
            # a zero/negative deadline budget expires even here
            req.scope.raise_if_done("cache")
        except CancellationError as ex:
            self._count_failure(ex)
            self._flight(req, ex)
            req.handle._complete(exception=ex)
            return
        info["cache"] = "hit"
        info["queue_wait_s"] = 0.0
        info["ledger"] = {"bytes_in": 0, "bytes_out": 0,
                          "compile_s": 0.0, "peak_rows": len(rows)}
        latency_s = req.scope.elapsed()
        info["latency_s"] = latency_s
        self._latency.observe(latency_s)
        self._completed.inc()
        family = self._family_label(req)
        self.telemetry.note_result(family, latency_s, "ok")
        rec: Dict[str, Any] = {
            "request_id": req.request_id,
            "family": family,
            "priority": req.priority,
            "device": None,
            "batch_size": None,
            "queue_wait_s": 0.0,
            "latency_s": round(latency_s, 6),
            "phase": "cache",
            "outcome": "cache_hit",
            "ledger": info["ledger"],
        }
        if info.get("snapshot_version") is not None:
            rec["snapshot_version"] = info["snapshot_version"]
        self.telemetry.recorder.record(rec)
        req.handle._complete(result=CachedRows(rows), rows=rows)

    def _observed_service_s(self, req: Request) -> float:
        """Observed per-execution seconds for this request's plan family
        (session.op_stats) — the admission benefit estimate.  Falls back
        to the request's own measured latency when the family has no
        folded statistics yet."""
        try:
            stats = self.session.op_stats.stats(self._family_label(req))
            total = execs = 0.0
            for entry in stats.values():
                total += float(entry.get("wall_s_total") or 0.0)
                execs = max(execs, float(entry.get("executions") or 0))
            if execs > 0 and total > 0:
                return total / execs
        except Exception:  # pragma: no cover — estimation must not fail
            pass
        return max(0.0, req.scope.elapsed())

    def _store_result(self, req: Request, rows: Optional[list]) -> None:
        """Completion-side feed: offer the materialized rows back to the
        result cache under the key stamped at admission (cost-aware —
        the cache decides)."""
        if self.result_cache is None or req.cache_key is None \
                or rows is None:
            return
        key, version = req.cache_key
        ledger = req.handle.info.get("ledger") or {}
        nbytes = int(ledger.get("bytes_out") or 0)
        self.result_cache.offer(key, version, rows, nbytes=nbytes,
                                service_s=self._observed_service_s(req))

    def _note_ledger(self, req: Request, result: Any) -> None:
        """The per-request resource ledger: bytes pulled
        through memory, result bytes out, compile seconds charged to
        this execution (obs/compile.py via the session's per-query
        stamp), and peak operator cardinality — stamped on the handle
        and carried by the flight-recorder and slow-query records.
        Compile charges also land in the telemetry window and the
        structured event log."""
        m = getattr(result, "metrics", None) or {}
        compile_s = float(m.get("compile_s_charged") or 0.0)
        peak = 0
        for entry in m.get("operators") or ():
            r = entry.get("rows") or 0
            if r > peak:
                peak = r
        if not peak:
            peak = int(m.get("rows") or 0)
        bytes_out = 0
        records = getattr(result, "records", None)
        if records is not None:
            try:
                bytes_out = int(records.table.nbytes)
            except Exception:  # pragma: no cover — accounting only
                bytes_out = 0
        req.handle.info["ledger"] = {
            "bytes_in": int(m.get("bytes_touched") or 0),
            "bytes_out": bytes_out,
            "compile_s": round(compile_s, 9),
            "peak_rows": int(peak),
        }
        if compile_s > 0.0:
            self.telemetry.note_compile(compile_s)
            self.event_log.emit(
                "compile.charged", request_id=req.request_id,
                family=self._family_label(req),
                seconds=round(compile_s, 6),
                snapshot_version=req.handle.info.get("snapshot_version"))

    def _on_replan(self, event: str, info: Dict[str, Any]) -> None:
        """Session re-plan transition → structured event (no request to
        correlate: the trigger is an aggregate over executions, not one
        request).  ``replan.triggered`` carries the quarantined-plan
        count; ``replan.completed`` the re-plan seconds and the new
        plan's calibrated root estimate."""
        fields = {k: v for k, v in info.items() if k != "family"}
        self.event_log.emit(event, request_id=None,
                            family=str(info.get("family"))[:120],
                            **fields)

    def _compaction_failed(self, ex: BaseException) -> None:
        """Compaction-failure incident hook (serve/compaction.py): flight
        dump plus a structured event (no request to correlate — the
        fields are explicit Nones, never absent)."""
        self.telemetry.auto_dump("compaction_failure")
        self.event_log.emit(
            "compaction.failure", request_id=None, family=None,
            error=f"{type(ex).__name__}: {str(ex)[:200]}")

    def _family_label(self, req: Request) -> str:
        """Human-meaningful plan-family label for telemetry and the
        flight recorder: the normalized query text for batchable
        requests (the batch key's middle element), else mode + raw
        text."""
        if req.plan_key is not None:
            return str(req.plan_key[1])[:120]
        return f"{req.mode or 'solo'}:{req.query[:100]}"

    def _flight(self, req: Request, exc: Optional[BaseException],
                result: Any = None) -> None:
        """One finished request's black-box record + windowed outcome
        note.  Cancellation AND deadline expiry count as aborts
        (excluded from availability — the budget's verdict, not the
        server's, same exemption the breaker and device ladder apply);
        every other failure counts against availability.  Every record
        carries the request's resource ledger; over-threshold requests
        additionally capture plan text + per-op stats in the slow-query
        log (same record shape, so dumps and slow entries merge)."""
        info = req.handle.info
        latency_s = req.scope.elapsed()
        family = self._family_label(req)
        if exc is None:
            kind = "ok"
        elif isinstance(exc, CancellationError):
            kind = "abort"
        else:
            kind = "error"
        self.telemetry.note_result(family, latency_s, kind)
        rec: Dict[str, Any] = {
            "request_id": req.request_id,
            "family": family,
            "priority": req.priority,
            "device": info.get("device"),
            "batch_size": info.get("batch_size"),
            "queue_wait_s": info.get("queue_wait_s"),
            "latency_s": round(latency_s, 6),
            "phase": req.scope.phase,
            "outcome": "ok" if exc is None else type(exc).__name__,
            "ledger": info.get("ledger", {"bytes_in": 0, "bytes_out": 0,
                                          "compile_s": 0.0,
                                          "peak_rows": 0}),
        }
        if info.get("snapshot_version") is not None:
            rec["snapshot_version"] = info["snapshot_version"]
        if exc is not None:
            rec["error"] = str(exc)[:200]
        if info.get("attempts"):
            rec["attempts"] = info["attempts"]
        if info.get("quarantined"):
            rec["quarantined"] = True
        self.telemetry.recorder.record(rec)
        if self.slow_log is not None:
            plan = operators = None
            if result is not None:
                plans = getattr(result, "plans", None) or {}
                plan = plans.get("relational") or plans.get("ir")
                m = getattr(result, "metrics", None) or {}
                operators = [dict(e)
                             for e in (m.get("operators") or ())][:64]
            self.slow_log.consider(rec, plan=plan, operators=operators)

    def _count_failure(self, ex: BaseException) -> None:
        if isinstance(ex, DeadlineExceeded):
            self._deadline_exceeded.inc()
        elif isinstance(ex, Cancelled):
            self._cancelled.inc()
        else:
            self._failed.inc()
