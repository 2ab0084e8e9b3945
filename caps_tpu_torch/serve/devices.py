"""Device fault domains: the replica set behind :class:`QueryServer`.

The counterpart of ``caps_tpu/serve/devices.py``: the failure taxonomy
(serve/failure.py) treats a dead device as a quarantined worker, not a
dead server, and this module makes that concrete:

* :class:`DeviceReplica` — one device's worth of serving state: its own
  engine session (per-device plan cache, string pool, fused size memos —
  compiled/cached state NEVER crosses devices), its own replicated copy
  of each served graph (ingest once per device), its own execution lock
  (one dispatch stream per device), and per-device request counters.
* :class:`ReplicaSet` — placement and the per-device health ladder
  ``healthy -> quarantined -> probing -> healthy``, driven by the same
  three-state breaker machine the plan families use
  (:class:`~caps_tpu_torch.serve.breaker.CircuitBreaker` with a
  ``serve.device_breaker`` metric prefix): ``device_failure_threshold``
  consecutive device-attributed failures quarantine the device; after
  ``device_cooldown_s`` a BACKGROUND canary probe (never a user request)
  runs half-open; its success reinstates the device, its failure buys
  another cooldown.
* :func:`replicate_graph` — a copy of a ScanGraph in another session:
  between sessions whose string pools agree it copies the device
  tensors and the pool (no host round trip); otherwise the columns are
  read back to host values and rebuilt through the target session's
  table factory.  Either way each replica owns device-resident buffers
  placed by ITS backend.
* :func:`executing_device_index` — a thread-local stamp of which replica
  the calling thread is executing on.  The fault-injection harness
  (``testing/faults.py`` ``device_loss`` / ``sick_device``) scopes
  injected device faults to one replica's operator stream through it.

Each replica runs on its session's device.  A replica of a card
session is a session on a card — one per card when the process sees as
many cards as replicas, else every replica is a clone on the session's
own card — and :meth:`DeviceReplica.activate` enters
``torch.cuda.device`` and the replica's own ``torch.cuda.Stream``, so
each replica dispatches on a stream of its own (the kernels launch on
the current stream).  A CPU session's replicas are CPU clones: distinct
sessions with distinct cached state, which is everything the failover
logic observes, so the quarantine/probe/reinstate path is testable with
no card.  A replica of a card session is never placed on the CPU.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from caps_tpu_torch.obs.lockgraph import make_lock
from caps_tpu_torch.serve.breaker import (CLOSED, HALF_OPEN, OPEN,
                                          CircuitBreaker)
from caps_tpu_torch.serve.deadline import cancel_scope
from caps_tpu_torch.serve.errors import ReplicationUnsupported

#: per-device health ladder states (the rollup QueryServer.stats() shows)
HEALTHY = "healthy"
QUARANTINED = "quarantined"
PROBING = "probing"

_BREAKER_TO_HEALTH = {CLOSED: HEALTHY, OPEN: QUARANTINED,
                      HALF_OPEN: PROBING}

#: background-probe canary: must run a real operator stream on the
#: replica (a plain node scan — no count pushdown, no aggregation), so a
#: device fault scoped to this replica fails the probe too
_CANARY_QUERY = "MATCH (n) RETURN n LIMIT 1"

#: replicated graphs kept per device (LRU): each entry is a full
#: re-ingested copy holding device buffers, so the cache must not grow
#: with every short-lived graph a long-lived server ever saw
MAX_REPLICA_GRAPHS = 8

_exec_tls = threading.local()

_session_locks_guard = make_lock("devices._session_locks_guard")


def executing_device_index() -> Optional[int]:
    """The replica index the calling thread is currently executing on
    (None outside a replica's execution bracket).  The device-scoped
    fault injectors key off this."""
    return getattr(_exec_tls, "device_index", None)


# chrome-trace device lanes: spans opened inside a replica's execution
# bracket carry the device index, and obs/export.py renders it as the
# trace event's pid — multi-replica traces lay out as parallel lanes.
# The provider hook lives in obs/tracer.py (obs/ never imports serve/).
from caps_tpu_torch.obs import tracer as _tracer_mod  # noqa: E402

_tracer_mod.set_device_index_provider(executing_device_index)


def _session_exec_lock(session) -> threading.Lock:
    """The ONE execution lock of a session, attached on first use: every
    server/replica over the same session must serialize through the same
    lock (the engine's execution state — fused record/replay activation,
    profiling flags — is per-session)."""
    lock = getattr(session, "_serve_exec_lock", None)
    if lock is None:
        with _session_locks_guard:
            lock = getattr(session, "_serve_exec_lock", None)
            if lock is None:
                lock = make_lock("devices.DeviceReplica.lock")
                session._serve_exec_lock = lock
    return lock


# -- graph replication -------------------------------------------------------

def _clone_table(factory, table):
    data = {c: table.column_values(c) for c in table.columns}
    types = {c: table.column_type(c) for c in table.columns}
    return factory.from_columns(data, types)


def _adopt_pool(src, dst) -> bool:
    """Make ``dst``'s string pool hold ``src``'s codes: True when the
    pools already agree on ``dst``'s strings (``dst`` is then extended
    with the rest of ``src``), so a string column's codes copy across
    as they are.  False when they disagree (the caller re-ingests)."""
    n = len(dst)
    if len(src) < n or src._strings[:n] != dst._strings:
        return False
    for s in src._strings[n:]:
        dst.encode(s)
    return True


def _copy_device_table(backend, table):
    """``table``'s columns cloned onto ``backend``'s device (on the
    current stream), each through its placement seam (row-resident on
    the replica's mesh where its rows divide; a row-resident source
    gathers first); the ingest-time host mirrors are shared (immutable
    numpy arrays), so the target builds its CSR from them as an ingest
    does."""
    from caps_tpu_torch.backends.cuda.sharded import assemble, whole
    table = whole(table)
    cols = {c: backend.place_column(col.to_device(backend.device))
            for c, col in table._cols.items()}
    return assemble(backend, cols, table._n)


def supports_replication(graph) -> bool:
    """True when :func:`replicate_graph` can re-ingest this graph: scan
    graphs, the empty ambient graph, and versioned SNAPSHOTS over a scan
    base (the base re-ingests once per device; the snapshot's host-level
    delta overlay rebuilds cheaply on the replica — see
    ``DeviceReplica.graph_for``).  Requests against anything else
    (union/catalog graphs, and WRITES — which target the mutable
    versioned handle) are pinned to device 0, which serves them on the
    original session."""
    from caps_tpu_torch.relational.graphs import EmptyGraph, ScanGraph
    from caps_tpu_torch.relational.updates import GraphSnapshot
    if isinstance(graph, GraphSnapshot):
        return isinstance(graph.base, ScanGraph)
    return graph is None or isinstance(graph, (EmptyGraph, ScanGraph))


def replicate_graph(graph, session):
    """A copy of ``graph`` in ``session``, sharing nothing compiled or
    placed with the source: the replica ends up with ITS OWN
    device-resident buffers, string-pool codes, and CSR layout.

    Between device sessions whose string pools agree (a fresh clone's
    empty pool always does) the device tensors are cloned and the pool
    extended — at 10M rows a host round trip of every value would take
    minutes.  Otherwise every entity table's columns are read back to
    host values and rebuilt through the target session's factory, as
    the reference does."""
    from caps_tpu_torch.relational.entity_tables import (NodeTable,
                                                   RelationshipTable)
    from caps_tpu_torch.relational.graphs import EmptyGraph, ScanGraph
    if graph is None or isinstance(graph, EmptyGraph):
        return session._ambient
    if not isinstance(graph, ScanGraph):
        raise ReplicationUnsupported(
            f"cannot replicate a {type(graph).__name__} onto another "
            f"device (only scan graphs re-ingest); requests against it "
            f"serve on device 0")
    src_backend = getattr(graph.session, "backend", None)
    dst_backend = getattr(session, "backend", None)
    tables = tuple(graph.node_tables) + tuple(graph.rel_tables)
    if (src_backend is not None and dst_backend is not None
            and all(getattr(et.table, "_live", 0) is None for et in tables)
            and _adopt_pool(src_backend.pool, dst_backend.pool)):
        def copy(table):
            return _copy_device_table(dst_backend, table)
    else:
        factory = session.table_factory

        def copy(table):
            return _clone_table(factory, table)
    node_tables = [NodeTable(nt.mapping, copy(nt.table))
                   for nt in graph.node_tables]
    rel_tables = [RelationshipTable(rt.mapping, copy(rt.table))
                  for rt in graph.rel_tables]
    return session.create_graph(node_tables, rel_tables)


def _acquire_devices(n: int, session) -> List[torch.device]:
    """The device of each of ``n`` replicas of ``session``: one card
    each when the process sees at least ``n`` cards (replica 0 keeps the
    session's own), else the session's own device for all of them — a
    CPU session's replicas are CPU sessions, a card session's replicas
    share its card, each on a stream of its own."""
    own = torch.device(getattr(session, "device", "cpu"))
    if own.type != "cuda":
        return [own] * n
    own = torch.device("cuda", own.index if own.index is not None
                       else torch.cuda.current_device())
    count = torch.cuda.device_count()
    if count >= n:
        others = [torch.device("cuda", i) for i in range(count)
                  if i != own.index]
        return [own] + others[:n - 1]
    return [own] * n


class DeviceReplica:
    """One device's serving state: session, graphs, lock, counters."""

    def __init__(self, index: int, session, device: Any = None):
        self.index = index
        self.session = session
        #: the session's device (a card, or the CPU)
        self.device = torch.device(device if device is not None
                                   else getattr(session, "device", "cpu"))
        #: the replica's own dispatch stream on a card (None on the CPU)
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)
        #: one dispatch stream per device: every execution on this
        #: replica (including cross-device retries and probes) holds it
        self.lock = _session_exec_lock(session)
        self._stats_lock = make_lock("devices.DeviceReplica._stats_lock")
        self.requests = 0
        self.completed = 0
        self.failed = 0
        self.quarantines = 0
        self.reinstates = 0
        self.probes = 0
        #: id(template graph) -> (template graph, replica graph); LRU
        #: bounded — insertion-ordered dict, oldest evicted past the cap
        #: so a long-lived server cycling through many short-lived
        #: graphs cannot pin dead graphs' device buffers forever
        self._graphs: Dict[int, Tuple[Any, Any]] = {}
        self._graphs_lock = make_lock("devices.DeviceReplica._graphs_lock")

    @contextlib.contextmanager
    def activate(self):
        """Execution bracket: stamps the executing-device thread-local
        (the device-scoped fault injectors key off it) and, on a card,
        makes the replica's card and stream current for this thread, so
        every tensor this execution creates and every kernel it launches
        lands on THIS replica's stream (PyTorch's current device and
        stream are per thread).  On entry the stream waits for the
        card's default stream (the graph was ingested there); on exit
        the default stream waits for the replica's, so work queued later
        on the default stream (another thread's read, a reuse of freed
        memory) is ordered after this bracket's.  Neither wait blocks
        the host.  On the CPU it enters nothing."""
        prev = getattr(_exec_tls, "device_index", None)
        _exec_tls.device_index = self.index
        try:
            if self.stream is None:
                yield
            else:
                default = torch.cuda.default_stream(self.device)
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self.stream):
                    self.stream.wait_stream(default)
                    try:
                        yield
                    finally:
                        default.wait_stream(self.stream)
        finally:
            _exec_tls.device_index = prev

    def graph_for(self, graph):
        """This replica's copy of ``graph``, re-ingested on first use
        (and eagerly at server construction for the default graph).
        Replica 0 serves the ORIGINAL objects — it owns the template
        session, so its 'copy' is the graph itself.

        Versioned snapshots (relational/updates.py) replicate in two
        parts: the immutable BASE re-ingests once per device (cached by
        identity, shared by every snapshot of the lineage), and the
        snapshot's host-level delta overlay rebuilds through this
        replica's factory — a cross-device retry of a pinned read
        therefore executes the SAME snapshot version on different
        hardware."""
        if self.index == 0 or graph is None:
            return graph if graph is not None else self.session._ambient
        from caps_tpu_torch.relational.updates import GraphSnapshot
        if isinstance(graph, GraphSnapshot):
            # resolve the base copy FIRST (recursive call takes the
            # lock; holding it here would deadlock)
            base_copy = self.graph_for(graph.base)
            key = id(graph)
            with self._graphs_lock:
                got = self._graphs.get(key)
                if got is not None and got[0] is graph:
                    self._graphs[key] = self._graphs.pop(key)
                    return got[1]
                with self.activate():
                    replica_graph = graph.rebase(self.session, base_copy)
                self._graphs[key] = (graph, replica_graph)
                while len(self._graphs) > MAX_REPLICA_GRAPHS:
                    self._graphs.pop(next(iter(self._graphs)))
                return replica_graph
        key = id(graph)
        with self._graphs_lock:
            got = self._graphs.get(key)
            if got is not None and got[0] is graph:
                # LRU touch: re-insert at the newest position
                self._graphs[key] = self._graphs.pop(key)
                return got[1]
            with self.activate():
                replica_graph = replicate_graph(graph, self.session)
            self._graphs[key] = (graph, replica_graph)
            while len(self._graphs) > MAX_REPLICA_GRAPHS:
                self._graphs.pop(next(iter(self._graphs)))
            return replica_graph

    def first_graph(self):
        """A replicated scan graph to canary-probe with (None when this
        replica has never served one)."""
        if self.index == 0:
            return None
        with self._graphs_lock:
            for _tmpl, g in self._graphs.values():
                if getattr(g, "node_tables", None):
                    return g
        return None

    def note(self, *, requests: int = 0, completed: int = 0,
             failed: int = 0) -> None:
        with self._stats_lock:
            self.requests += requests
            self.completed += completed
            self.failed += failed

    def snapshot(self) -> Dict[str, Any]:
        with self._stats_lock:
            return {"device": self.index,
                    "placement": str(self.device),
                    "requests": self.requests,
                    "completed": self.completed,
                    "failed": self.failed,
                    "quarantines": self.quarantines,
                    "reinstates": self.reinstates,
                    "probes": self.probes}


class ReplicaSet:
    """N device replicas + the per-device health ladder.

    ``session`` is the template: replica 0 reuses it (and the caller's
    original graph objects); replicas 1..N-1 get fresh
    ``session.clone()`` sessions with their own plan caches, string
    pools, and fused memos, plus graph copies — cached state never
    migrates across replicas.

    The health ladder reuses the breaker state machine, device-scoped:
    quarantined == open (the device serves nothing), probing ==
    half-open (exactly one background canary in flight).  Only
    *device-attributed* failures (``serve.failure.device_fault``) climb
    the ladder — a user's bad query must never take a device down.  With
    a single replica the ladder is disabled: there is no second device
    to fail over to, so quarantining the only one would turn a sick
    device into a dead server.
    """

    def __init__(self, session, graph=None, n_devices: int = 1,
                 registry=None, failure_threshold: int = 3,
                 cooldown_s: float = 1.0, on_change=None, groups=()):
        n = max(1, int(n_devices))
        devices = _acquire_devices(n, session)
        #: shard-group members (serve/shards.py): capacity members that
        #: front ONE hash-partitioned graph each, mixed behind the same
        #: server next to the throughput replicas above.  Groups keep
        #: their own (group-level) health ladder; the replica breaker
        #: below never sees them.
        self.groups = list(groups)
        self.replicas: List[DeviceReplica] = []
        for i in range(n):
            s = session if i == 0 else (
                session.clone(device=devices[i])
                if hasattr(session, "device") else session.clone())
            self.replicas.append(DeviceReplica(i, s, devices[i]))
        if graph is not None and supports_replication(graph):
            # ingest once per device, up front: serving never pays a
            # surprise re-ingest, and a broken replication fails loudly
            # at construction.  Non-replicable default graphs (union /
            # catalog) are NOT an error — their requests pin to
            # device 0 (replica_for), the other replicas idle for them.
            for r in self.replicas:
                r.graph_for(graph)
        self._breaker = CircuitBreaker(
            registry, failure_threshold=failure_threshold,
            cooldown_s=cooldown_s, metric_prefix="serve.device_breaker")
        self._quarantined_c = registry.counter("serve.devices.quarantined")
        self._reinstated_c = registry.counter("serve.devices.reinstated")
        self._probes_c = registry.counter("serve.devices.probes")
        self._on_change = on_change
        self._rr = itertools.count()

    def __len__(self) -> int:
        return len(self.replicas)

    # -- shard groups (serve/shards.py) --------------------------------

    def group_for(self, graph):
        """The shard group serving this graph, or None (the graph is
        replica territory).  Claimed batches against a group graph
        redirect here whichever worker claimed them."""
        for g in self.groups:
            if g.serves(graph):
                return g
        return None

    @staticmethod
    def _is_group(member) -> bool:
        from caps_tpu_torch.serve.shards import ShardGroup
        return isinstance(member, ShardGroup)

    # -- health --------------------------------------------------------

    def state(self, replica) -> str:
        if self._is_group(replica):
            return replica.health()
        index = replica.index if isinstance(replica, DeviceReplica) \
            else int(replica)
        if len(self.replicas) == 1:
            return HEALTHY
        return _BREAKER_TO_HEALTH[self._breaker.state(index)]

    def is_healthy(self, replica) -> bool:
        if self._is_group(replica):
            # a DEGRADED group still serves (healthy members + retry
            # ladder); only a quarantined group stops claiming work
            from caps_tpu_torch.serve.shards import GROUP_QUARANTINED
            return replica.health() != GROUP_QUARANTINED
        return self.state(replica) == HEALTHY

    def live_count(self) -> int:
        return sum(1 for r in self.replicas if self.is_healthy(r)) \
            + sum(1 for g in self.groups if self.is_healthy(g))

    def quarantined_count(self) -> int:
        return len(self.replicas) + len(self.groups) - self.live_count()

    def health(self) -> Dict[int, str]:
        return {r.index: self.state(r) for r in self.replicas}

    def _changed(self) -> None:
        if self._on_change is not None:
            try:
                self._on_change()
            except Exception:  # pragma: no cover — bookkeeping only
                pass

    # -- outcome bookkeeping (the ladder's input) ----------------------

    def record_success(self, replica) -> None:
        if self._is_group(replica):
            replica.record_success()
            return
        replica.note(completed=1)
        if len(self.replicas) > 1:
            self._breaker.record_success(replica.index)

    def record_failure(self, replica, exc: BaseException):
        """Fold one execution failure in.  Only device-attributed errors
        count against the device; returns truthy when THIS failure
        quarantined it (the caller drains its claimed work back to the
        dispatcher and lets the background probe reinstate it).  Shard
        groups return ``"member"`` / ``"group"`` for the level that
        tripped (their ladder is group-scoped — serve/shards.py)."""
        from caps_tpu_torch.serve.failure import device_fault
        if self._is_group(replica):
            tripped = replica.record_failure(exc)
            if tripped:
                self._changed()
            return tripped
        replica.note(failed=1)
        if len(self.replicas) == 1 or not device_fault(exc):
            return False
        tripped = self._breaker.record_failure(replica.index, exc)
        if tripped:
            with replica._stats_lock:
                replica.quarantines += 1
            self._quarantined_c.inc()
            tracer = replica.session.tracer
            if tracer.enabled:
                tracer.event("device.quarantined", device=replica.index,
                             error=type(exc).__name__)
            self._changed()
        return tripped

    # -- background probe (quarantined -> probing -> healthy) ----------

    def try_probe(self, replica):
        """Breaker admit for the background probe: ``(TRIAL, 0)`` when
        the cooldown elapsed and this caller owns the single probe slot,
        else ``(REJECT, remaining_cooldown)``.  Shard groups gate on
        their own maintenance cadence."""
        if self._is_group(replica):
            return replica.probe_gate()
        return self._breaker.admit(replica.index)

    def probe(self, replica) -> bool:
        if self._is_group(replica):
            # the group's "probe" is one maintenance pass: per-member
            # canaries + background rebuild onto a spare session
            ok = replica.maintenance_tick()
            self._changed()
            return ok
        return self._probe_replica(replica)

    def _probe_replica(self, replica: DeviceReplica) -> bool:
        """Run the health canary on the replica's own session/device —
        a replicated-graph scan when one exists (so operator-stream
        faults scoped to this device fail the probe), else a tiny
        arithmetic program.  Success reinstates the device; failure
        re-opens the quarantine for another cooldown."""
        replica.note()
        with replica._stats_lock:
            replica.probes += 1
        self._probes_c.inc()
        tracer = replica.session.tracer
        try:
            with replica.lock, cancel_scope(None), replica.activate():
                g = replica.first_graph()
                if g is not None:
                    g.cypher(_CANARY_QUERY)
                else:
                    self._arith_canary(replica.device)
            ok = True
        except BaseException:
            ok = False
        if ok:
            was = self._breaker.state(replica.index)
            self._breaker.record_success(replica.index)
            if was != CLOSED:
                with replica._stats_lock:
                    replica.reinstates += 1
                self._reinstated_c.inc()
                if tracer.enabled:
                    tracer.event("device.reinstated", device=replica.index)
        else:
            self._breaker.record_failure(replica.index)
            if tracer.enabled:
                tracer.event("device.probe_failed", device=replica.index)
        self._changed()
        return ok

    @staticmethod
    def _arith_canary(device) -> None:
        """A tiny torch program on the replica's device, waited for (the
        ``int`` reads the result back)."""
        x = torch.arange(8, dtype=torch.int32, device=device)
        got = int((x * 2 + 1).sum())
        if got != 64:  # pragma: no cover — silent corruption
            raise ReplicationUnsupported(
                f"device canary arithmetic returned {got}, expected 64")

    # -- placement -----------------------------------------------------

    def replica_for(self, replica, graph):
        """Where a claimed batch actually executes: a shard-group graph
        always executes on its group (whichever worker claimed it);
        otherwise the claiming worker's own device, except
        non-replicable graphs (union/catalog graphs) which pin to
        device 0 — the template session is the only one that can
        resolve them.  A group worker that claimed a non-group batch
        hands it to device 0 the same way."""
        group = self.group_for(graph)
        if group is not None:
            return group
        if self._is_group(replica):
            return self.replicas[0]
        if replica.index != 0 and not supports_replication(graph):
            return self.replicas[0]
        return replica

    def retry_target(self, exclude_index) -> DeviceReplica:
        """A DIFFERENT healthy device for a transient retry (round-robin
        over the healthy survivors).  ``exclude_index`` is one index or
        an ordered collection of EVERY index that already failed this
        request — with more than one member unhealthy mid-window a
        second retry must not land back on the first failed device.
        Falls back to the most recently excluded device when no healthy
        candidate remains — a same-device retry is still better than
        giving up."""
        if isinstance(exclude_index, int):
            excluded = [exclude_index]
        else:
            excluded = list(exclude_index)
        excluded_set = set(excluded)
        cands = [r for r in self.replicas
                 if r.index not in excluded_set and self.is_healthy(r)]
        if not cands:
            # prefer the most recent failure that actually names a
            # replica (a shard group's index is not in this list)
            for idx in reversed(excluded):
                if 0 <= idx < len(self.replicas):
                    return self.replicas[idx]
            return self.replicas[0]
        return cands[next(self._rr) % len(cands)]

    def summary(self) -> List[Dict[str, Any]]:
        out = []
        for r in self.replicas:
            snap = r.snapshot()
            snap["health"] = self.state(r)
            out.append(snap)
        return out

    def group_summaries(self) -> List[Dict[str, Any]]:
        """Per shard-group structured health (``stats()["shards"]``)."""
        return [g.summary() for g in self.groups]
