"""Shard groups: partitioned graphs behind :class:`QueryServer`.

The counterpart of ``caps_tpu/serve/shards.py``.  Replicas (N members,
each holding the whole graph) scale throughput; capacity stays capped at
one device's memory.  This module adds the capacity member type: a
:class:`ShardGroup` is a set of member sessions fronting ONE
hash-partitioned graph, mixed into the same
:class:`~caps_tpu_torch.serve.devices.ReplicaSet` next to plain replicas.

Where the port differs from the JAX package: the partitions' host
slices are numpy arrays (one per column, plus a validity mask where a
column holds nulls), not Python lists, so a 10M-edge graph partitions
in bulk; members are sessions on the template's device (the card: each
dispatches on a CUDA stream of its own, as a replica does); the pager
reads ``torch.cuda.memory_allocated``; and the cross-shard session is a
mesh session (``parallel/mesh.py``) over ``members`` shards.

* **Partitioning** (:func:`partition_graph`): node rows hash by the
  value of a designated partition property (nodes without it hash by
  node id — a property-equality query can never match them, so they
  never need routing); relationship rows follow their SOURCE node's
  partition.  Partitions are kept as host-side column slices — the
  "snapshot base" a member rebuild re-ingests from and the host arrays
  cold partitions spill to.  Every partition keeps the SAME table
  structure (mapping + column types) as the source graph, so every
  member's schema is identical to the unsharded graph's.

* **Routing** (:meth:`ShardGroup._route`): a query provably resident on
  one shard — a single node pattern, no relationships, with an equality
  on the partition property, and nothing in WHERE/RETURN that escapes
  the matched rows (no EXISTS sub-queries, no other variables) —
  executes on the OWNING member's partition session alone.  Everything
  else is a cross-shard pattern and executes on the group's sharded
  session: one engine session over a ``parallel/mesh.py`` mesh of
  ``members`` shards, whose joins ride the hand-scheduled distributed
  joins (radix / salted / broadcast, ``parallel/dist_join.py``).  Either way results are exactly the
  unsharded session's (the digest-parity tests).

* **Group health ladder** (the robustness core): member states ride the
  same three-state breaker machine the device ladder uses, under a
  ``serve.shard_breaker`` metric prefix.  ``member_failure_threshold``
  consecutive member-attributed device faults quarantine the member and
  DEGRADE the group — healthy members keep serving their shards, the
  server's retry ladder covers the rest.  A background maintenance pass
  (per-member canary probes on the breaker's cooldown cadence) rebuilds
  the lost member onto a spare session — a fresh clone re-ingested from
  the host partition slices — and reinstates it after its canary
  passes.  ``group_failure_threshold`` failed rebuild cycles (or every
  member down at once) QUARANTINE the group: the server sheds
  group-routed traffic at admission with an honest ``retry_after_s``
  while replica members keep serving, and claimed group batches requeue.
  A dead shard device can never take the server down.

* **Host-memory partition paging** (:class:`ShardGroup` pager): with a
  ``page_budget_bytes`` per member, cold partitions spill to their host
  slices (device buffers dropped, member plan-cache entries for the
  spilled graph evicted) and fault back in on access — LRU per member,
  placement decided from the member's resident-byte ledger plus
  ``torch.cuda.memory_allocated`` on a card.  A
  graph larger than one device's budget serves correctly: cold
  partitions are slower (re-ingest + re-plan), never wrong.
  ``paging.faults`` / ``paging.spills`` counters and
  ``paging.resident_bytes`` / ``paging.host_bytes`` gauges account it.

* **Sharded writes** (the durable-writes PR): Cypher CREATE / SET /
  DELETE through the group commits on an INTERNAL versioned lineage
  over the cross-shard clone — the session's normal write path, so
  staging, failure atomicity, and digest parity with an unsharded
  versioned graph hold by construction — and distributes each commit
  to the member shards through a prepare/commit round
  (:meth:`ShardGroup._prepare_commit`): the new overlay splits per
  shard along :func:`partition_graph`'s exact placement, every
  resident partition's new overlay graph builds under that member's
  string-pool mark (prepare — ANY failure rolls every member back and
  aborts the commit with no shard partially applied), the group WAL
  append is the commit point when the group is durable
  (``ShardGroupConfig.wal_dir``), and only then do the prepared
  overlays swap in — pure reference swaps that cannot fail.  Routed
  single-shard reads see writes through their member's overlay;
  cross-shard reads resolve the lineage's current snapshot.

Locking: the group serves ONE dispatch stream (``self.lock``, held by
the server exactly like a replica's execution lock); every residency
mutation (fault-in, spill, rebuild) happens under it, so the pager
needs no lock of its own.  Group state transitions sit behind the
separate ``_state_lock``, which is never held across an engine call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from caps_tpu_torch.obs import clock
from caps_tpu_torch.obs.lockgraph import make_lock
from caps_tpu_torch.serve.breaker import (
    CLOSED, HALF_OPEN, OPEN, REJECT, TRIAL, CircuitBreaker,
)
from caps_tpu_torch.serve.deadline import cancel_scope
from caps_tpu_torch.serve.errors import (
    ShardMemberDown, ShardingUnsupported,
)
from caps_tpu_torch.serve.failure import device_fault

#: group health ladder states (``stats()["shards"]``)
GROUP_HEALTHY = "healthy"
GROUP_DEGRADED = "degraded"
GROUP_QUARANTINED = "quarantined"

#: member states mirror the device ladder's
MEMBER_HEALTHY = "healthy"
MEMBER_QUARANTINED = "quarantined"
MEMBER_PROBING = "probing"

_BREAKER_TO_MEMBER = {CLOSED: MEMBER_HEALTHY, OPEN: MEMBER_QUARANTINED,
                      HALF_OPEN: MEMBER_PROBING}

#: the group-level breaker key (member keys are ``("member", index)``)
_GROUP_KEY = ("group",)

#: per-member canary: a plain scan over a resident partition, so a
#: fault scoped to this member's operator stream fails the probe too
_CANARY_QUERY = "MATCH (n) RETURN n LIMIT 1"

#: bounded ring of group state transitions (bench reporting)
_MAX_TRANSITIONS = 64

#: routing decisions cached per query text (parse once per text)
_ROUTE_CACHE_CAP = 128

_shard_tls = threading.local()

_gauge_guard = make_lock("shards._gauge_guard")


def executing_shard() -> Optional[Tuple[str, Optional[int]]]:
    """``(group_name, member_index)`` for the calling thread's current
    shard-group execution bracket — ``member_index`` is None for a
    group-wide (cross-shard) execution, which runs on EVERY member's
    device at once.  The shard-scoped fault injectors
    (``testing/faults.py`` ``shard_loss`` / ``sick_shard``) key off
    this; None outside any group bracket."""
    return getattr(_shard_tls, "shard", None)


def _attribute_member(exc: BaseException, member_index: int) -> None:
    """Stamp the member index a group execution failure was observed on
    (first-writer-wins, like ``attribute_device``)."""
    try:
        if getattr(exc, "caps_shard_member", None) is None:
            exc.caps_shard_member = member_index
    except Exception:  # pragma: no cover — immutable exception types
        pass


def member_of(exc: BaseException) -> Optional[int]:
    """The member index stamped on a group execution failure (None for
    group-wide / unattributed failures)."""
    return getattr(exc, "caps_shard_member", None)


# -- partitioning ------------------------------------------------------------

def hash_value(value: Any) -> int:
    """Stable, process-independent hash of a partition-property value
    (``hash()`` is salted per process and would re-partition every
    restart).  Numerically-equal ints and floats hash IDENTICALLY —
    Cypher's ``5 = 5.0`` is true, so a float-typed parameter against an
    int-stored property must route to the shard that stored it (a
    type-sensitive hash would silently return empty results).  Booleans
    are not Cypher numbers and hash apart from 0/1."""
    if isinstance(value, bool):
        token = f"b:{value}"
    elif isinstance(value, float) and value.is_integer():
        token = f"i:{int(value)}"
    elif isinstance(value, int):
        token = f"i:{value}"
    elif isinstance(value, float):
        token = f"f:{value!r}"
    elif isinstance(value, str):
        token = f"s:{value}"
    elif value is None:
        token = "n:"
    else:
        token = f"o:{value!r}"
    return zlib.crc32(token.encode("utf-8"))


@dataclasses.dataclass
class _HostSlice:
    """One entity table's rows for one partition, held as host columns —
    the rebuild source and the paging spill target.  ``data`` holds one
    numpy array per column (an object array for strings and other
    non-numeric values); ``valid`` a bool mask for each column that
    holds nulls (absent: every row valid).  ``mapping`` is the SOURCE
    table's mapping, so the rebuilt table's schema is identical by
    construction."""

    kind: str                     # "node" | "rel"
    mapping: Any                  # NodeMapping | RelationshipMapping
    data: Dict[str, np.ndarray]
    types: Dict[str, Any]
    rows: int
    valid: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def host_nbytes(self) -> int:
        """Rough host footprint (the ``paging.host_bytes`` gauge): 8
        bytes per scalar cell plus string payloads, as the JAX package
        estimates its lists — an estimate, not an allocator read."""
        total = 0
        for vals in self.data.values():
            total += 8 * len(vals)
            if vals.dtype == object:
                total += sum(len(v) for v in vals if isinstance(v, str))
            elif vals.dtype.kind == "U":
                total += int(np.char.str_len(vals).sum()) if len(vals) \
                    else 0
        return total

    def columns(self) -> Dict[str, Any]:
        """The columns as ``from_columns`` takes them: numpy arrays, or
        lists with None for a column holding nulls."""
        out: Dict[str, Any] = {}
        for c, vals in self.data.items():
            ok = self.valid.get(c)
            if ok is None:
                out[c] = vals
            else:
                out[c] = [v if o else None
                          for v, o in zip(vals.tolist(), ok.tolist())]
        return out


@dataclasses.dataclass
class GraphPartition:
    """One hash partition of the served graph: host-side slices of every
    entity table (same table structure as the source, rows filtered to
    this partition)."""

    index: int
    node_slices: List[_HostSlice]
    rel_slices: List[_HostSlice]

    @property
    def rows(self) -> int:
        return sum(s.rows for s in self.node_slices) + \
            sum(s.rows for s in self.rel_slices)

    def host_nbytes(self) -> int:
        return sum(s.host_nbytes() for s in self.node_slices) + \
            sum(s.host_nbytes() for s in self.rel_slices)

    def build(self, session):
        """Ingest this partition through ``session``'s table factory —
        per-shard CSR ingest: the member ends up with its own
        device-resident buffers for exactly its rows."""
        from caps_tpu_torch.relational.entity_tables import (NodeTable,
                                                       RelationshipTable)
        factory = session.table_factory
        nts = [NodeTable(s.mapping,
                         factory.from_columns(s.columns(), s.types))
               for s in self.node_slices]
        rts = [RelationshipTable(s.mapping,
                                 factory.from_columns(s.columns(), s.types))
               for s in self.rel_slices]
        return session.create_graph(nts, rts)


def _table_host_columns(table) -> Tuple[Dict[str, np.ndarray],
                                        Dict[str, np.ndarray]]:
    """(values, validity masks of the columns holding nulls) as numpy
    arrays: numeric and boolean columns of a device table in bulk,
    strings decoded through the string pool by code, anything else one
    Python value a row."""
    data: Dict[str, np.ndarray] = {}
    valid: Dict[str, np.ndarray] = {}
    for c in table.columns:
        got = None
        host_values = getattr(table, "host_values", None)
        if host_values is not None:
            got = host_values(c)
            if got is None:
                got = _host_strings(table, c)
        if got is None:
            vals = table.column_values(c)
            ok = np.fromiter((v is not None for v in vals), dtype=bool,
                             count=len(vals))
            arr = np.empty(len(vals), dtype=object)
            arr[:] = vals
            got = (arr, ok)
        vals, ok = got
        data[c] = vals
        if not bool(np.all(ok)):
            valid[c] = ok
    return data, valid


def _host_strings(table, col: str):
    """(object array of str, ok) of a string column of a device table:
    its codes read in bulk, decoded through the pool."""
    c = table._cols.get(col)
    if c is None or c.kind != "str":
        return None
    n = table._exact_n()
    codes = c.data[:n].cpu().numpy()
    ok = c.valid[:n].cpu().numpy()
    table.backend.syncs += 1
    strings = np.empty(len(table.backend.pool) + 1, dtype=object)
    strings[:-1] = table.backend.pool._strings
    return strings[np.where(ok, codes, len(strings) - 1)], ok


def _hash_values(values: np.ndarray, ok: np.ndarray,
                 ids: np.ndarray) -> np.ndarray:
    """:func:`hash_value` of each row's value, or of its id token where
    the value is null — once per distinct value."""
    out = np.empty(len(values), dtype=np.int64)
    if ok.any():
        uniq, inv = np.unique(values[ok], return_inverse=True)
        hashed = np.fromiter((hash_value(v) for v in uniq.tolist()),
                             dtype=np.int64, count=len(uniq))
        out[ok] = hashed[inv]
    miss = ~ok
    if miss.any():
        out[miss] = _id_hashes(ids[miss])
    return out


def _id_hashes(ids: np.ndarray) -> np.ndarray:
    return np.fromiter((hash_value(f"#id:{int(i)}") for i in ids.tolist()),
                       dtype=np.int64, count=len(ids))


def partition_graph(graph, n_partitions: int,
                    partition_property: str = "id",
                    home_out: Optional[Dict[int, int]] = None
                    ) -> List[GraphPartition]:
    """Hash-partition a scan graph's rows into ``n_partitions`` host
    slices.  Node rows hash by ``partition_property``'s value when the
    table maps that property (else by node id); relationship rows
    follow their source node's partition, so each partition's CSR holds
    the edges fanning out of its own nodes.  ``home_out`` (when given)
    receives the node-id -> partition map the split decided — the
    sharded commit protocol routes delta tombstones with it.  Rows keep
    their order within a partition, as in the JAX package."""
    from caps_tpu_torch.relational.graphs import ScanGraph
    if not isinstance(graph, ScanGraph):
        raise ShardingUnsupported(
            f"only scan graphs partition (got {type(graph).__name__}); "
            f"versioned/union/catalog graphs stay on replica members")
    n = max(1, int(n_partitions))
    home_ids: List[np.ndarray] = []
    home_parts: List[np.ndarray] = []
    node_parts: List[List[_HostSlice]] = [[] for _ in range(n)]

    def split(kind, mapping, data, valid, types, part):
        for p in range(n):
            rows = np.nonzero(part == p)[0]
            node_or_rel = node_parts if kind == "node" else rel_parts
            node_or_rel[p].append(_HostSlice(
                kind, mapping, {c: v[rows] for c, v in data.items()},
                types, int(len(rows)),
                {c: v[rows] for c, v in valid.items()}))

    rel_parts: List[List[_HostSlice]] = [[] for _ in range(n)]
    for nt in graph.node_tables:
        table = nt.table
        data, valid = _table_host_columns(table)
        types = {c: table.column_type(c) for c in table.columns}
        ids = data[nt.mapping.id_col].astype(np.int64)
        pcol = nt.mapping.property_cols.get(partition_property)
        if pcol is not None:
            pvals = data[pcol]
            pok = valid.get(pcol, np.ones(len(pvals), dtype=bool))
            hashed = _hash_values(pvals, pok, ids)
        else:
            hashed = _id_hashes(ids)
        part = hashed % n
        home_ids.append(ids)
        home_parts.append(part)
        split("node", nt.mapping, data, valid, types, part)
    all_ids = np.concatenate(home_ids) if home_ids else \
        np.zeros(0, np.int64)
    all_parts = np.concatenate(home_parts) if home_parts else \
        np.zeros(0, np.int64)
    # a node id seen in two tables keeps its LAST table's home, as the
    # JAX package's dict update does
    order = np.argsort(all_ids, kind="stable")
    sid, spart = all_ids[order], all_parts[order]
    last = np.ones(len(sid), dtype=bool)
    last[:-1] = sid[1:] != sid[:-1]
    sid, spart = sid[last], spart[last]
    for rt in graph.rel_tables:
        table = rt.table
        data, valid = _table_host_columns(table)
        types = {c: table.column_type(c) for c in table.columns}
        srcs = data[rt.mapping.source_col].astype(np.int64)
        pos = np.clip(np.searchsorted(sid, srcs), 0, max(len(sid) - 1, 0))
        known = (sid[pos] == srcs) if len(sid) else \
            np.zeros(len(srcs), dtype=bool)
        part = np.empty(len(srcs), dtype=np.int64)
        part[known] = spart[pos[known]]
        if (~known).any():  # dangling edges: hash the source id itself
            part[~known] = _id_hashes(srcs[~known]) % n
        split("rel", rt.mapping, data, valid, types, part)
    if home_out is not None:
        home_out.update(zip(sid.tolist(), spart.tolist()))
    return [GraphPartition(p, node_parts[p], rel_parts[p])
            for p in range(n)]


def _stream_for(session):
    dev = torch.device(getattr(session, "device", "cpu"))
    return torch.cuda.Stream(device=dev) if dev.type == "cuda" else None


@contextlib.contextmanager
def _on_stream(stream):
    """Make ``stream`` (a member's) current for this thread, ordered
    after the card's default stream on entry and before it on exit, as
    a replica's bracket does (``serve/devices.py``); nothing on the
    CPU."""
    if stream is None:
        yield
        return
    default = torch.cuda.default_stream(stream.device)
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        stream.wait_stream(default)
        try:
            yield
        finally:
            default.wait_stream(stream)


# -- configuration -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardGroupConfig:
    #: group name — the fault injectors and stats key by it
    name: str = "shard0"
    #: member devices fronting the partitioned graph
    members: int = 2
    #: the node property whose value equality routes a query to one
    #: shard; nodes without it hash by id (and are never routed to)
    partition_property: str = "id"
    #: partitions per member (> 1 gives the pager units to spill)
    partitions_per_member: int = 1
    #: per-member device budget for resident partitions; None = no
    #: paging pressure (everything stays resident)
    page_budget_bytes: Optional[int] = None
    #: consecutive member-attributed device faults before a member
    #: quarantines (degrading the group)
    member_failure_threshold: int = 2
    #: cooldown before each background probe/rebuild attempt
    member_cooldown_s: float = 1.0
    #: failed rebuild cycles (or unattributed group-wide device faults)
    #: before the whole GROUP quarantines and its traffic sheds
    group_failure_threshold: int = 3
    #: build the cross-shard session over a ``parallel/mesh.py`` mesh of
    #: ``members`` shards (hand-scheduled distributed joins); off (or on
    #: a backend without a mesh) the cross session is a plain
    #: full-graph clone — same results
    cross_shard_mesh: bool = True
    #: durable writes (durability/): when set, every group
    #: commit appends its cumulative overlay to a group WAL under
    #: ``{wal_dir}/wal-shard-{name}`` BEFORE the prepared overlays swap
    #: in, and a fresh group over the same directory recovers the
    #: lineage on construction
    wal_dir: Optional[str] = None
    #: group WAL fsync policy (``"always"`` / ``"rotate"`` / ``"never"``)
    wal_fsync: str = "rotate"


# -- members -----------------------------------------------------------------

class ShardMember:
    """One member's serving state: its own session (per-member plan
    cache / string pool — cached state never crosses members) and
    dispatch stream, the partitions it owns, and which of them are
    device-resident right now (insertion order = LRU)."""

    def __init__(self, index: int, session, partitions: List[int]):
        self.index = index
        self.session = session
        #: the member's own dispatch stream on a card (None on the CPU)
        self.stream = _stream_for(session)
        #: partition indices this member owns
        self.partitions = list(partitions)
        #: pidx -> (graph, page_cost_bytes); insertion-ordered LRU.
        #: The cost is the partition's HOST-slice estimate — one stable
        #: currency for every budget decision, known before first build.
        self.resident: "OrderedDict[int, Tuple[Any, int]]" = OrderedDict()
        #: pidx -> the UNWRAPPED base partition graph behind a resident
        #: entry (the sharded commit protocol re-anchors each commit's
        #: shard overlay on it; identical to the resident graph until
        #: the first write touches the shard)
        self.base_graphs: Dict[int, Any] = {}
        #: pidx -> measured device-table bytes (reporting; populated at
        #: each build)
        self.measured_nbytes: Dict[int, int] = {}
        #: bumped on every rebuild: the "spare/recovered device"
        self.incarnation = 0
        self.requests = 0
        self.failed = 0
        self.rebuilds = 0
        self.probes = 0
        self.quarantines = 0
        self.reinstates = 0
        self.page_faults = 0
        self.page_spills = 0

    def resident_bytes(self) -> int:
        """Resident page cost (host-estimate currency — what the budget
        is checked against)."""
        return sum(nb for _g, nb in self.resident.values())

    def resident_device_bytes(self) -> int:
        """Measured device-table bytes of the resident partitions."""
        return sum(self.measured_nbytes.get(p, 0) for p in self.resident)

    def snapshot(self) -> Dict[str, Any]:
        return {"member": self.index,
                "partitions": list(self.partitions),
                "resident": list(self.resident.keys()),
                "resident_bytes": self.resident_bytes(),
                "resident_device_bytes": self.resident_device_bytes(),
                "incarnation": self.incarnation,
                "requests": self.requests, "failed": self.failed,
                "rebuilds": self.rebuilds, "probes": self.probes,
                "quarantines": self.quarantines,
                "reinstates": self.reinstates,
                "page_faults": self.page_faults,
                "page_spills": self.page_spills}


def _register_group_gauges(registry) -> None:
    """Registry-level ``shard.*`` / ``paging.*`` gauges over the LIVE
    groups on this registry (several servers can share one session —
    the admission depth gauge's live-set pattern): groups join the set
    at construction and leave it in :meth:`ShardGroup.close`, so a dead
    server's groups neither report stale bytes nor stay pinned."""
    with _gauge_guard:
        live = getattr(registry, "_shard_live_groups", None)
        if live is None:
            live = registry._shard_live_groups = []
            registry.gauge("shard.groups", fn=lambda: len(live))
            registry.gauge(
                "shard.degraded",
                fn=lambda: sum(1 for g in live
                               if g.health() != GROUP_HEALTHY))
            registry.gauge(
                "paging.resident_bytes",
                fn=lambda: sum(m.resident_bytes()
                               for g in live for m in g.members))
            registry.gauge(
                "paging.host_bytes",
                fn=lambda: sum(g.cold_host_bytes() for g in live))


class _GroupSessionFacade:
    """The session-shaped surface the server executes a group through:
    ``cypher_on_graph`` / ``cypher_batch`` / ``cypher_degraded`` route
    each query to the owning member's partition session or the group's
    sharded cross-shard session.  The server's whole containment
    machinery (micro-batching, retry ladder, breakers, telemetry) works
    on a group exactly as on a replica because of this seam."""

    def __init__(self, group: "ShardGroup"):
        self._group = group

    @property
    def tracer(self):
        return self._group.template_session.tracer

    def cypher_on_graph(self, graph, query, parameters=None):
        return self._group.execute(query, parameters)

    def cypher_batch(self, graph, items, scopes=None):
        out: List[Any] = []
        for i, (query, params) in enumerate(items):
            scope = scopes[i] if scopes is not None else None
            try:
                with cancel_scope(scope):
                    out.append(self._group.execute(query, params))
            except Exception as ex:
                out.append(ex)
        return out

    def cypher_degraded(self, graph, query, parameters=None, *,
                        no_plan_cache: bool = True,
                        no_fused: bool = False):
        return self._group.execute(query, parameters,
                                   degraded=(no_plan_cache, no_fused))


class ShardGroup:
    """N member devices fronting one hash-partitioned graph — a
    capacity member of the :class:`~caps_tpu_torch.serve.devices.ReplicaSet`,
    duck-typed as a replica (``index`` / ``lock`` / ``session`` /
    ``activate`` / ``graph_for`` / ``note``) so the server's dispatch,
    retry, and telemetry paths treat it like any other execution
    stream."""

    def __init__(self, session, graph, config: ShardGroupConfig,
                 registry, event_log=None, index: int = 0,
                 on_change=None):
        if config.members < 1:
            raise ShardingUnsupported("a shard group needs >= 1 member")
        if getattr(graph, "graph_is_versioned", False):
            raise ShardingUnsupported(
                "shard groups partition static scan graphs and version "
                "them INTERNALLY (writes commit through the group's own "
                "lineage); an externally versioned input would split "
                "the commit lock across two handles")
        self.config = config
        self.name = config.name
        self.graph = graph
        self.index = index
        self.template_session = session
        self._registry = registry
        self._event_log = event_log
        self._on_change = on_change
        #: ONE dispatch stream per group (the server holds it around
        #: every execution, probes and rebuilds take it too) — all
        #: residency mutations happen under it
        self.lock = make_lock("shards.ShardGroup.lock")
        self._state_lock = make_lock("shards.ShardGroup._state_lock")
        n = config.members
        n_parts = n * max(1, config.partitions_per_member)
        #: node id -> partition of the BASE rows (tombstone routing in
        #: the sharded commit split)
        self._node_home: Dict[int, int] = {}
        self.partitions = partition_graph(graph, n_parts,
                                          config.partition_property,
                                          home_out=self._node_home)
        self.members: List[ShardMember] = [
            ShardMember(i, self._member_session(),
                        [p for p in range(n_parts) if p % n == i])
            for i in range(n)]
        #: cross-shard path: one session over a mesh of ``members``
        #: shards (``_cross_shard_session``)
        self.cross_session, self.cross_meshed = self._cross_shard_session()
        from caps_tpu_torch.serve.devices import replicate_graph
        with self._bracket(None):
            self.cross_graph = replicate_graph(graph, self.cross_session)
        #: the group's OWN versioned lineage over the cross-shard clone:
        #: writes commit here through the session's normal write path
        #: (digest parity with an unsharded versioned graph by
        #: construction) and distribute to the member shards via the
        #: prepare/commit round before publishing.  The lineage never
        #: compacts — a fold would move delta rows into the cross base
        #: without re-partitioning the member shards.
        from caps_tpu_torch.relational.updates import VersionedGraph
        with self._bracket(None):
            self._versioned = VersionedGraph(self.cross_session,
                                             self.cross_graph)
        #: pidx -> that shard's slice of the current delta overlay
        #: (only shards with a non-empty slice appear)
        self._shard_states: Dict[int, Any] = {}
        self.wal = None
        if config.wal_dir is not None:
            self._init_durability()
        self._versioned.pre_publish = self._prepare_commit
        self._facade = _GroupSessionFacade(self)
        #: member + group ladder: the same three-state breaker machine
        #: as the device ladder, group-scoped metric prefix
        self._breaker = CircuitBreaker(
            registry, failure_threshold=config.member_failure_threshold,
            cooldown_s=config.member_cooldown_s,
            metric_prefix="serve.shard_breaker")
        #: group-level consecutive failures (rebuild cycles that failed,
        #: unattributed group-wide device faults) — NOT the member count
        self._group_failures = 0
        self._group_open_t: Optional[float] = None
        self._requests_single = registry.counter("shard.requests.single")
        self._requests_cross = registry.counter("shard.requests.cross")
        self._member_quarantined_c = registry.counter(
            "shard.member.quarantined")
        self._member_reinstated_c = registry.counter(
            "shard.member.reinstated")
        self._rebuilds_c = registry.counter("shard.rebuilds")
        self._rebuild_failures_c = registry.counter(
            "shard.rebuild_failures")
        self._probes_c = registry.counter("shard.probes")
        self._group_quarantined_c = registry.counter(
            "shard.group_quarantined")
        self._shed_c = registry.counter("shard.shed")
        self._requests_write = registry.counter("shard.requests.write")
        self._commits_c = registry.counter("shard.commits")
        self._commit_rollbacks_c = registry.counter(
            "shard.commit_rollbacks")
        self._faults_c = registry.counter("paging.faults")
        self._spills_c = registry.counter("paging.spills")
        self._route_cache: "OrderedDict[str, Optional[Tuple]]" = \
            OrderedDict()
        self._transitions: List[Dict[str, Any]] = [
            {"t": clock.now(), "state": GROUP_HEALTHY}]
        self._state = GROUP_HEALTHY
        self._next_tick_t = 0.0
        self._maint_stop = threading.Event()
        self._maint_thread: Optional[threading.Thread] = None
        self._closed = False
        # replica-compatible counters (server _note_device_outcomes)
        self._stats_lock = make_lock("shards.ShardGroup._stats_lock")
        self.requests = 0
        self.completed = 0
        self.failed = 0
        #: eager ingest up to the page budget: serving pays no surprise
        #: re-ingest for the hot set, cold partitions stay on the host
        with self.lock:
            for m in self.members:
                for pidx in m.partitions:
                    if not self._fits(m, self.partitions[pidx]):
                        break
                    self._fault_in(m, pidx, count_fault=False)
        _register_group_gauges(registry)
        registry._shard_live_groups.append(self)

    # -- replica duck type ---------------------------------------------

    @property
    def session(self):
        return self._facade

    @property
    def device(self):  # placement string for summaries
        return f"shard-group:{self.name}"

    @contextlib.contextmanager
    def activate(self):
        """Group-wide execution bracket (cross-shard dispatch runs on
        every member's device at once): stamps ``executing_shard()``
        with ``(name, None)``.  Member-scoped brackets nest inside."""
        with self._bracket(None):
            yield

    @contextlib.contextmanager
    def _bracket(self, member_index: Optional[int]):
        prev = getattr(_shard_tls, "shard", None)
        _shard_tls.shard = (self.name, member_index)
        try:
            yield
        finally:
            _shard_tls.shard = prev

    def graph_for(self, graph):
        """Identity: routing happens inside the facade, per query."""
        return graph

    def serves(self, graph) -> bool:
        return graph is self.graph

    def note(self, *, requests: int = 0, completed: int = 0,
             failed: int = 0) -> None:
        with self._stats_lock:
            self.requests += requests
            self.completed += completed
            self.failed += failed

    # -- construction helpers ------------------------------------------

    def _member_session(self):
        """A fresh mesh-free clone for one member on the template's
        device: the member's partition is a single-device graph whatever
        the template's own mesh config is."""
        cfg = getattr(self.template_session, "config", None)
        if cfg is not None and getattr(cfg, "mesh_shape", ()):
            return type(self.template_session)(
                config=dataclasses.replace(cfg, mesh_shape=()),
                device=self.template_session.device)
        return self.template_session.clone()

    def _cross_shard_session(self):
        """The cross-shard session: a session over a mesh of
        ``members`` shards on the template's device (its shards on as
        many cards where the process sees them, else a virtual mesh on
        the template's card) — a device session always has a mesh, so
        no fallback is taken.  ``cross_shard_mesh=False`` (or a session
        without a device backend) gives a plain clone: correct,
        unsharded."""
        cfg = getattr(self.template_session, "config", None)
        if self.config.cross_shard_mesh and cfg is not None \
                and hasattr(cfg, "mesh_shape") \
                and hasattr(self.template_session, "backend") \
                and self.config.members > 1:
            s = type(self.template_session)(
                config=dataclasses.replace(
                    cfg, mesh_shape=(self.config.members,)),
                device=self.template_session.device)
            return s, True
        return self.template_session.clone(), False

    def _init_durability(self) -> None:
        """Open the group WAL and recover the lineage from it: the best
        intact entry (entries are cumulative — the group lineage never
        compacts, so they overlay the spec'd base directly) installs
        into the internal versioned handle at its logged version, and
        the recovered overlay re-splits per shard so the eager ingest
        below wraps every resident partition at the recovered state."""
        from caps_tpu_torch.durability import CommitLog
        from caps_tpu_torch.relational.updates import delta_state_from_payload
        self.wal = CommitLog(
            os.path.join(self.config.wal_dir, f"wal-shard-{self.name}"),
            fsync=self.config.wal_fsync, registry=self._registry,
            event_log=self._event_log)
        rec = self.wal.recover()
        if rec.version > 0:
            state = delta_state_from_payload(rec.state)
            with self._bracket(None):
                self._versioned.install_state(state, rec.version)
            self._shard_states = self._split_state(state)

    # -- paging ---------------------------------------------------------

    def _partition_cost(self, pidx: int) -> int:
        """The pager's ONE byte currency: the partition's host-slice
        estimate — stable, known before the first build, identical on
        both sides of every budget comparison (a never-built partition
        has no measured device size yet; mixing currencies would make
        admission decisions erratic)."""
        return self.partitions[pidx].host_nbytes()

    def _device_pressure(self, member: ShardMember) -> int:
        """The pager's placement input: this member's tracked resident
        bytes, raised to the card's allocated bytes
        (``torch.cuda.memory_allocated``) split over the members where
        the member is on a card (0 on the CPU)."""
        tracked = member.resident_bytes()
        dev = torch.device(getattr(member.session, "device", "cpu"))
        in_use = torch.cuda.memory_allocated(dev) \
            if dev.type == "cuda" else 0
        n = max(1, len(self.members))
        return max(tracked, in_use // n)

    def _fits(self, member: ShardMember, partition: GraphPartition
              ) -> bool:
        budget = self.config.page_budget_bytes
        if budget is None:
            return True
        return self._device_pressure(member) \
            + partition.host_nbytes() <= budget

    def _fault_in(self, member: ShardMember, pidx: int,
                  count_fault: bool = True):
        """Make a partition device-resident (caller holds the group
        lock): spill LRU siblings while over budget, then ingest from
        the host slice.  The incoming partition is always admitted —
        serving a query beats honoring the budget to the byte."""
        got = member.resident.get(pidx)
        if got is not None:
            member.resident.move_to_end(pidx)
            return got[0]
        budget = self.config.page_budget_bytes
        incoming = self._partition_cost(pidx)
        if budget is not None:
            # same pressure reading as the eager-ingest _fits check —
            # ONE currency on both sides of every budget decision
            while member.resident and \
                    self._device_pressure(member) + incoming > budget:
                self._spill(member, next(iter(member.resident)))
        with self._bracket(member.index), _on_stream(member.stream):
            built = self.partitions[pidx].build(member.session)
            graph = built
            # re-anchor the shard's slice of the current delta overlay
            # on the freshly built base: a spilled-then-faulted
            # partition must come back at the lineage's CURRENT state
            sstate = self._shard_states.get(pidx)
            if sstate is not None:
                graph = self._overlay_graph(
                    member.session, built, sstate,
                    self._versioned.current().snapshot_version)
        member.base_graphs[pidx] = built
        from caps_tpu_torch.obs.ledger import tables_nbytes
        member.measured_nbytes[pidx] = tables_nbytes(
            tuple(built.node_tables) + tuple(built.rel_tables))
        member.resident[pidx] = (graph, incoming)
        if count_fault:
            member.page_faults += 1
            self._faults_c.inc()
        return graph

    def _spill(self, member: ShardMember, pidx: int) -> None:
        """Drop a partition's device residency: the graph (and its
        device buffers) go, the member session's plan-cache entries
        anchored on it are evicted (a later fault-in is a NEW graph
        object — stale entries would only pin memory), and the host
        slice remains the truth."""
        graph, _nb = member.resident.pop(pidx)
        base = member.base_graphs.pop(pidx, None)
        for g in (graph, base if base is not graph else None):
            token = getattr(g, "_plan_token", None) if g is not None \
                else None
            if token is not None:
                try:
                    member.session.plan_cache.evict_graph(token)
                except Exception:  # pragma: no cover — accounting only
                    pass
        member.page_spills += 1
        self._spills_c.inc()

    def cold_host_bytes(self) -> int:
        """Host bytes of partitions currently NOT device-resident."""
        total = 0
        for m in self.members:
            for pidx in m.partitions:
                if pidx not in m.resident:
                    total += self.partitions[pidx].host_nbytes()
        return total

    # -- routing --------------------------------------------------------

    def _route(self, query: str) -> Optional[Tuple[str, Any]]:
        """``("param", name)`` / ``("lit", value)`` when the query is
        provably resident on the shard owning that partition-property
        value; None = cross-shard.  Cached per query text."""
        with self._state_lock:
            if query in self._route_cache:
                self._route_cache.move_to_end(query)
                return self._route_cache[query]
        route = self._compute_route(query)
        with self._state_lock:
            self._route_cache[query] = route
            while len(self._route_cache) > _ROUTE_CACHE_CAP:
                self._route_cache.popitem(last=False)
        return route

    def _compute_route(self, query: str) -> Optional[Tuple[str, Any]]:
        from caps_tpu_torch.frontend import ast
        from caps_tpu_torch.frontend.parser import parse_query, query_mode
        from caps_tpu_torch.ir import exprs as E
        mode, body = query_mode(query)
        if mode is not None:
            return None  # EXPLAIN/PROFILE: run on the cross session
        try:
            from caps_tpu_torch.relational.updates import is_update_query
            if is_update_query(body):
                return None
            stmt = parse_query(body)
        except Exception:
            return None  # let the normal path raise the real error
        if not isinstance(stmt, ast.SingleQuery):
            return None
        matches = [c for c in stmt.clauses
                   if isinstance(c, ast.MatchClause)]
        if len(matches) != 1 or any(
                not isinstance(c, (ast.MatchClause, ast.WithClause,
                                   ast.ReturnClause))
                for c in stmt.clauses):
            return None
        m = matches[0]
        if m.optional or len(m.pattern.parts) != 1:
            return None
        part = m.pattern.parts[0]
        if part.rels or len(part.nodes) != 1 or part.path_var:
            return None
        node = part.nodes[0]
        cand = None
        if isinstance(node.properties, E.MapLit):
            for k, v in zip(node.properties.keys, node.properties.values):
                if k == self.config.partition_property and \
                        isinstance(v, (E.Param, E.Lit)):
                    cand = v
        if cand is None and m.where is not None and node.var is not None:
            conjs = m.where.exprs if isinstance(m.where, E.Ands) \
                else (m.where,)
            for e in conjs:
                if not isinstance(e, E.Equals):
                    continue
                for lhs, rhs in ((e.lhs, e.rhs), (e.rhs, e.lhs)):
                    if isinstance(lhs, E.Property) \
                            and lhs.entity == E.Var(node.var) \
                            and lhs.key == self.config.partition_property \
                            and isinstance(rhs, (E.Param, E.Lit)):
                        cand = rhs
                        break
                if cand is not None:
                    break
        if cand is None:
            return None
        # nothing may escape the matched rows: a variable outside the
        # running binding set (the node var, plus projection aliases
        # WITH derives FROM it), or a sub-query/path construct anywhere
        # in WHERE / WITH / RETURN, could read graph data living on
        # OTHER shards
        escape = (E.ExistsSubQuery, E.Exists, E.PathExpr, E.PathSeg,
                  E.PathNode, E.PathNodes)

        def clean(tree, allowed) -> bool:
            for n_ in tree.walk():
                if isinstance(n_, escape):
                    return False
                if isinstance(n_, E.Var) and n_.name not in allowed:
                    return False
            return True

        allowed = {node.var} if node.var is not None else set()
        for clause in stmt.clauses:
            if isinstance(clause, ast.MatchClause):
                if clause.where is not None and \
                        not clean(clause.where, allowed):
                    return None
                continue
            body = clause.body
            introduced = set()
            for item in body.items:
                if not clean(item.expr, allowed):
                    return None
                if item.alias is not None:
                    introduced.add(item.alias)
                elif isinstance(item.expr, E.Var):
                    introduced.add(item.expr.name)
            visible = allowed | introduced
            for o in body.order_by:
                if not clean(o.expr, visible):
                    return None
            where = getattr(clause, "where", None)
            if where is not None and not clean(where, visible):
                return None
            if isinstance(clause, ast.WithClause):
                allowed = visible if body.star else introduced
        if isinstance(cand, E.Param):
            return ("param", cand.name)
        return ("lit", cand.value)

    def owning_member(self, value: Any) -> Tuple[int, ShardMember]:
        pidx = hash_value(value) % len(self.partitions)
        return pidx, self.members[pidx % len(self.members)]

    # -- execution ------------------------------------------------------

    def execute(self, query: str,
                parameters: Optional[Mapping[str, Any]] = None,
                degraded: Optional[Tuple[bool, bool]] = None):
        """One query through the group (caller holds ``self.lock`` via
        the server's dispatch): route to the owning member's partition
        session or the cross-shard session; failures are attributed to
        the executing member for the health ladder."""
        params = dict(parameters or {})
        from caps_tpu_torch.relational.updates import is_update_query
        from caps_tpu_torch.frontend.parser import query_mode
        mode, body = query_mode(query)
        if is_update_query(body if mode is not None else query):
            return self._execute_update(query, params, degraded)
        route = self._route(query)
        value: Any = None
        routed = False
        if route is not None:
            kind, token = route
            if kind == "lit":
                value, routed = token, True
            elif token in params:
                value, routed = params[token], True
        if routed:
            pidx, member = self.owning_member(value)
            return self._execute_member(member, pidx, query, params,
                                        degraded)
        return self._execute_cross(query, params, degraded)

    def _execute_member(self, member: ShardMember, pidx: int, query,
                        params, degraded):
        state = self.member_state(member.index)
        if state != MEMBER_HEALTHY:
            # fast transient failure: the server's retry ladder backs
            # off while the background rebuild brings the member back
            raise ShardMemberDown(
                f"shard member {member.index} of group {self.name!r} is "
                f"{state}; rebuild in progress", member=member.index)
        member.requests += 1
        self._requests_single.inc()
        try:
            with self._bracket(member.index), _on_stream(member.stream):
                graph = self._fault_in(member, pidx)
                out = self._run(member.session, graph, query, params,
                                degraded)
        except BaseException as ex:
            member.failed += 1
            _attribute_member(ex, member.index)
            raise
        # consecutive-failure semantics for the MEMBER ladder too: a
        # served request ends the member's streak (the device ladder
        # does the same per request).  Guarded on CLOSED so a trip that
        # raced in from another request's bookkeeping is never undone
        # by a success that started before it.
        key = ("member", member.index)
        if self._breaker.state(key) == CLOSED:
            self._breaker.record_success(key)
        return out

    def _execute_cross(self, query, params, degraded):
        self._requests_cross.inc()
        with self._bracket(None):
            # the lineage's current snapshot, not the static clone:
            # cross-shard reads see every committed write (a snapshot
            # is a stable plan-cache anchor exactly like the clone was)
            return self._run(self.cross_session,
                             self._versioned.current(),
                             query, params, degraded)

    @staticmethod
    def _run(session, graph, query, params, degraded):
        if degraded is not None:
            no_plan_cache, no_fused = degraded
            return session.cypher_degraded(graph, query, params,
                                           no_plan_cache=no_plan_cache,
                                           no_fused=no_fused)
        return session.cypher_on_graph(graph, query, params)

    # -- sharded commits (the durable-writes protocol) ------------------

    def _execute_update(self, query, params, degraded):
        """A Cypher write through the group: the session's NORMAL write
        path runs against the internal versioned lineage (same staging,
        same failure atomicity, digest parity with an unsharded
        versioned session by construction); publication runs the
        prepare/commit round via the lineage's ``pre_publish`` hook."""
        self._requests_write.inc()
        with self._bracket(None):
            return self._run(self.cross_session, self._versioned,
                             query, params, degraded)

    @staticmethod
    def _overlay_graph(session, base, state, version):
        """One shard's overlay: the member-local base partition plus
        this shard's slice of the lineage's delta, as an ordinary
        immutable snapshot (plan-cacheable per commit version)."""
        from caps_tpu_torch.relational.updates import (GraphSnapshot,
                                                 build_delta_graph)
        delta = build_delta_graph(session, state)
        return GraphSnapshot(session, base, delta, state, version,
                             handle=None)

    def _split_state(self, state) -> Dict[int, Any]:
        """Split one cumulative delta overlay into per-shard overlays,
        mirroring :func:`partition_graph`'s placement exactly: delta
        node records hash by their partition-property value (id-token
        without one), delta relationships follow their source node's
        CURRENT home, and tombstones go where the base row they mask
        lives — a SET that moves the partition property emits the
        record on the new home and the tombstone on the old, so a
        routed query for either value answers correctly.  Shards whose
        slice is empty are omitted."""
        from caps_tpu_torch.relational.updates import DeltaState
        n = len(self.partitions)
        prop = self.config.partition_property
        delta_home: Dict[int, int] = {}
        for rec in state.nodes:
            v = rec.props_dict().get(prop)
            delta_home[rec.id] = (hash_value(v) if v is not None
                                  else hash_value(f"#id:{rec.id}")) % n

        def base_home(nid: int) -> int:
            got = self._node_home.get(nid)
            return got if got is not None \
                else hash_value(f"#id:{nid}") % n

        def node_home(nid: int) -> int:
            got = delta_home.get(nid)
            return got if got is not None else base_home(nid)

        hn: Dict[int, set] = {}
        hr: Dict[int, set] = {}
        nodes: Dict[int, List[Any]] = {}
        rels: Dict[int, List[Any]] = {}
        for rec in state.nodes:
            nodes.setdefault(delta_home[rec.id], []).append(rec)
        for rec in state.rels:
            rels.setdefault(node_home(rec.src), []).append(rec)
        for nid in state.hidden_nodes:
            hn.setdefault(base_home(nid), set()).add(nid)
        base_rels = self.graph.rel_lookup()
        for rid in state.hidden_rels:
            got = base_rels.get(rid)
            p = base_home(got[0]) if got is not None \
                else hash_value(f"#id:{rid}") % n
            hr.setdefault(p, set()).add(rid)
        out: Dict[int, Any] = {}
        for p in set(hn) | set(hr) | set(nodes) | set(rels):
            out[p] = DeltaState(
                hidden_nodes=frozenset(hn.get(p, ())),
                hidden_rels=frozenset(hr.get(p, ())),
                nodes=tuple(nodes.get(p, ())),
                rels=tuple(rels.get(p, ())))
        return out

    def _prepare_commit(self, new_snap) -> None:
        """The prepare/commit round (``VersionedGraph.pre_publish`` —
        the commit lock and the group's dispatch lock are both held).

        **Prepare**: split the new cumulative overlay per shard and
        build each changed resident partition's new overlay graph under
        that member's string-pool mark.  Any failure — a device fault
        on one member, an injected abort, a failed WAL append — rolls
        EVERY member's pool back and aborts the commit; no shard is
        ever partially applied (the outer publish rolls the cross
        session back the same way).

        **Commit point**: the group WAL append (durable groups).  An
        acknowledged write is on disk before any reader can see it.

        **Commit**: swap the prepared overlays in, member by member —
        pure reference swaps that cannot fail — and evict each replaced
        graph's plan-cache entries (a superseded shard overlay can
        never be read again)."""
        shard_states = self._split_state(new_snap.state)
        staged: List[Tuple[Any, Any]] = []
        prepared: List[Tuple[ShardMember, int, Any]] = []
        try:
            for member in self.members:
                pool = getattr(getattr(member.session, "backend", None),
                               "pool", None)
                staged.append((pool,
                               pool.mark() if pool is not None else None))
                for pidx in member.resident:
                    new_state = shard_states.get(pidx)
                    if new_state == self._shard_states.get(pidx):
                        continue
                    base = member.base_graphs.get(pidx)
                    if base is None:  # pragma: no cover — resident ⊆ built
                        continue
                    if new_state is None:
                        # the shard's slice emptied out: back to the base
                        prepared.append((member, pidx, base))
                        continue
                    with self._bracket(member.index), \
                            _on_stream(member.stream):
                        prepared.append((member, pidx, self._overlay_graph(
                            member.session, base, new_state,
                            new_snap.snapshot_version)))
            if self.wal is not None:
                from caps_tpu_torch.relational.updates import \
                    delta_state_to_payload
                self.wal.append(new_snap.snapshot_version,
                                delta_state_to_payload(new_snap.state))
        except BaseException:
            for pool, mark in staged:
                if pool is not None:
                    pool.rollback(mark)
            self._commit_rollbacks_c.inc()
            raise
        for member, pidx, graph in prepared:
            old, cost = member.resident[pidx]
            if old is not graph:
                token = getattr(old, "_plan_token", None)
                if token is not None:
                    try:
                        member.session.plan_cache.evict_graph(token)
                    except Exception:  # pragma: no cover — accounting
                        pass
            member.resident[pidx] = (graph, cost)
        self._shard_states = shard_states
        self._commits_c.inc()

    def quarantine_family(self, query: str,
                          params: Mapping[str, Any]) -> None:
        """Poisoned-plan quarantine, group-routed: evict the cached
        plan entry on the session that actually served this family
        (the owning member or the cross session)."""
        from caps_tpu_torch.serve.failure import quarantine_plan_state
        route = self._route(query)
        params = dict(params or {})
        session, graph = self.cross_session, self._versioned.current()
        if route is not None:
            kind, token = route
            value = token if kind == "lit" else params.get(token)
            if kind == "lit" or token in params:
                pidx, member = self.owning_member(value)
                got = member.resident.get(pidx)
                if got is None:
                    return  # nothing resident: nothing cached to poison
                session, graph = member.session, got[0]
        # the shared eviction sequence (serve/failure.py), under the
        # group's one dispatch stream lock
        quarantine_plan_state(session, graph, query, params,
                              exec_lock=self.lock)
        # member sessions carry their own result caches when serving is
        # cache-enabled: a poisoned family's materialized rows (and the
        # shared memoized intermediates) go with the plan
        rcache = getattr(session, "result_cache", None)
        if rcache is not None:
            from caps_tpu_torch.frontend.parser import normalize_query
            rcache.evict_family(normalize_query(query))

    # -- ladder bookkeeping (the server's outcome feed) ----------------

    def record_success(self) -> None:
        self.note(completed=1)
        # consecutive-failure semantics, like every other breaker in
        # the tier: a served group request ends the group-level streak
        # (an OPEN group never serves, so this can never mask a real
        # quarantine — only prevent a slow trickle of transient
        # cross-shard wobbles from ever summing to one)
        with self._state_lock:
            if self._group_open_t is None:
                self._group_failures = 0

    def record_failure(self, exc: BaseException) -> Optional[str]:
        """Fold one group execution failure in.  Returns ``"member"`` /
        ``"group"`` when THIS failure tripped that ladder level (the
        server flight-dumps and events it), else None.  Only
        device-attributed failures climb — a user's bad query never
        degrades a group."""
        self.note(failed=1)
        if not device_fault(exc):
            return None
        member_idx = member_of(exc)
        tripped: Optional[str] = None
        if member_idx is not None and 0 <= member_idx < len(self.members):
            if self._breaker.record_failure(("member", member_idx), exc):
                self.members[member_idx].quarantines += 1
                self._member_quarantined_c.inc()
                tripped = "member"
        else:
            # group-wide (cross-shard) device fault with no member
            # attribution: counts against the GROUP ladder directly
            if self._note_group_failure(exc):
                tripped = "group"
        if self._all_members_down() and self._group_open_t is None:
            with self._state_lock:
                self._group_open_t = clock.now()
            self._group_quarantined_c.inc()
            tripped = "group"
        self._recompute_state()
        return tripped

    def _note_group_failure(self, exc: Optional[BaseException]) -> bool:
        with self._state_lock:
            self._group_failures += 1
            if self._group_failures >= \
                    self.config.group_failure_threshold \
                    and self._group_open_t is None:
                self._group_open_t = clock.now()
                quarantined = True
            else:
                quarantined = False
        if quarantined:
            self._group_quarantined_c.inc()
        return quarantined

    def _note_group_success(self) -> None:
        with self._state_lock:
            self._group_failures = 0
            self._group_open_t = None

    def _all_members_down(self) -> bool:
        return all(self.member_state(m.index) != MEMBER_HEALTHY
                   for m in self.members)

    def member_state(self, index: int) -> str:
        return _BREAKER_TO_MEMBER[self._breaker.state(("member", index))]

    def member_health(self) -> Dict[int, str]:
        return {m.index: self.member_state(m.index) for m in self.members}

    def health(self) -> str:
        """``healthy`` (every member serving) / ``degraded`` (>= 1
        member down or probing — the rest keep serving their shards) /
        ``quarantined`` (group-level trip or every member down: the
        server sheds group traffic with an honest retry hint)."""
        if self._group_open_t is not None or self._all_members_down():
            return GROUP_QUARANTINED
        if any(self.member_state(m.index) != MEMBER_HEALTHY
               for m in self.members):
            return GROUP_DEGRADED
        return GROUP_HEALTHY

    def shed_retry_after(self) -> Optional[float]:
        """Non-None when group-routed traffic should shed at admission:
        the remaining member cooldown — the earliest time the
        background rebuild could have changed anything."""
        if self.health() != GROUP_QUARANTINED:
            return None
        self._shed_c.inc()
        with self._state_lock:
            opened = self._group_open_t
        if opened is None:
            return self.config.member_cooldown_s
        remaining = self.config.member_cooldown_s - (clock.now() - opened)
        return max(0.001, remaining)

    def _recompute_state(self) -> None:
        state = self.health()
        changed = False
        with self._state_lock:
            if state != self._state:
                self._state = state
                self._transitions.append({"t": clock.now(),
                                          "state": state})
                del self._transitions[:-_MAX_TRANSITIONS]
                changed = True
        if changed:
            tracer = self.template_session.tracer
            if tracer.enabled:
                tracer.event("shard.group_state", group=self.name,
                             state=state)
            if self._event_log is not None:
                self._event_log.emit(
                    "shard.group_state", request_id=None, family=None,
                    group=self.name, state=state)
            if self._on_change is not None:
                try:
                    self._on_change()
                except Exception:  # pragma: no cover — bookkeeping only
                    pass

    # -- background probe / rebuild ------------------------------------

    def probe_gate(self) -> Tuple[str, float]:
        """Rate limit for the maintenance driver (the server's
        quarantined-worker idle loop calls through here): ``(TRIAL, 0)``
        at most once per nap interval — :meth:`maintenance_tick` itself
        respects each member's breaker cooldown."""
        nap = min(self.config.member_cooldown_s, 0.05)
        now = clock.now()
        with self._state_lock:
            if now < self._next_tick_t:
                return REJECT, self._next_tick_t - now
            self._next_tick_t = now + nap
        return TRIAL, 0.0

    def maintenance_tick(self) -> bool:
        """One background maintenance pass: for every quarantined member
        whose cooldown elapsed, rebuild it onto a spare session from the
        host partition slices (the snapshot base) and canary-probe it.
        Success reinstates the member (and feeds the group ladder a
        success); failure buys another cooldown and counts toward group
        quarantine.  Returns True when any member was reinstated."""
        reinstated = False
        for member in self.members:
            key = ("member", member.index)
            if self._breaker.state(key) == CLOSED:
                continue
            verdict, _retry = self._breaker.admit(key)
            if verdict != TRIAL:
                continue
            member.probes += 1
            self._probes_c.inc()
            ok = self._rebuild_member(member)
            if ok:
                self._breaker.record_success(key)
                member.reinstates += 1
                self._member_reinstated_c.inc()
                self._note_group_success()
                reinstated = True
                if self._event_log is not None:
                    self._event_log.emit(
                        "shard.member_reinstated", request_id=None,
                        family=None, group=self.name,
                        member=member.index,
                        incarnation=member.incarnation)
            else:
                self._breaker.record_failure(key)
                self._rebuild_failures_c.inc()
                self._note_group_failure(None)
        if reinstated and not self._all_members_down():
            # a serving member back up un-quarantines the group (its
            # failure streak is over by construction)
            self._note_group_success()
        # group-level recovery: a group quarantined by UNATTRIBUTED
        # cross-shard faults has no tripped member for the loop above
        # to rebuild — and its shed traffic can never record a success.
        # Probe the cross-shard session itself on the same cooldown
        # cadence; a passing canary clears the group trip, a failing
        # one buys another cooldown.
        with self._state_lock:
            opened = self._group_open_t
        if opened is not None and all(
                self._breaker.state(("member", m.index)) == CLOSED
                for m in self.members):
            if clock.now() - opened >= self.config.member_cooldown_s:
                self._probes_c.inc()
                if self._cross_canary():
                    self._note_group_success()
                    reinstated = True
                else:
                    with self._state_lock:
                        self._group_open_t = clock.now()
        self._recompute_state()
        return reinstated

    def _cross_canary(self) -> bool:
        """A plain scan through the cross-shard session's own operator
        stream (group-wide bracket: faults spanning any member fail
        it)."""
        try:
            with self.lock, self._bracket(None), cancel_scope(None):
                self._versioned.current().cypher(_CANARY_QUERY)
            return True
        except BaseException:
            return False

    def _rebuild_member(self, member: ShardMember) -> bool:
        """Rebuild one member onto a spare/recovered device: a FRESH
        session clone re-ingests the member's partitions from their
        host slices (budget-bounded — cold ones stay on the host), then
        the canary scan must pass ON that member's stream.  The swap is
        atomic under the group lock; a failed rebuild leaves the old
        state untouched."""
        try:
            fresh = self._member_session()
            stream = _stream_for(fresh)
            resident: "OrderedDict[int, Tuple[Any, int]]" = OrderedDict()
            bases: Dict[int, Any] = {}
            measured: Dict[int, int] = {}
            with self.lock, self._bracket(member.index), _on_stream(stream):
                from caps_tpu_torch.obs.ledger import tables_nbytes
                budget = self.config.page_budget_bytes
                used = 0
                for pidx in member.partitions:
                    cost = self._partition_cost(pidx)
                    if resident and budget is not None \
                            and used + cost > budget:
                        continue
                    built = self.partitions[pidx].build(fresh)
                    measured[pidx] = tables_nbytes(
                        tuple(built.node_tables)
                        + tuple(built.rel_tables))
                    graph = built
                    # committed writes survive the rebuild: the shard's
                    # current overlay re-anchors on the fresh base
                    sstate = self._shard_states.get(pidx)
                    if sstate is not None:
                        graph = self._overlay_graph(
                            fresh, built, sstate,
                            self._versioned.current().snapshot_version)
                    bases[pidx] = built
                    resident[pidx] = (graph, cost)
                    used += cost
                # the canary runs the rebuilt member's own operator
                # stream: a fault scoped to this member fails it here
                probe_graph = next(iter(resident.values()))[0]
                with cancel_scope(None):
                    probe_graph.cypher(_CANARY_QUERY)
                member.session = fresh
                member.stream = stream
                member.resident = resident
                member.base_graphs = bases
                member.measured_nbytes = measured
                member.incarnation += 1
                member.rebuilds += 1
            self._rebuilds_c.inc()
            return True
        except BaseException:
            return False

    # -- maintenance thread (serving-mode background driver) -----------

    def start_maintenance(self) -> None:
        """Background maintenance loop for a RUNNING server: probes and
        rebuilds happen off the serving path (a degraded group keeps
        serving healthy shards while the victim rebuilds).  Tests drive
        :meth:`maintenance_tick` directly on the fake clock instead."""
        if self._maint_thread is not None:
            return
        self._maint_stop.clear()
        t = threading.Thread(target=self._maintenance_loop,
                             name=f"caps-shard-{self.name}",
                             daemon=True)
        self._maint_thread = t
        t.start()

    def _maintenance_loop(self) -> None:
        nap = min(self.config.member_cooldown_s, 0.05)
        while not self._maint_stop.is_set():
            try:
                if self.health() != GROUP_HEALTHY:
                    self.maintenance_tick()
            except Exception:  # pragma: no cover — must keep driving
                pass
            clock.wait(self._maint_stop, nap)

    def close(self) -> None:
        """Server shutdown: stop the maintenance loop and leave the
        registry's live-group gauge set (a dead server's groups must
        not keep reporting bytes)."""
        if self._closed:
            return
        self._closed = True
        self._maint_stop.set()
        t = self._maint_thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        if self.wal is not None:
            try:
                self.wal.close()
            except Exception:  # pragma: no cover — shutdown best-effort
                pass
        with _gauge_guard:
            live = getattr(self._registry, "_shard_live_groups", [])
            if self in live:
                live.remove(self)

    # -- reporting ------------------------------------------------------

    def warmup_bindings(self) -> List[Dict[str, Any]]:
        """Compile-charging bindings recorded ANYWHERE in the group
        (member + cross sessions) — the plan-store collection seam: a
        family served only by this group must still round-trip into the
        persistent store so a cold process can warm it
        (serve/warmup.py ``ServerWarmup.save``)."""
        out: List[Dict[str, Any]] = []
        seen: set = set()
        for s in [m.session for m in self.members] + [self.cross_session]:
            fn = getattr(s, "warmup_bindings", None)
            if fn is None:
                continue
            for b in fn():
                if b["family"] not in seen:
                    seen.add(b["family"])
                    out.append(b)
        return out

    def compiled_families(self) -> set:
        """Plan families that compiled ANYWHERE in this group (member
        sessions + the cross-shard session) — ``warmup_report()``'s
        coverage input: a family warmed only on the group must count as
        compiled."""
        out: set = set()
        for s in [m.session for m in self.members] + [self.cross_session]:
            ledger = getattr(s, "compile_ledger", None)
            if ledger is not None:
                out.update(ledger.families())
        return out

    def summary(self) -> Dict[str, Any]:
        with self._state_lock:
            transitions = [dict(t) for t in self._transitions]
            group_failures = self._group_failures
        return {
            "name": self.name,
            "index": self.index,
            "state": self.health(),
            "version": self._versioned.current().snapshot_version,
            "durable": self.wal is not None,
            "partitions": len(self.partitions),
            "partition_property": self.config.partition_property,
            "cross_shard_meshed": self.cross_meshed,
            "members": [dict(m.snapshot(),
                             health=self.member_state(m.index))
                        for m in self.members],
            "group_failures": group_failures,
            "transitions": transitions,
            "paging": {
                "budget_bytes": self.config.page_budget_bytes,
                "resident_bytes": sum(m.resident_bytes()
                                      for m in self.members),
                "resident_device_bytes": sum(m.resident_device_bytes()
                                             for m in self.members),
                "host_bytes": self.cold_host_bytes(),
                "faults": sum(m.page_faults for m in self.members),
                "spills": sum(m.page_spills for m in self.members),
            },
            "requests": {"total": self.requests,
                         "completed": self.completed,
                         "failed": self.failed},
        }
