"""Live graph updates: delta store, immutable snapshots, versioned graphs.

The counterpart of ``caps_tpu/relational/updates.py``: fixed-shape base
structures plus bounded deltas.

* the **base** is an ordinary immutable :class:`ScanGraph` (device
  columns and CSR adjacency on the card — untouched by writes);
* committed writes live in a **delta store**: append-only node/rel
  records materialized as small scan tables through the same table
  factory (so the card gets a small delta CSR next to the base one),
  plus **tombstone masks** — id sets dropped from the base scan on the
  card (``Table.drop_in``: a ``torch.isin`` mask over the padded
  tombstone array);
* every committed write publishes a new immutable
  :class:`GraphSnapshot` — base + delta overlay + version.  Snapshots
  are plan-cacheable and fused-replayable exactly like frozen graphs
  (they ARE frozen); the mutable object is the :class:`VersionedGraph`
  handle, which is deliberately *not* a valid plan-cache anchor
  (``plan_token_unstable``) — readers resolve it to the current
  snapshot at query start and finish on that snapshot no matter how
  many writes commit meanwhile.
* **compaction** folds base + delta into a fresh base snapshot
  (``VersionedGraph.compact``), resetting the tombstone masks and delta
  CSR to empty.

Writes are **failure-atomic**: a commit stages host-side first (pure
validation — any :class:`UpdateError` leaves the graph untouched), then
builds the device-resident delta tables under a string-pool mark, and
only then publishes the new snapshot with one reference swap.  A fault
anywhere mid-apply — a device OOM, an abort between delta columns
(testing/faults.py ``abort_write``) — rolls back completely; a retried
write re-executes against an unchanged graph.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
import weakref
from collections.abc import Mapping as _MappingABC
from typing import (Any, Dict, FrozenSet, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, Union)

from caps_tpu_torch.frontend import ast
from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.obs.lockgraph import make_lock, make_rlock
from caps_tpu_torch.okapi.schema import Schema
from caps_tpu_torch.okapi.types import CTInteger, CypherType, from_python, join_all
from caps_tpu_torch.okapi.values import CypherNode, CypherRelationship
from caps_tpu_torch.relational.entity_tables import (NodeMapping, NodeTable,
                                               RelationshipMapping,
                                               RelationshipTable)
from caps_tpu_torch.relational.graphs import (RelationalCypherGraph, ScanGraph,
                                        align_scan)
from caps_tpu_torch.relational.header import RecordHeader


class UpdateError(ValueError):
    """A write that cannot be applied (unknown entity id, constraint
    violation, unsupported update form).  Raised during host-side
    staging/validation — BEFORE any state changes — so a failed write
    is always a no-op.  Deterministic: retrying cannot change the
    outcome."""


# -- literal evaluation (shared with testing/factory.py) ---------------------

def eval_literal_expr(expr: E.Expr, params: Mapping[str, Any]) -> Any:
    """Evaluate a parameter-and-literal-only expression host-side (the
    CREATE-property subset: literals, $params, lists, maps, negation,
    temporal constructors)."""
    if isinstance(expr, E.Lit):
        return expr.value
    if isinstance(expr, E.Param):
        if expr.name not in params:
            raise UpdateError(f"missing parameter ${expr.name}")
        return params[expr.name]
    if isinstance(expr, E.Negate):
        return -eval_literal_expr(expr.expr, params)
    if isinstance(expr, E.ListLit):
        return [eval_literal_expr(i, params) for i in expr.items]
    if isinstance(expr, E.MapLit):
        return {k: eval_literal_expr(v, params)
                for k, v in zip(expr.keys, expr.values)}
    if isinstance(expr, E.FunctionExpr) \
            and expr.name in ("date", "datetime", "localdatetime",
                              "duration"):
        from caps_tpu_torch.okapi.values import temporal_construct
        try:
            return temporal_construct(
                expr.name, *[eval_literal_expr(a, params)
                             for a in expr.args])
        except (ValueError, TypeError) as ex:
            raise UpdateError(str(ex))
    raise UpdateError(f"expression is not host-evaluable: {expr!r}")


def _is_static(expr: E.Expr) -> bool:
    """True when :func:`eval_literal_expr` can evaluate ``expr`` with
    only the parameter map — no row context needed."""
    if isinstance(expr, (E.Lit, E.Param)):
        return True
    if isinstance(expr, E.Negate):
        return _is_static(expr.expr)
    if isinstance(expr, E.ListLit):
        return all(_is_static(i) for i in expr.items)
    if isinstance(expr, E.MapLit):
        return all(_is_static(v) for v in expr.values)
    if isinstance(expr, E.FunctionExpr) \
            and expr.name in ("date", "datetime", "localdatetime",
                              "duration"):
        return all(_is_static(a) for a in expr.args)
    return False


# -- table building (shared by the delta store, compaction, and the test
#    factory — testing/factory.py delegates here) ----------------------------

def build_node_tables(factory, nodes: Iterable[Tuple[int, Iterable[str],
                                                     Mapping[str, Any]]]
                      ) -> List[NodeTable]:
    """Group ``(id, labels, props)`` records by exact label combination
    and build one :class:`NodeTable` per combo through ``factory``."""
    by_labels: Dict[Tuple[str, ...],
                    List[Tuple[int, Mapping[str, Any]]]] = {}
    for nid, labels, props in nodes:
        by_labels.setdefault(tuple(sorted(labels)), []).append((nid, props))
    out = []
    for labels, rows in sorted(by_labels.items()):
        keys = sorted({k for _, p in rows for k in p})
        types: Dict[str, CypherType] = {"_id": CTInteger}
        data: Dict[str, List[Any]] = {"_id": [nid for nid, _ in rows]}
        for k in keys:
            vals = [p.get(k) for _, p in rows]
            t = join_all(from_python(v) for v in vals if v is not None)
            if any(v is None for v in vals):
                t = t.nullable
            types[k] = t
            data[k] = vals
        mapping = NodeMapping.on("_id").with_implied_labels(*labels)
        for k in keys:
            mapping = mapping.with_property(k)
        out.append(NodeTable(mapping, factory.from_columns(data, types)))
    return out


def build_rel_tables(factory, rels: Iterable[Tuple[int, int, int, str,
                                                   Mapping[str, Any]]]
                     ) -> List[RelationshipTable]:
    """Group ``(id, src, tgt, type, props)`` records by relationship type
    and build one :class:`RelationshipTable` per type."""
    by_type: Dict[str, List[Tuple[int, int, int, Mapping[str, Any]]]] = {}
    for rid, src, tgt, rel_type, props in rels:
        by_type.setdefault(rel_type, []).append((rid, src, tgt, props))
    out = []
    for rel_type, rows in sorted(by_type.items()):
        keys = sorted({k for *_, p in rows for k in p})
        types: Dict[str, CypherType] = {"_id": CTInteger, "_src": CTInteger,
                                        "_tgt": CTInteger}
        data: Dict[str, List[Any]] = {
            "_id": [r[0] for r in rows], "_src": [r[1] for r in rows],
            "_tgt": [r[2] for r in rows]}
        for k in keys:
            vals = [r[3].get(k) for r in rows]
            t = join_all(from_python(v) for v in vals if v is not None)
            if any(v is None for v in vals):
                t = t.nullable
            types[k] = t
            data[k] = vals
        mapping = RelationshipMapping.on(rel_type)
        for k in keys:
            mapping = mapping.with_property(k)
        out.append(RelationshipTable(mapping,
                                     factory.from_columns(data, types)))
    return out


# -- update operations (the programmatic ``graph.apply`` vocabulary) ---------

@dataclasses.dataclass(frozen=True, eq=False)
class CreateNode:
    """Create one node.  ``id=None`` lets the graph allocate a fresh id;
    the instance itself can be used as a :class:`CreateRel` endpoint (or
    a Set/Delete target) within the same ``apply`` batch."""
    labels: Tuple[str, ...] = ()
    properties: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    id: Optional[int] = None


@dataclasses.dataclass(frozen=True, eq=False)
class CreateRel:
    """Create one relationship.  ``src``/``tgt`` accept a node id, a
    materialized :class:`CypherNode`, or a :class:`CreateNode` from the
    same batch."""
    rel_type: str
    src: Any
    tgt: Any
    properties: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    id: Optional[int] = None


@dataclasses.dataclass(frozen=True, eq=False)
class DeleteNode:
    id: Any
    detach: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class DeleteRel:
    id: Any


@dataclasses.dataclass(frozen=True, eq=False)
class SetNodeProps:
    """Merge (default) or replace a node's properties.  A ``None`` value
    removes the key (Cypher ``SET n.k = null`` semantics)."""
    id: Any
    properties: Mapping[str, Any]
    replace: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class SetRelProps:
    id: Any
    properties: Mapping[str, Any]
    replace: bool = False


UpdateOp = Union[CreateNode, CreateRel, DeleteNode, DeleteRel,
                 SetNodeProps, SetRelProps]


@dataclasses.dataclass(frozen=True)
class UpdateResult:
    """What one committed ``apply`` did: the published snapshot version
    and per-kind counts."""
    version: int
    created_nodes: int = 0
    created_rels: int = 0
    deleted_nodes: int = 0
    deleted_rels: int = 0
    props_set: int = 0

    def counts(self) -> Dict[str, int]:
        return {"created_nodes": self.created_nodes,
                "created_rels": self.created_rels,
                "deleted_nodes": self.deleted_nodes,
                "deleted_rels": self.deleted_rels,
                "props_set": self.props_set}


# -- the delta store ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _NodeRec:
    id: int
    labels: Tuple[str, ...]
    props: Tuple[Tuple[str, Any], ...]

    def props_dict(self) -> Dict[str, Any]:
        return dict(self.props)


@dataclasses.dataclass(frozen=True)
class _RelRec:
    id: int
    src: int
    tgt: int
    rel_type: str
    props: Tuple[Tuple[str, Any], ...]

    def props_dict(self) -> Dict[str, Any]:
        return dict(self.props)


@dataclasses.dataclass(frozen=True)
class DeltaState:
    """The host-level truth of everything a snapshot overlays on its
    base: tombstone id sets (base rows masked out on scan) and live
    delta records (appended — including base entities re-emitted with
    merged properties after a SET).  Immutable; commits build a new one
    (O(delta), bounded by compaction)."""
    hidden_nodes: FrozenSet[int] = frozenset()
    hidden_rels: FrozenSet[int] = frozenset()
    nodes: Tuple[_NodeRec, ...] = ()
    rels: Tuple[_RelRec, ...] = ()

    @property
    def delta_rows(self) -> int:
        """Compaction-backlog metric: delta records + tombstones."""
        return (len(self.nodes) + len(self.rels)
                + len(self.hidden_nodes) + len(self.hidden_rels))

    @property
    def empty(self) -> bool:
        return self.delta_rows == 0


_EMPTY_DELTA = DeltaState()


def _props_tuple(props: Mapping[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted((k, v) for k, v in props.items() if v is not None))


# -- delta-state serialization (the replication unit) ------------------------
#
# A committed overlay travels between processes as (delta state,
# version): the owner serializes its current snapshot's overlay, a peer
# rebuilds the same DeltaState and installs it at the OWNER'S version
# (``VersionedGraph.install_state``).  Only the host-level truth travels
# — delta tables and device buffers rebuild locally on the peer.  The
# payload is the JAX package's own format, so a reference process's
# ``delta_state_to_payload`` installs here unchanged.

def delta_state_to_payload(state: DeltaState) -> Dict[str, Any]:
    """JSON-able form of a delta overlay.  Property values must be
    JSON-representable (the update vocabulary's literal subset);
    ordering is canonical so equal states serialize identically."""
    return {
        "hidden_nodes": sorted(state.hidden_nodes),
        "hidden_rels": sorted(state.hidden_rels),
        "nodes": [[r.id, list(r.labels),
                   [[k, v] for k, v in r.props]] for r in state.nodes],
        "rels": [[r.id, r.src, r.tgt, r.rel_type,
                  [[k, v] for k, v in r.props]] for r in state.rels],
    }


def delta_state_from_payload(payload: Mapping[str, Any]) -> DeltaState:
    """The inverse of :func:`delta_state_to_payload`, validated — a
    malformed payload raises :class:`UpdateError` without touching any
    graph."""
    try:
        nodes = tuple(
            _NodeRec(int(nid), tuple(str(lb) for lb in labels),
                     tuple((str(k), v) for k, v in props))
            for nid, labels, props in payload["nodes"])
        rels = tuple(
            _RelRec(int(rid), int(src), int(tgt), str(rel_type),
                    tuple((str(k), v) for k, v in props))
            for rid, src, tgt, rel_type, props in payload["rels"])
        return DeltaState(
            hidden_nodes=frozenset(int(i)
                                   for i in payload["hidden_nodes"]),
            hidden_rels=frozenset(int(i) for i in payload["hidden_rels"]),
            nodes=nodes, rels=rels)
    except (KeyError, TypeError, ValueError) as ex:
        raise UpdateError(f"malformed delta-state payload: "
                          f"{type(ex).__name__}: {ex}")


class _OverlayLookup(_MappingABC):
    """Base entity lookup with hidden ids removed and delta entries
    overlaid — without copying the (potentially huge) base dict per
    snapshot."""

    def __init__(self, base: Mapping, hidden: FrozenSet[int],
                 added: Dict[int, Any]):
        self._base = base
        self._hidden = hidden
        self._added = added

    def __getitem__(self, key):
        if key in self._added:
            return self._added[key]
        if key in self._hidden:
            raise KeyError(key)
        return self._base[key]

    def __contains__(self, key) -> bool:
        if key in self._added:
            return True
        return key not in self._hidden and key in self._base

    def __iter__(self):
        for k in self._base:
            if k not in self._hidden and k not in self._added:
                yield k
        yield from self._added

    def __len__(self) -> int:
        n = sum(1 for k in self._hidden if k in self._base)
        dup = sum(1 for k in self._added
                  if k in self._base and k not in self._hidden)
        return len(self._base) - n - dup + len(self._added)


# -- snapshots ---------------------------------------------------------------

class GraphSnapshot(RelationalCypherGraph):
    """One immutable version of a versioned graph: the base ScanGraph
    plus a delta overlay.  Scans = (base scan minus tombstone mask)
    ∪ (delta scan), aligned to the union schema's header — every
    operator (Scan, Expand, the SpMV count pushdown, var-expand) reads
    through :meth:`scan_node`/:meth:`scan_rel`, so the whole engine is
    delta-aware through this one seam.

    Snapshots are valid plan-cache anchors and fused-replay keys (their
    data never changes); each commit's snapshot gets its own tokens, so
    plans and size memos are keyed *per snapshot version* by
    construction."""

    def __init__(self, session, base: ScanGraph,
                 delta_graph: Optional[ScanGraph], state: DeltaState,
                 snapshot_version: int, handle=None):
        super().__init__(session)
        self.base = base
        self.delta_graph = delta_graph
        self.state = state
        #: monotone logical version of the lineage (0 = the fresh base)
        self.snapshot_version = snapshot_version
        #: handle that published this snapshot (None on replica rebasings)
        self.handle = handle
        # device memo / size-cache identity (same counter as ScanGraph)
        self.version = next(ScanGraph._version_counter)
        schema = base.schema
        if delta_graph is not None:
            schema = schema.union(delta_graph.schema)
        self._schema = schema
        self._node_lookup_cache: Optional[Mapping] = None
        self._rel_lookup_cache: Optional[Mapping] = None
        self._statistics_cache = None

    @property
    def schema(self) -> Schema:
        return self._schema

    def statistics(self):
        """The base sketch refreshed with this snapshot's delta counts
        (relational/stats.py ``fold_delta``) — commits and compactions
        keep the cost model's cardinalities current without a full
        host recompute (the delta is bounded by compaction, so the
        fold's distortion is too)."""
        if self._statistics_cache is None:
            from caps_tpu_torch.relational.stats import fold_delta
            self._statistics_cache = fold_delta(
                self.base.statistics(), self.state,
                version=self.snapshot_version)
        return self._statistics_cache

    # -- lookups (materialization) -------------------------------------

    def node_lookup(self):
        if self._node_lookup_cache is None:
            added = {rec.id: (rec.labels, rec.props_dict())
                     for rec in self.state.nodes}
            self._node_lookup_cache = _OverlayLookup(
                self.base.node_lookup(), self.state.hidden_nodes, added)
        return self._node_lookup_cache

    def rel_lookup(self):
        if self._rel_lookup_cache is None:
            added = {rec.id: (rec.src, rec.tgt, rec.rel_type,
                              rec.props_dict())
                     for rec in self.state.rels}
            self._rel_lookup_cache = _OverlayLookup(
                self.base.rel_lookup(), self.state.hidden_rels, added)
        return self._rel_lookup_cache

    # -- scans (the delta-overlay seam) --------------------------------

    def scan_node(self, var: str, labels: Iterable[str] = ()):
        labels = frozenset(labels)
        header = RecordHeader.for_node(var, self._schema, labels)
        _bh, bt = self.base.scan_node(var, labels)
        if self.state.hidden_nodes:
            # tombstone mask: base rows whose id is in the hidden set
            # drop on-device (padded isin mask — Table.drop_in)
            bt = bt.drop_in(f"{var}__id", self.state.hidden_nodes)
        out = align_scan(header, bt)
        if self.delta_graph is not None:
            _dh, dt = self.delta_graph.scan_node(var, labels)
            out = out.union_all(align_scan(header, dt))
        return header, out

    def scan_rel(self, var: str, rel_types: Iterable[str] = ()):
        rel_types = frozenset(rel_types)
        header = RecordHeader.for_relationship(var, self._schema, rel_types)
        _bh, bt = self.base.scan_rel(var, rel_types)
        if self.state.hidden_rels:
            bt = bt.drop_in(f"{var}__id", self.state.hidden_rels)
        out = align_scan(header, bt)
        if self.delta_graph is not None:
            _dh, dt = self.delta_graph.scan_rel(var, rel_types)
            out = out.union_all(align_scan(header, dt))
        return header, out

    # -- memory accounting (obs/ledger.py) ------------------------------

    def delta_nbytes(self) -> int:
        """Approximate bytes the delta overlay holds resident: the
        appended delta tables plus the tombstone id sets — the memory
        ledger's per-snapshot delta accounting."""
        n = 8 * (len(self.state.hidden_nodes)
                 + len(self.state.hidden_rels))
        if self.delta_graph is not None:
            for et in (tuple(self.delta_graph.node_tables)
                       + tuple(self.delta_graph.rel_tables)):
                try:
                    n += int(et.table.nbytes)
                except Exception:  # pragma: no cover — must not fail
                    pass
        return n

    # -- replication (serve/devices.py) --------------------------------

    def rebase(self, session, base_copy: ScanGraph) -> "GraphSnapshot":
        """This snapshot's overlay re-anchored on another session's copy
        of the base (replica serving): the host-level delta state is
        device-independent, so only the small delta tables rebuild
        through the target session's factory — the base is copied once
        per replica and shared by every snapshot of the lineage."""
        delta = build_delta_graph(session, self.state)
        return GraphSnapshot(session, base_copy, delta, self.state,
                             self.snapshot_version, handle=None)


def build_delta_graph(session, state: DeltaState) -> Optional[ScanGraph]:
    """Materialize a delta state's appended records as a (small)
    ScanGraph through ``session``'s table factory — device placement and
    delta-CSR layout happen here.  None when nothing was appended."""
    if not state.nodes and not state.rels:
        return None
    factory = session.table_factory
    node_tables = build_node_tables(
        factory, [(r.id, r.labels, r.props_dict()) for r in state.nodes])
    rel_tables = build_rel_tables(
        factory,
        [(r.id, r.src, r.tgt, r.rel_type, r.props_dict())
         for r in state.rels])
    return ScanGraph(session, node_tables, rel_tables)


# -- compaction scoping (testing/faults.py flaky_compaction keys off it) -----

_compaction_tls = threading.local()


def in_compaction() -> bool:
    """True on a thread currently folding a compaction (the
    compaction-scoped fault injectors key off this)."""
    return getattr(_compaction_tls, "active", False)


@contextlib.contextmanager
def _compaction_scope():
    prev = getattr(_compaction_tls, "active", False)
    _compaction_tls.active = True
    try:
        yield
    finally:
        _compaction_tls.active = prev


# -- the versioned handle ----------------------------------------------------

_delta_gauge_guard = make_lock("updates._delta_gauge_guard")


def _register_delta_gauge(registry, handle: "VersionedGraph") -> None:
    """``updates.delta_rows`` reports the total compaction backlog across
    every live versioned graph on this registry (weakly referenced — a
    dropped graph falls out of the gauge instead of pinning buffers)."""
    with _delta_gauge_guard:
        live = getattr(registry, "_caps_live_versioned", None)
        if live is None:
            live = registry._caps_live_versioned = weakref.WeakSet()
            registry.gauge("updates.delta_rows",
                           fn=lambda: sum(g.delta_rows() for g in live))
        live.add(handle)


class VersionedGraph(RelationalCypherGraph):
    """The mutable handle of a snapshot lineage.

    Reads against the handle resolve to :meth:`current` — the latest
    committed snapshot — at query start (the session does this), so a
    reader NEVER observes a half-applied write.  Writes (:meth:`apply`, or ``CREATE``/``SET``/``DELETE``
    Cypher through the session) serialize on the commit lock and
    publish a new snapshot atomically.

    The handle itself is not a plan-cache anchor
    (``plan_token_unstable``): a stable token over changing data would
    serve stale plans.  Snapshots carry the tokens instead."""

    #: versioned-handle marker (duck-typed: obs/ledger.py reads it)
    graph_is_versioned = True
    #: relational/plan_cache.py: never anchor a cache entry on the handle
    plan_token_unstable = True

    def __init__(self, session, base: ScanGraph):
        super().__init__(session)
        if not isinstance(base, ScanGraph):
            raise UpdateError(
                f"versioned graphs wrap scan graphs, got "
                f"{type(base).__name__}")
        # Serializes commits AND compaction publication; reentrant so a
        # locked compaction retry can call commit helpers.
        self._lock = make_rlock("updates.VersionedGraph._lock")
        self._current = GraphSnapshot(session, base, None, _EMPTY_DELTA,
                                      snapshot_version=0, handle=self)
        self._next_id = _max_entity_id(base) + 1
        registry = session.metrics_registry
        self._commits = registry.counter("updates.commits")
        self._rolled_back = registry.counter("updates.rolled_back")
        self._created_nodes = registry.counter("updates.created_nodes")
        self._created_rels = registry.counter("updates.created_rels")
        self._deleted_nodes = registry.counter("updates.deleted_nodes")
        self._deleted_rels = registry.counter("updates.deleted_rels")
        self._props_set = registry.counter("updates.props_set")
        self._compaction_runs = registry.counter("compaction.runs")
        self._compaction_conflicts = registry.counter(
            "compaction.conflicts")
        self._compaction_folded = registry.counter(
            "compaction.folded_rows")
        self._compaction_s = registry.histogram("compaction.duration_s")
        #: durability seam: ``pre_publish(new_snap)`` runs under the
        #: commit lock after the new snapshot is BUILT but before it
        #: publishes — a write-ahead log's append-before-acknowledge
        #: point.  A raise rolls the string pool back and aborts the
        #: commit with the graph untouched (same containment as a
        #: device-build failure).
        self.pre_publish = None
        #: ``on_compacted(folded_snap, new_snap)`` runs under the commit
        #: lock right after a compaction publishes — a log's
        #: checkpoint-truncation point; the hook must treat checkpoint
        #: failures as deferrable, never abort the fold.
        self.on_compacted = None
        _register_delta_gauge(registry, self)

    # -- read surface --------------------------------------------------

    def current(self) -> GraphSnapshot:
        """The latest committed snapshot (one reference read — commits
        publish with a single atomic swap)."""
        return self._current

    snapshot = current  # alias

    def delta_rows(self) -> int:
        return self._current.state.delta_rows

    def delta_nbytes(self) -> int:
        """Byte-side compaction backlog of the current snapshot."""
        return self._current.delta_nbytes()

    @property
    def schema(self) -> Schema:
        return self._current.schema

    def scan_node(self, var: str, labels: Iterable[str] = ()):
        return self._current.scan_node(var, labels)

    def scan_rel(self, var: str, rel_types: Iterable[str] = ()):
        return self._current.scan_rel(var, rel_types)

    def node_lookup(self):
        return self._current.node_lookup()

    def rel_lookup(self):
        return self._current.rel_lookup()

    def statistics(self):
        """The CURRENT snapshot's refreshed sketch — commits publish a
        new snapshot, whose fold over the base keeps the cost model's
        cardinalities live across writes."""
        return self._current.statistics()

    # -- write surface -------------------------------------------------

    def apply(self, updates: Sequence[UpdateOp]) -> UpdateResult:
        """Commit a batch of updates atomically: every op applies, or —
        on ANY failure (validation, device placement, injected fault) —
        none do and the string pool rolls back to its pre-commit mark.
        Returns the published version and per-kind counts; readers
        admitted before the commit keep their snapshot."""
        ops = list(updates)
        if not ops:
            return UpdateResult(self._current.snapshot_version)
        with self._lock:
            snap = self._current
            state, counts, next_id = _fold(snap, ops, self._next_id)
            new_snap = self._build_and_publish(snap, state)
            self._next_id = next_id
        self._commits.inc()
        self._created_nodes.inc(counts["created_nodes"])
        self._created_rels.inc(counts["created_rels"])
        self._deleted_nodes.inc(counts["deleted_nodes"])
        self._deleted_rels.inc(counts["deleted_rels"])
        self._props_set.inc(counts["props_set"])
        self._evict_snapshot_plans(snap)
        return UpdateResult(new_snap.snapshot_version, **counts)

    def _build_and_publish(self, snap: GraphSnapshot,
                           state: DeltaState,
                           base: Optional[ScanGraph] = None
                           ) -> GraphSnapshot:
        """Device-build + atomic publish, under the commit lock.  The
        build runs under a string-pool mark: a failure between delta
        columns rolls the pool back and re-raises with the graph
        untouched (the failure-atomicity seam the abort_write fault
        injector exercises)."""
        compaction = base is not None
        pool = getattr(getattr(self._session, "backend", None), "pool",
                       None)
        mark = pool.mark() if pool is not None else None
        try:
            if base is None:
                base = snap.base
                delta_graph = build_delta_graph(self._session, state)
            else:
                delta_graph = None  # compaction: fresh base, empty delta
        except BaseException:
            if pool is not None:
                pool.rollback(mark)
            self._rolled_back.inc()
            raise
        new_snap = GraphSnapshot(self._session, base, delta_graph, state,
                                 snap.snapshot_version + 1, handle=self)
        if not compaction and self.pre_publish is not None:
            # append-before-acknowledge: a failed log append aborts the
            # whole commit here, with the same pool rollback as a
            # device-build failure
            try:
                self.pre_publish(new_snap)
            except BaseException:
                if pool is not None:
                    pool.rollback(mark)
                self._rolled_back.inc()
                raise
        self._current = new_snap
        if compaction and self.on_compacted is not None:
            self.on_compacted(snap, new_snap)
        return new_snap

    def install_state(self, state: DeltaState, version: int,
                      on_install=None) -> GraphSnapshot:
        """Replication seam: adopt an OWNER process's delta state at the
        owner's version — the peer half of snapshot shipping.  The delta
        tables rebuild through THIS session's factory, the new snapshot
        carries
        the owner's ``snapshot_version`` verbatim, and the flip is the
        same single atomic reference swap a local commit publishes
        with, so readers keep snapshot isolation throughout.  Versions
        at or behind the current snapshot are ignored (idempotent
        re-ship, out-of-order delivery); the id allocator advances past
        the shipped entities so a later owner promotion cannot collide.

        ``on_install(new_snap)`` runs UNDER the commit lock, BEFORE the
        reference swap publishes the snapshot (``current()`` is a
        lock-free single read) — the rejoin fencing seam: what it
        records happens-before any reader can be admitted at the new
        version.  It also runs on the
        idempotent early return (re-publishing current state is
        harmless; skipping it would leave a rejoining peer's gauges
        stale forever)."""
        with self._lock:
            snap = self._current
            if version <= snap.snapshot_version:
                if on_install is not None:
                    on_install(snap)
                return snap
            pool = getattr(getattr(self._session, "backend", None),
                           "pool", None)
            mark = pool.mark() if pool is not None else None
            try:
                delta_graph = build_delta_graph(self._session, state)
            except BaseException:
                if pool is not None:
                    pool.rollback(mark)
                self._rolled_back.inc()
                raise
            new_snap = GraphSnapshot(self._session, snap.base, delta_graph,
                                     state, version, handle=self)
            self._retire_superseded_results(version)
            if on_install is not None:
                on_install(new_snap)
            self._current = new_snap
            hi = max((r.id for r in state.nodes + state.rels), default=-1)
            self._next_id = max(self._next_id, hi + 1)
        self._evict_snapshot_plans(snap)
        return new_snap

    def _evict_snapshot_plans(self, old_snap: GraphSnapshot) -> None:
        """Scoped eviction: only plans anchored on the superseded
        snapshot's token drop — an unrelated graph's cached plans (and
        other sessions' caches) are untouched.  Zero catalog fanout."""
        self._retire_superseded_results(self._current.snapshot_version)
        tok = getattr(old_snap, "_plan_token", None)
        if tok is None:
            return  # never anchored a plan: nothing to evict
        cache = getattr(self._session, "plan_cache", None)
        if cache is not None:
            cache.evict_graph(tok)

    def _retire_superseded_results(self, live_version: int) -> None:
        """Result-cache retirement (relational/result_cache.py): drop
        every cached result and intermediate of this lineage whose
        version predates ``live_version`` — a dead version can never be
        read again (readers resolve ``current()`` at admission).  A new
        version never invalidates: its keys are new."""
        rcache = getattr(self._session, "result_cache", None)
        if rcache is not None:
            rcache.retire_superseded(
                getattr(self, "_rescache_scope", None), live_version)

    # -- compaction ----------------------------------------------------

    def compact(self) -> bool:
        """Fold base + delta into a fresh base snapshot (empty delta,
        empty tombstone masks).  Returns False when the delta was
        already empty.  Optimistic: the (slow) re-ingest runs outside
        the commit lock; if a write raced in, one conflict is counted
        and the retry folds while HOLDING the lock (bounded writer
        stall, guaranteed progress)."""
        from caps_tpu_torch.obs import clock
        for attempt in range(2):
            snap = self._current
            if snap.state.empty:
                return False
            t0 = clock.now()
            if attempt == 0:
                with _compaction_scope():
                    base = self._fold_base(snap)
                with self._lock:
                    if self._current is not snap:
                        self._compaction_conflicts.inc()
                        continue
                    self._build_and_publish(snap, _EMPTY_DELTA, base=base)
            else:
                with self._lock, _compaction_scope():
                    snap = self._current
                    if snap.state.empty:
                        return False
                    base = self._fold_base(snap)
                    self._build_and_publish(snap, _EMPTY_DELTA, base=base)
            self._compaction_runs.inc()
            self._compaction_folded.inc(snap.state.delta_rows)
            self._compaction_s.observe(clock.now() - t0)
            self._evict_snapshot_plans(snap)
            return True
        return False  # pragma: no cover — loop always returns

    def _fold_base(self, snap: GraphSnapshot) -> ScanGraph:
        """The snapshot's live entity set as a fresh base, folded on the
        card: per label combination (relationship type) the base table
        minus its tombstoned rows (``drop_in``) followed by the delta's
        table, their columns aligned by property key (``_fold_tables``).
        The reference re-ingests every live entity through Python
        tuples; the tables here hold the same rows in the same order.
        A failed fold rolls the string pool back to the pre-fold mark —
        but ONLY if no write committed meanwhile (checked under the
        commit lock): the optimistic fold runs outside the lock, and
        rolling back past a concurrent commit's interned strings would
        corrupt PUBLISHED data."""
        pool = getattr(getattr(self._session, "backend", None), "pool",
                       None)
        mark = pool.mark() if pool is not None else None
        try:
            delta = snap.delta_graph
            state = snap.state
            node_tables = _fold_tables(
                snap.base.node_tables,
                delta.node_tables if delta is not None else (),
                state.hidden_nodes, lambda nt: tuple(sorted(nt.labels)),
                _node_table)
            rel_tables = _fold_tables(
                snap.base.rel_tables,
                delta.rel_tables if delta is not None else (),
                state.hidden_rels, lambda rt: rt.rel_type, _rel_table)
            return ScanGraph(self._session, node_tables, rel_tables)
        except BaseException:
            if pool is not None:
                with self._lock:
                    if self._current is snap:
                        pool.rollback(mark)
            self._rolled_back.inc()
            raise


# -- compaction on the card ----------------------------------------------------

def _node_table(labels: Tuple[str, ...], props: List[str], table
                ) -> NodeTable:
    mapping = NodeMapping.on("_id").with_implied_labels(*labels)
    for k in props:
        mapping = mapping.with_property(k)
    return NodeTable(mapping, table)


def _rel_table(rel_type: str, props: List[str], table) -> RelationshipTable:
    mapping = RelationshipMapping.on(rel_type)
    for k in props:
        mapping = mapping.with_property(k)
    return RelationshipTable(mapping, table)


def _fold_tables(base_tables, delta_tables, hidden, key_of, make):
    """Base tables minus the ``hidden`` ids, then the delta's tables, one
    table per key (label combination or relationship type).  Each part's
    columns are renamed to the canonical layout (``_id``, ``_src``,
    ``_tgt``, one column per property key, as ``build_node_tables``
    lays them out), a key a part lacks becomes a null column of the
    other parts' type, and the parts are concatenated on the card."""
    groups: Dict[Any, List[Tuple[Any, Any]]] = {}
    for et in base_tables:
        t = et.table
        if hidden:
            t = t.drop_in(et.mapping.id_col, hidden)
        groups.setdefault(key_of(et), []).append((et, t))
    for et in delta_tables:
        groups.setdefault(key_of(et), []).append((et, et.table))
    out = []
    for key, parts in sorted(groups.items()):
        types: Dict[str, CypherType] = {}
        aligned = []
        for et, t in parts:
            m = et.mapping
            rename = {m.id_col: "_id"}
            for k, c in m.property_cols.items():
                rename[c] = k
                types[k] = t.column_type(c).join(types[k]) \
                    if k in types else t.column_type(c)
            if hasattr(m, "source_col"):
                rename[m.source_col] = "_src"
                rename[m.target_col] = "_tgt"
            aligned.append(t.select(list(rename)).rename(rename))
        props = sorted(types)
        tables = []
        for t in aligned:
            for k in props:
                if k not in t.columns:
                    t = t.with_literal_column(k, None, types[k].nullable)
            tables.append(t)
        folded = tables[0]
        for t in tables[1:]:
            folded = folded.union_all(t)
        out.append(make(key, props, folded.select(
            [c for c in aligned[0].columns if c in ("_id", "_src", "_tgt")]
            + props).place()))
    return out


# -- point lookups into the base, on the card ----------------------------------
#
# The reference builds Python dicts over every base entity (the base's
# ``node_lookup`` and ``rel_lookup``, an incidence dict over every
# relationship, a walk over every id for the allocator's start) before
# its first commit.  The answers here come from the id columns' sorted
# indexes on the card (``DeviceTable._id_index``), one binary search and
# one read per lookup: the same answers at any graph size.

def _max_entity_id(base: ScanGraph) -> int:
    hi = -1
    for et in tuple(base.node_tables) + tuple(base.rel_tables):
        v = et.table.max_int(et.mapping.id_col)
        if v is not None and v > hi:
            hi = v
    return hi


class _BaseNodes:
    """``base.node_lookup()``'s answers for the ids a fold asks about:
    ``nid in`` and ``[nid]`` → ``(labels, props)``."""

    def __init__(self, base: ScanGraph):
        self._tables = base.node_tables
        self._seen: Dict[int, Any] = {}

    def _find(self, nid: int):
        if nid not in self._seen:
            found = None
            for nt in self._tables:
                hit = nt.table.rows_where(nt.mapping.id_col, nid)
                if hit.size:
                    props = {k: hit.column_values(c)[0]
                             for k, c in nt.mapping.property_cols.items()}
                    found = (tuple(sorted(nt.labels)),
                             {k: v for k, v in props.items()
                              if v is not None})
            self._seen[nid] = found
        return self._seen[nid]

    def __contains__(self, nid) -> bool:
        return self._find(nid) is not None

    def __getitem__(self, nid):
        found = self._find(nid)
        if found is None:
            raise KeyError(nid)
        return found


class _BaseRels(_BaseNodes):
    """``base.rel_lookup()``'s answers: ``[rid]`` → ``(src, tgt, type,
    props)``."""

    def __init__(self, base: ScanGraph):
        self._tables = base.rel_tables
        self._seen = {}

    def _find(self, rid: int):
        if rid not in self._seen:
            found = None
            for rt in self._tables:
                m = rt.mapping
                hit = rt.table.rows_where(m.id_col, rid)
                if hit.size:
                    props = {k: hit.column_values(c)[0]
                             for k, c in m.property_cols.items()}
                    found = (hit.column_values(m.source_col)[0],
                             hit.column_values(m.target_col)[0],
                             rt.rel_type,
                             {k: v for k, v in props.items()
                              if v is not None})
            self._seen[rid] = found
        return self._seen[rid]


class _BaseIncidence:
    """The reference's ``_base_incidence`` dict's answers (the DETACH
    DELETE / delete-constraint index): ``.get(nid, ())`` → the base
    relationship ids with ``nid`` as an endpoint (a self-loop once)."""

    def __init__(self, base: ScanGraph):
        self._tables = base.rel_tables

    def get(self, nid: int, default=()):
        out: List[int] = []
        for rt in self._tables:
            m = rt.mapping
            out.extend(rt.table.rows_where(m.source_col, nid)
                       .column_values(m.id_col))
            into = rt.table.rows_where(m.target_col, nid)
            out.extend(rid for rid, src in zip(
                into.column_values(m.id_col),
                into.column_values(m.source_col)) if src != nid)
        return out or default


def versioned(session, graph: Optional[ScanGraph] = None) -> VersionedGraph:
    """Wrap a scan graph (or a fresh empty one) in a versioned handle."""
    if graph is None:
        graph = session.create_graph((), ())
    return VersionedGraph(session, graph)


# -- commit folding (host-side, pure) ----------------------------------------

def _fold(snap: GraphSnapshot, ops: Sequence[UpdateOp], next_id: int
          ) -> Tuple[DeltaState, Dict[str, int], int]:
    """Validate + fold a batch of ops over a snapshot's delta state.
    Pure host-side: raises :class:`UpdateError` without touching
    anything; returns (new state, counts, next free id)."""
    state = snap.state
    nodes: Dict[int, List[Any]] = {r.id: [r.labels, r.props_dict()]
                                   for r in state.nodes}
    rels: Dict[int, List[Any]] = {
        r.id: [r.src, r.tgt, r.rel_type, r.props_dict()]
        for r in state.rels}
    hidden_nodes = set(state.hidden_nodes)
    hidden_rels = set(state.hidden_rels)
    base_nodes = _BaseNodes(snap.base)
    base_rels = _BaseRels(snap.base)
    counts = {"created_nodes": 0, "created_rels": 0, "deleted_nodes": 0,
              "deleted_rels": 0, "props_set": 0}
    tmp_ids: Dict[int, int] = {}  # id(CreateNode/CreateRel) -> entity id
    next_free = next_id

    def alloc(explicit: Optional[int] = None) -> int:
        # explicit ids advance the allocator past themselves, or a later
        # auto-allocated create would collide with them
        nonlocal next_free
        if explicit is not None:
            next_free = max(next_free, explicit + 1)
            return explicit
        v = next_free
        next_free += 1
        return v

    def node_live(nid: int) -> bool:
        return nid in nodes or (nid in base_nodes
                                and nid not in hidden_nodes)

    def rel_live(rid: int) -> bool:
        return rid in rels or (rid in base_rels and rid not in hidden_rels)

    def resolve(ref: Any, *, as_node: bool) -> int:
        if isinstance(ref, (CreateNode, CreateRel)):
            # earlier in this batch, or committed by a previous apply
            # (the fold stamps the allocated id back onto the op)
            got = tmp_ids.get(id(ref), ref.id)
            if got is None:
                raise UpdateError(
                    "update references a created entity that is not in "
                    "(or is later in) this batch")
            return got
        if isinstance(ref, CypherNode):
            if not as_node:
                raise UpdateError(f"expected a relationship, got {ref!r}")
            return ref.id
        if isinstance(ref, CypherRelationship):
            if as_node:
                raise UpdateError(f"expected a node, got {ref!r}")
            return ref.id
        if isinstance(ref, bool) or not isinstance(ref, int):
            raise UpdateError(
                f"expected an entity or id, got {type(ref).__name__}")
        return ref

    def live_incident(nid: int) -> List[int]:
        out = [rid for rid, rec in rels.items()
               if rec[0] == nid or rec[1] == nid]
        out.extend(rid for rid in _BaseIncidence(snap.base).get(nid, ())
                   if rid not in hidden_rels)
        return out

    def set_props(rec_props: Dict[str, Any], update: Mapping[str, Any],
                  replace: bool) -> Dict[str, Any]:
        out = {} if replace else dict(rec_props)
        for k, v in update.items():
            if v is None:
                out.pop(k, None)
            else:
                out[k] = v
        return out

    for op in ops:
        if isinstance(op, CreateNode):
            nid = alloc(op.id)
            if node_live(nid):
                raise UpdateError(f"node id {nid} already exists")
            # NOTE: a tombstone on this id (a deleted base row) must
            # STAY — the delta row supersedes it; unmasking the base
            # row would resurrect the deleted entity alongside this one
            nodes[nid] = [tuple(sorted(op.labels)),
                          {k: v for k, v in dict(op.properties).items()
                           if v is not None}]
            tmp_ids[id(op)] = nid
            if op.id is None:
                # stamp the allocation back so a LATER apply batch can
                # keep referencing this op object
                object.__setattr__(op, "id", nid)
            counts["created_nodes"] += 1
        elif isinstance(op, CreateRel):
            src = resolve(op.src, as_node=True)
            tgt = resolve(op.tgt, as_node=True)
            for endpoint in (src, tgt):
                if not node_live(endpoint):
                    raise UpdateError(
                        f"relationship endpoint node {endpoint} does not "
                        f"exist")
            rid = alloc(op.id)
            if rel_live(rid):
                raise UpdateError(f"relationship id {rid} already exists")
            if not op.rel_type:
                raise UpdateError("relationships need a type")
            rels[rid] = [src, tgt, op.rel_type,
                         {k: v for k, v in dict(op.properties).items()
                          if v is not None}]
            tmp_ids[id(op)] = rid
            if op.id is None:
                object.__setattr__(op, "id", rid)
            counts["created_rels"] += 1
        elif isinstance(op, DeleteRel):
            rid = resolve(op.id, as_node=False)
            if rid in rels:
                del rels[rid]
            elif rid in base_rels and rid not in hidden_rels:
                hidden_rels.add(rid)
            else:
                raise UpdateError(f"relationship {rid} does not exist")
            counts["deleted_rels"] += 1
        elif isinstance(op, DeleteNode):
            nid = resolve(op.id, as_node=True)
            if not node_live(nid):
                raise UpdateError(f"node {nid} does not exist")
            incident = live_incident(nid)
            if incident and not op.detach:
                raise UpdateError(
                    f"cannot delete node {nid}: it still has "
                    f"{len(incident)} relationship(s) — use DETACH DELETE")
            for rid in incident:
                if rid in rels:
                    del rels[rid]
                else:
                    hidden_rels.add(rid)
                counts["deleted_rels"] += 1
            if nid in nodes:
                del nodes[nid]
            if nid in base_nodes:
                hidden_nodes.add(nid)
            counts["deleted_nodes"] += 1
        elif isinstance(op, SetNodeProps):
            nid = resolve(op.id, as_node=True)
            if nid in nodes:
                rec = nodes[nid]
                rec[1] = set_props(rec[1], op.properties, op.replace)
            elif nid in base_nodes and nid not in hidden_nodes:
                labels, props = base_nodes[nid]
                hidden_nodes.add(nid)
                nodes[nid] = [tuple(labels),
                              set_props(dict(props), op.properties,
                                        op.replace)]
            else:
                raise UpdateError(f"node {nid} does not exist")
            counts["props_set"] += max(1, len(op.properties))
        elif isinstance(op, SetRelProps):
            rid = resolve(op.id, as_node=False)
            if rid in rels:
                rec = rels[rid]
                rec[3] = set_props(rec[3], op.properties, op.replace)
            elif rid in base_rels and rid not in hidden_rels:
                src, tgt, typ, props = base_rels[rid]
                hidden_rels.add(rid)
                rels[rid] = [src, tgt, typ,
                             set_props(dict(props), op.properties,
                                       op.replace)]
            else:
                raise UpdateError(f"relationship {rid} does not exist")
            counts["props_set"] += max(1, len(op.properties))
        else:
            raise UpdateError(
                f"unknown update operation {type(op).__name__}")

    new_state = DeltaState(
        hidden_nodes=frozenset(hidden_nodes),
        hidden_rels=frozenset(hidden_rels),
        nodes=tuple(_NodeRec(nid, rec[0], _props_tuple(rec[1]))
                    for nid, rec in sorted(nodes.items())),
        rels=tuple(_RelRec(rid, rec[0], rec[1], rec[2],
                           _props_tuple(rec[3]))
                   for rid, rec in sorted(rels.items())))
    return new_state, counts, next_free


# -- Cypher update statements (CREATE / SET / DELETE clauses) ----------------

_UPDATE_CLAUSES = (ast.CreateClause, ast.SetClause, ast.DeleteClause)


def is_update_statement(stmt) -> bool:
    """True when the parsed statement contains update clauses (the
    session routes it through the write path)."""
    if not isinstance(stmt, ast.SingleQuery):
        return False
    return any(isinstance(c, _UPDATE_CLAUSES) for c in stmt.clauses)


def is_update_query(query: str) -> bool:
    """Text-level update detection (memoized parse; unparsable text is
    'not an update' — the execution path reports the real error)."""
    from caps_tpu_torch.frontend.parser import parse_query, query_mode
    try:
        _mode, body = query_mode(query)
        return is_update_statement(parse_query(body))
    except Exception:
        return False


@dataclasses.dataclass(frozen=True)
class _ValueSrc:
    kind: str          # "static" | "col" | "map"
    payload: Any       # expr (static) | projected column alias (col) |
    #                    ((key, _ValueSrc), ...) (map)


@dataclasses.dataclass(frozen=True)
class _EntityRef:
    kind: str          # "row" | "tmp"
    name: str


@dataclasses.dataclass(frozen=True)
class UpdatePlan:
    """One parsed update statement, split into the read query (planned
    and executed through the normal read pipeline, on the writer's
    snapshot) and per-row staging directives."""
    read_ast: Optional[ast.SingleQuery]
    directives: Tuple[Tuple, ...]


def _plan_update_uncached(stmt: ast.SingleQuery) -> UpdatePlan:
    read_clauses: List[ast.Clause] = []
    update_clauses: List[ast.Clause] = []
    seen_update = False
    for c in stmt.clauses:
        if isinstance(c, _UPDATE_CLAUSES):
            seen_update = True
            update_clauses.append(c)
        elif seen_update:
            raise UpdateError(
                f"{type(c).__name__} after an update clause is not "
                f"supported — updates must end the query (read, then "
                f"write)")
        else:
            if isinstance(c, (ast.ReturnClause, ast.ReturnGraphClause,
                              ast.ConstructClause)):
                raise UpdateError(
                    "RETURN/CONSTRUCT cannot precede update clauses")
            read_clauses.append(c)

    projections: List[ast.ReturnItem] = []
    row_vars: List[str] = []
    tmp_vars: set = set()
    directives: List[Tuple] = []
    anon = itertools.count()

    def value_src(expr: E.Expr) -> _ValueSrc:
        if _is_static(expr):
            return _ValueSrc("static", expr)
        if isinstance(expr, E.MapLit):
            # a map of row values projects each value as its own column
            # and assembles the map at staging: the device has no map
            # columns (the reference projects the map whole and
            # evaluates it on its host fallback)
            return _ValueSrc("map", tuple(
                (k, value_src(v)) for k, v in zip(expr.keys, expr.values)))
        alias = f"__upd{len(projections)}"
        projections.append(ast.ReturnItem(expr, alias))
        return _ValueSrc("col", alias)

    def props_src(properties: Optional[E.Expr]) -> _ValueSrc:
        if properties is None:
            return _ValueSrc("static", E.MapLit((), ()))
        return value_src(properties)

    def entity_ref(name: str) -> _EntityRef:
        if name in tmp_vars:
            return _EntityRef("tmp", name)
        if name not in row_vars:
            row_vars.append(name)
        return _EntityRef("row", name)

    for clause in update_clauses:
        if isinstance(clause, ast.CreateClause):
            for part in clause.pattern.parts:
                prev_ref: Optional[_EntityRef] = None
                pending: Optional[ast.RelPattern] = None
                for el in part.elements:
                    if isinstance(el, ast.NodePattern):
                        declares = bool(el.labels) or el.properties is not None
                        if el.var is not None and el.var in tmp_vars:
                            if declares:
                                raise UpdateError(
                                    f"variable `{el.var}` already created; "
                                    f"reference it without labels/"
                                    f"properties")
                            ref = _EntityRef("tmp", el.var)
                        elif el.var is None or declares:
                            name = el.var or f"__anon{next(anon)}"
                            if name in tmp_vars:
                                raise UpdateError(
                                    f"variable `{name}` created twice")
                            tmp_vars.add(name)
                            directives.append(
                                ("create_node", name,
                                 tuple(sorted(el.labels)),
                                 props_src(el.properties)))
                            ref = _EntityRef("tmp", name)
                        else:
                            ref = entity_ref(el.var)
                        if pending is not None:
                            rel = pending
                            if len(rel.rel_types) != 1:
                                raise UpdateError(
                                    "CREATE relationships need exactly "
                                    "one type")
                            if rel.direction == ast.Direction.INCOMING:
                                src_ref, tgt_ref = ref, prev_ref
                            elif rel.direction == ast.Direction.OUTGOING:
                                src_ref, tgt_ref = prev_ref, ref
                            else:
                                raise UpdateError(
                                    "CREATE relationships must be "
                                    "directed")
                            rel_name = (rel.var
                                        or f"__anon{next(anon)}")
                            if rel_name in tmp_vars:
                                raise UpdateError(
                                    f"variable `{rel_name}` created twice")
                            tmp_vars.add(rel_name)
                            directives.append(
                                ("create_rel", rel_name,
                                 rel.rel_types[0], src_ref, tgt_ref,
                                 props_src(rel.properties)))
                            pending = None
                        prev_ref = ref
                    else:
                        pending = el
        elif isinstance(clause, ast.SetClause):
            for item in clause.items:
                if item.labels:
                    raise UpdateError("SET :Label is not supported")
                ref = entity_ref(item.var)
                if item.key is not None:
                    directives.append(
                        ("set", ref, item.key, False,
                         value_src(item.value)))
                else:
                    # SET n = map (replace) / SET n += map (merge)
                    directives.append(
                        ("set", ref, None, not item.merge,
                         value_src(item.value)))
        elif isinstance(clause, ast.DeleteClause):
            for expr in clause.exprs:
                if isinstance(expr, E.Var) and expr.name in tmp_vars:
                    directives.append(("delete", _EntityRef("tmp",
                                                            expr.name),
                                       clause.detach))
                elif isinstance(expr, E.Var):
                    directives.append(("delete", entity_ref(expr.name),
                                       clause.detach))
                else:
                    src = value_src(expr)
                    directives.append(("delete", src, clause.detach))

    read_ast: Optional[ast.SingleQuery] = None
    if read_clauses:
        items = tuple(ast.ReturnItem(E.Var(v), v) for v in row_vars) \
            + tuple(projections)
        if not items:
            # no bindings consumed: still need the row COUNT (CREATE
            # per matched row is Cypher semantics)
            items = (ast.ReturnItem(E.Lit(1), "__rows"),)
        read_ast = ast.SingleQuery(
            tuple(read_clauses)
            + (ast.ReturnClause(ast.ProjectionBody(items=items)),))
    elif row_vars or projections:
        missing = row_vars or [p.alias for p in projections]
        raise UpdateError(
            f"update references unbound variable(s) {missing} and has "
            f"no reading clauses")
    return UpdatePlan(read_ast, tuple(directives))


@functools.lru_cache(maxsize=256)
def _plan_update_memo(stmt) -> UpdatePlan:
    return _plan_update_uncached(stmt)


def plan_update(stmt: ast.SingleQuery) -> UpdatePlan:
    """Split + compile one update statement (memoized per parsed AST —
    the parse memo interns statements per query text)."""
    try:
        return _plan_update_memo(stmt)
    except TypeError:  # unhashable AST (should not happen — frozen tree)
        return _plan_update_uncached(stmt)


def stage_rows(plan: UpdatePlan, rows: List[Mapping[str, Any]],
               params: Mapping[str, Any]) -> List[UpdateOp]:
    """Expand the plan's directives over the read query's result rows
    into concrete update ops (Cypher semantics: CREATE per row, SET/
    DELETE per row binding)."""

    def resolve_value(src: _ValueSrc, row: Mapping[str, Any]) -> Any:
        if src.kind == "static":
            return eval_literal_expr(src.payload, params)
        if src.kind == "map":
            return {k: resolve_value(v, row) for k, v in src.payload}
        return row[src.payload]

    def resolve_props(src: _ValueSrc, row: Mapping[str, Any]
                      ) -> Dict[str, Any]:
        v = resolve_value(src, row)
        if v is None:
            return {}
        if not isinstance(v, dict):
            raise UpdateError(f"properties must be a map, got "
                              f"{type(v).__name__}")
        return dict(v)

    out: List[UpdateOp] = []
    for row in rows:
        tmp: Dict[str, UpdateOp] = {}

        def entity(ref: Any, row=row, tmp=tmp) -> Any:
            if isinstance(ref, _EntityRef):
                if ref.kind == "tmp":
                    return tmp[ref.name]
                if ref.name not in row:
                    raise UpdateError(
                        f"variable `{ref.name}` is not bound by the "
                        f"reading clauses")
                return row[ref.name]
            return resolve_value(ref, row)  # projected DELETE expression

        for d in plan.directives:
            kind = d[0]
            if kind == "create_node":
                _, name, labels, props = d
                op = CreateNode(labels=labels,
                                properties=resolve_props(props, row))
                tmp[name] = op
                out.append(op)
            elif kind == "create_rel":
                _, name, rel_type, src_ref, tgt_ref, props = d
                op = CreateRel(rel_type, entity(src_ref),
                               entity(tgt_ref),
                               properties=resolve_props(props, row))
                tmp[name] = op
                out.append(op)
            elif kind == "set":
                _, ref, key, replace, value = d
                target = entity(ref)
                if target is None:
                    continue  # SET on a null binding: no-op
                if key is not None:
                    props: Mapping[str, Any] = \
                        {key: resolve_value(value, row)}
                    # a single-key SET of null still reaches the fold
                    # (it REMOVES the property)
                else:
                    props = resolve_props(value, row)
                if isinstance(target, (CypherRelationship,)):
                    out.append(SetRelProps(target, props, replace=replace))
                elif isinstance(target, (CreateRel,)):
                    out.append(SetRelProps(target, props, replace=replace))
                else:
                    out.append(SetNodeProps(target, props,
                                            replace=replace))
            elif kind == "delete":
                _, ref, detach = d
                target = entity(ref)
                if target is None:
                    continue  # DELETE null is a no-op (Cypher)
                if isinstance(target, (CypherRelationship,)):
                    out.append(DeleteRel(target))
                elif isinstance(target, CreateRel):
                    out.append(DeleteRel(target))
                else:
                    out.append(DeleteNode(target, detach=detach))
            else:  # pragma: no cover — directive vocabulary is closed
                raise UpdateError(f"unknown directive {kind!r}")
    return out


def describe_plan(plan: UpdatePlan) -> str:
    """EXPLAIN rendering of an update statement's write half."""
    lines = []
    for d in plan.directives:
        if d[0] == "create_node":
            lines.append(f"CreateNode({d[1]}{':' if d[2] else ''}"
                         f"{':'.join(d[2])})")
        elif d[0] == "create_rel":
            lines.append(f"CreateRel({d[1]}:{d[2]} "
                         f"{d[3].name}->{d[4].name})")
        elif d[0] == "set":
            tgt = d[1].name if isinstance(d[1], _EntityRef) else "?"
            lines.append(f"SetProps({tgt}"
                         + (f".{d[2]}" if d[2] else "")
                         + (" replace" if d[3] else "") + ")")
        elif d[0] == "delete":
            tgt = d[1].name if isinstance(d[1], _EntityRef) else "<expr>"
            lines.append(("DetachDelete(" if d[2] else "Delete(")
                         + tgt + ")")
    return "\n".join(lines) if lines else "(no updates)"
