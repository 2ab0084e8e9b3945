"""Relational property graphs over scan tables.

Mirrors the reference's ``ScanGraph`` (per-entity-type scans; scans align
and union entity tables), ``UnionGraph`` and ``EmptyGraph`` (ref:
okapi-relational/.../impl/graph/ — reconstructed, mount empty; SURVEY.md
§2 "Relational graphs", §3.3).
"""
from __future__ import annotations

import itertools
from typing import Any, FrozenSet, Iterable, List, Mapping, Optional, Tuple

from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.okapi.graph import PropertyGraph
from caps_tpu_torch.okapi.schema import Schema
from caps_tpu_torch.okapi.types import (
    CTBoolean, CTString, CypherType,
)
from caps_tpu_torch.relational.entity_tables import NodeTable, RelationshipTable
from caps_tpu_torch.relational.header import RecordHeader
from caps_tpu_torch.relational.table import Table, TableFactory


class RelationalCypherGraph(PropertyGraph):
    """Backend-generic graph: can produce aligned scan tables."""

    def __init__(self, session):
        self._session = session

    @property
    def session(self):
        return self._session

    @property
    def factory(self) -> TableFactory:
        return self._session.table_factory

    # -- scans ---------------------------------------------------------------

    def scan_node(self, var: str, labels: Iterable[str] = ()
                  ) -> Tuple[RecordHeader, Table]:
        raise NotImplementedError

    def scan_rel(self, var: str, rel_types: Iterable[str] = ()
                 ) -> Tuple[RecordHeader, Table]:
        raise NotImplementedError

    # -- PropertyGraph API ---------------------------------------------------

    def cypher(self, query: str, parameters: Optional[Mapping[str, Any]] = None):
        return self._session.cypher_on_graph(self, query, parameters)

    def prepare(self, query: str):
        """Prepared statement bound to this graph: parse once, then
        ``.run(params)`` serves the plan from the session plan cache."""
        return self._session.prepare(query, graph=self)

    def nodes(self, var: str = "n", labels: Iterable[str] = ()):
        header, table = self.scan_node(var, labels)
        return self._session.records_from(header, table, (var,))

    def relationships(self, var: str = "r", rel_types: Iterable[str] = ()):
        header, table = self.scan_rel(var, rel_types)
        return self._session.records_from(header, table, (var,))

    def union_all(self, *others: "RelationalCypherGraph") -> "UnionGraph":
        graphs: List[RelationalCypherGraph] = [self]
        for o in others:
            graphs.extend(o.graphs if isinstance(o, UnionGraph) else [o])
        return UnionGraph(self._session, tuple(graphs))

    def rel_lookup(self):
        """Host-side map rel-id -> (src, tgt, type, props), used to
        materialize variable-length relationship lists."""
        return {}

    def node_lookup(self):
        """Host-side map node-id -> (labels, props), used to materialize
        path values and node lists."""
        return {}

    def statistics(self):
        """Ingest-time statistics sketch (relational/stats.py) — the
        cost model's prior.  Graphs without scan tables report the
        empty sketch; ScanGraph computes lazily and caches."""
        from caps_tpu_torch.relational.stats import EMPTY_STATS
        return EMPTY_STATS


def _align_node_scan(nt: NodeTable, header: RecordHeader, var: str,
                     all_labels: Iterable[str]) -> Table:
    """Rename/extend one node table to the target scan header layout."""
    t = nt.table
    m = nt.mapping
    keep = [m.id_col] + list(m.property_cols.values())
    t = t.select(keep)
    rename = {m.id_col: f"{var}__id"}
    for key, col in m.property_cols.items():
        rename[col] = f"{var}__prop_{key}"
    t = t.rename(rename)
    for lbl in all_labels:
        t = t.with_literal_column(f"{var}__label_{lbl}", lbl in nt.labels,
                                  CTBoolean)
    for e in header.exprs:
        col = header.column(e)
        if col not in t.columns:
            t = t.with_literal_column(col, None, header.type_of(e))
    return t.select(list(header.columns))


def _align_rel_scan(rt: RelationshipTable, header: RecordHeader, var: str) -> Table:
    t = rt.table
    m = rt.mapping
    keep = [m.id_col, m.source_col, m.target_col] + list(m.property_cols.values())
    t = t.select(keep)
    rename = {m.id_col: f"{var}__id", m.source_col: f"{var}__src",
              m.target_col: f"{var}__tgt"}
    for key, col in m.property_cols.items():
        rename[col] = f"{var}__prop_{key}"
    t = t.rename(rename)
    t = t.with_literal_column(f"{var}__type", rt.rel_type, CTString)
    for e in header.exprs:
        col = header.column(e)
        if col not in t.columns:
            t = t.with_literal_column(col, None, header.type_of(e))
    return t.select(list(header.columns))


def align_scan(header: RecordHeader, t: Table) -> Table:
    """Align a sub-scan to a wider union header: missing label columns
    become False (the label is not possible in that part), other missing
    columns null — the UnionGraph technique, shared with the versioned
    snapshot overlay (relational/updates.py)."""
    for e in header.exprs:
        col = header.column(e)
        if col not in t.columns:
            default = False if isinstance(e, E.HasLabel) else None
            t = t.with_literal_column(col, default, header.type_of(e))
    return t.select(list(header.columns))


class ScanGraph(RelationalCypherGraph):
    """A graph stored as one table per label-combination / relationship type."""

    _version_counter = itertools.count(1)

    def __init__(self, session, node_tables: Iterable[NodeTable] = (),
                 rel_tables: Iterable[RelationshipTable] = ()):
        super().__init__(session)
        # Monotone graph identity
        self.version = next(ScanGraph._version_counter)
        self.node_tables: Tuple[NodeTable, ...] = tuple(node_tables)
        self.rel_tables: Tuple[RelationshipTable, ...] = tuple(rel_tables)
        for rt in self.rel_tables:
            # ingest-time physical layout (CSR adjacency on the device)
            self.factory.prepare_rel_table(rt)
        schema = Schema.empty()
        for nt in self.node_tables:
            schema = schema.union(nt.schema())
        for rt in self.rel_tables:
            schema = schema.union(rt.schema())
        self._schema = schema
        self._rel_lookup_cache = None
        self._node_lookup_cache = None
        self._statistics_cache = None

    @property
    def schema(self) -> Schema:
        return self._schema

    def statistics(self):
        """Lazily computed, cached ingest-time sketch: per-label
        cardinalities, degree distributions, hot-key skew
        (relational/stats.py) — the cost model's prior.  One pass at
        first use; a ``stats.computed`` counter records it."""
        if self._statistics_cache is None:
            from caps_tpu_torch.relational.stats import (
                compute_graph_statistics,
            )
            self._statistics_cache = compute_graph_statistics(self)
            registry = getattr(self._session, "metrics_registry", None)
            if registry is not None:
                registry.counter("stats.computed").inc()
        return self._statistics_cache

    def seed_statistics(self, payload) -> bool:
        """Adopt a persisted statistics sketch (``to_payload`` form) as
        this graph's prior, so the first plans price from it without the
        recompute.  Only lands when nothing has been computed yet (a
        live sketch always wins), and stays advisory: a stale seed
        mis-prices a plan at worst, and calibration from ``op_stats``
        actuals plus the divergence → re-plan loop correct that case."""
        if self._statistics_cache is not None:
            return False
        from caps_tpu_torch.relational.stats import GraphStatistics
        try:
            stats = GraphStatistics.from_payload(payload)
        except Exception:  # malformed payload — a hint, not an authority
            return False
        if stats is None or not stats.total_nodes:
            return False
        self._statistics_cache = stats
        registry = getattr(self._session, "metrics_registry", None)
        if registry is not None:
            registry.counter("stats.seeded").inc()
        return True

    def node_lookup(self):
        if self._node_lookup_cache is None:
            out = {}
            for nt in self.node_tables:
                m = nt.mapping
                t = nt.table
                ids = t.column_values(m.id_col)
                props = {key: t.column_values(col)
                         for key, col in m.property_cols.items()}
                labels = tuple(sorted(nt.labels))
                for i, nid in enumerate(ids):
                    p = {k: v[i] for k, v in props.items() if v[i] is not None}
                    out[nid] = (labels, p)
            self._node_lookup_cache = out
        return self._node_lookup_cache

    def rel_lookup(self):
        if self._rel_lookup_cache is None:
            out = {}
            for rt in self.rel_tables:
                m = rt.mapping
                t = rt.table
                ids = t.column_values(m.id_col)
                srcs = t.column_values(m.source_col)
                tgts = t.column_values(m.target_col)
                props = {key: t.column_values(col)
                         for key, col in m.property_cols.items()}
                for i, rid in enumerate(ids):
                    p = {k: v[i] for k, v in props.items() if v[i] is not None}
                    out[rid] = (srcs[i], tgts[i], rt.rel_type, p)
            self._rel_lookup_cache = out
        return self._rel_lookup_cache

    def scan_node(self, var: str, labels: Iterable[str] = ()
                  ) -> Tuple[RecordHeader, Table]:
        labels = frozenset(labels)
        header = RecordHeader.for_node(var, self._schema, labels)
        combos = set(self._schema.combinations_for(labels))
        all_labels = sorted({lbl for c in combos for lbl in c})
        parts = [
            _align_node_scan(nt, header, var, all_labels)
            for nt in self.node_tables if nt.labels in combos
        ]
        if not parts:
            return header, self.factory.empty(
                header.columns,
                {header.column(e): header.type_of(e) for e in header.exprs})
        out = parts[0]
        for p in parts[1:]:
            out = out.union_all(p)
        return header, out

    def scan_rel(self, var: str, rel_types: Iterable[str] = ()
                 ) -> Tuple[RecordHeader, Table]:
        rel_types = frozenset(rel_types)
        header = RecordHeader.for_relationship(var, self._schema, rel_types)
        wanted = rel_types or self._schema.relationship_types
        parts = [
            _align_rel_scan(rt, header, var)
            for rt in self.rel_tables if rt.rel_type in wanted
        ]
        if not parts:
            return header, self.factory.empty(
                header.columns,
                {header.column(e): header.type_of(e) for e in header.exprs})
        out = parts[0]
        for p in parts[1:]:
            out = out.union_all(p)
        return header, out


class EmptyGraph(RelationalCypherGraph):
    @property
    def schema(self) -> Schema:
        return Schema.empty()

    def scan_node(self, var, labels=()):
        header = RecordHeader.for_node(var, Schema.empty(), frozenset(labels))
        return header, self.factory.empty(header.columns, {})

    def scan_rel(self, var, rel_types=()):
        header = RecordHeader.for_relationship(var, Schema.empty(),
                                               frozenset(rel_types))
        cols = {header.column(e): header.type_of(e) for e in header.exprs}
        return header, self.factory.empty(header.columns, cols)


class UnionGraph(RelationalCypherGraph):
    """The union of several graphs (the reference's ``UnionGraph``).  Node
    and relationship ids must come from disjoint id spaces (the construct
    planner guarantees this by retagging)."""

    def __init__(self, session, graphs: Tuple[RelationalCypherGraph, ...]):
        super().__init__(session)
        self.graphs = graphs
        schema = Schema.empty()
        for g in graphs:
            schema = schema.union(g.schema)
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def rel_lookup(self):
        out = {}
        for g in self.graphs:
            out.update(g.rel_lookup())
        return out

    def node_lookup(self):
        out = {}
        for g in self.graphs:
            out.update(g.node_lookup())
        return out

    def _union_scans(self, header: RecordHeader,
                     scans: List[Tuple[RecordHeader, Table]]) -> Table:
        parts = [align_scan(header, t) for _sub_header, t in scans]
        out = parts[0]
        for p in parts[1:]:
            out = out.union_all(p)
        return out

    def scan_node(self, var: str, labels: Iterable[str] = ()):
        header = RecordHeader.for_node(var, self._schema, frozenset(labels))
        scans = [g.scan_node(var, labels) for g in self.graphs]
        return header, self._union_scans(header, scans)

    def scan_rel(self, var: str, rel_types: Iterable[str] = ()):
        header = RecordHeader.for_relationship(var, self._schema,
                                               frozenset(rel_types))
        scans = [g.scan_rel(var, rel_types) for g in self.graphs]
        return header, self._union_scans(header, scans)
