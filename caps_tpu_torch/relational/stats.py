"""Ingest-time graph statistics: cardinalities, degree sketches, skew.

The observed-statistics store (obs/telemetry.py) answers "what did this
plan family actually do"; this module answers "what does the GRAPH look
like" — the prior a cost model needs BEFORE a family has history.  Per
label combination and relationship type it computes, host-side at graph
construction (lazily, cached per graph object):

* **cardinalities** — rows per node label combination and per
  relationship type (the reference engine had none of this: Spark-CAPS
  planned Catalyst-blind, SURVEY.md §2);
* **degree-distribution sketches** — per rel type and direction the
  mean/p90/max out- and in-degree over distinct endpoints, the
  Zipf-tail signal a join-order choice needs (JSPIM, PAPERS.md);
* **hot-key skew sketches** — the top heavy-hitter endpoint ids and the
  max/mean skew factor, the planned analog of the runtime hot-key
  sample ``backends/tpu/table.py _detect_hot_keys`` draws reactively;
* **per-property distinct counts** (bounded) — equality-predicate
  selectivities (``WHERE a.name = $seed`` estimates actual duplicate
  counts instead of a magic constant).

Snapshots fold their delta counts over the base's sketch
(:func:`fold_delta`) so live writes refresh the statistics without a
full recompute; compaction re-bases and the next snapshot recomputes
from the folded base.  ``to_payload``/``from_payload`` round-trip plain
JSON so the persistent plan store (relational/plan_store.py) can carry
the sketch across processes.

Everything here is advisory: a wrong statistic mis-prices a plan, it
can never shape results — and the divergence feedback loop
(relational/cost.py + obs/telemetry.py) detects exactly that case.

The counterpart of ``caps_tpu/relational/stats.py``.  One difference:
the per-property distinct counts come from the device columns
(``DeviceTable.distinct_counts``: a sort and a count of value changes
per column, one device-to-host read per node table) instead of a Python
``set`` over every row's host value.  The counts are the set's: nulls
are left out, ``-0.0`` and ``0.0`` count once, every NaN row counts on
its own (a set keeps NaN objects apart), strings count by their interned
code, and list columns get no count (a list is unhashable, so the
reference skips them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, Iterable, List, Mapping, Optional, Tuple

import numpy as np

#: distinct-count computation is skipped above this many rows — the
#: sketch must stay an ingest-time blip, never an ingest-time phase
_MAX_DISTINCT_ROWS = 2_000_000

#: heavy hitters retained per degree sketch
_HOT_KEYS = 8

#: a key is "hot" when its degree exceeds this multiple of the mean
#: (matches the runtime detector's spirit — okapi/config.py
#: ``join_hot_factor`` is the serving-side knob)
_HOT_FACTOR = 4.0


@dataclasses.dataclass(frozen=True)
class DegreeSketch:
    """Degree distribution over one endpoint role of one rel type."""
    rows: int = 0
    distinct: int = 0
    mean: float = 0.0
    p90: float = 0.0
    max: int = 0
    #: ((endpoint id, degree), ...) heavy hitters, heaviest first
    hot_keys: Tuple[Tuple[int, int], ...] = ()

    @property
    def skew(self) -> float:
        """max/mean degree — 1.0 is perfectly uniform."""
        return (self.max / self.mean) if self.mean > 0 else 1.0

    def to_payload(self) -> Dict[str, Any]:
        return {"rows": self.rows, "distinct": self.distinct,
                "mean": self.mean, "p90": self.p90, "max": self.max,
                "hot_keys": [list(h) for h in self.hot_keys]}

    @staticmethod
    def from_payload(p: Mapping[str, Any]) -> "DegreeSketch":
        return DegreeSketch(
            rows=int(p.get("rows") or 0),
            distinct=int(p.get("distinct") or 0),
            mean=float(p.get("mean") or 0.0),
            p90=float(p.get("p90") or 0.0),
            max=int(p.get("max") or 0),
            hot_keys=tuple((int(k), int(c))
                           for k, c in (p.get("hot_keys") or ())))


def _sketch(keys: np.ndarray) -> DegreeSketch:
    """Degree sketch of one endpoint-id array."""
    rows = int(keys.shape[0])
    if rows == 0:
        return DegreeSketch()
    vals, counts = np.unique(keys, return_counts=True)
    mean = rows / vals.shape[0]
    hot_mask = counts > _HOT_FACTOR * mean
    order = np.argsort(counts[hot_mask])[::-1][:_HOT_KEYS]
    hot = tuple((int(vals[hot_mask][i]), int(counts[hot_mask][i]))
                for i in order)
    return DegreeSketch(rows=rows, distinct=int(vals.shape[0]),
                        mean=float(mean),
                        p90=float(np.percentile(counts, 90)),
                        max=int(counts.max()), hot_keys=hot)


@dataclasses.dataclass(frozen=True)
class RelStats:
    """One relationship type's cardinality + both degree sketches."""
    rel_type: str
    rows: int
    out: DegreeSketch = DegreeSketch()
    inn: DegreeSketch = DegreeSketch()

    def to_payload(self) -> Dict[str, Any]:
        return {"rel_type": self.rel_type, "rows": self.rows,
                "out": self.out.to_payload(), "in": self.inn.to_payload()}

    @staticmethod
    def from_payload(p: Mapping[str, Any]) -> "RelStats":
        return RelStats(str(p.get("rel_type") or ""),
                        int(p.get("rows") or 0),
                        DegreeSketch.from_payload(p.get("out") or {}),
                        DegreeSketch.from_payload(p.get("in") or {}))


class GraphStatistics:
    """The queryable sketch: cardinality / degree / skew / distinct-count
    lookups the cost model (relational/cost.py) prices plans with."""

    def __init__(self,
                 node_combos: Mapping[FrozenSet[str], int],
                 rels: Mapping[str, RelStats],
                 property_distinct: Optional[Mapping[Tuple[FrozenSet[str],
                                                           str], int]] = None,
                 version: int = 0):
        self.node_combos: Dict[FrozenSet[str], int] = {
            frozenset(k): int(v) for k, v in node_combos.items()}
        self.rels: Dict[str, RelStats] = dict(rels)
        self.property_distinct: Dict[Tuple[FrozenSet[str], str], int] = {
            (frozenset(k), p): int(v)
            for (k, p), v in (property_distinct or {}).items()}
        #: snapshot version the sketch describes (0 = a fresh base)
        self.version = int(version)

    # -- lookups --------------------------------------------------------

    @property
    def total_nodes(self) -> int:
        return sum(self.node_combos.values())

    @property
    def total_rels(self) -> int:
        return sum(r.rows for r in self.rels.values())

    def node_cardinality(self, labels: Iterable[str] = ()) -> int:
        """Rows a node scan with these labels sees (label combinations
        that contain every requested label)."""
        want = frozenset(labels)
        return sum(n for combo, n in self.node_combos.items()
                   if want <= combo)

    def label_fraction(self, labels: Iterable[str] = ()) -> float:
        """Fraction of all nodes a label set selects (1.0 unlabeled)."""
        total = self.total_nodes
        if not frozenset(labels) or total <= 0:
            return 1.0
        return min(1.0, self.node_cardinality(labels) / total)

    def rel_cardinality(self, rel_types: Iterable[str] = ()) -> int:
        want = frozenset(rel_types)
        if not want:
            return self.total_rels
        return sum(r.rows for t, r in self.rels.items() if t in want)

    def degree_per_node(self, rel_types: Iterable[str] = (),
                        outgoing: bool = True) -> float:
        """Expected matching edges per FRONTIER node in one direction.

        Containment assumption (System R): a frontier that reached an
        Expand through the pattern's structural constraints is drawn
        from the direction's endpoint domain, so the expansion factor
        is the per-direction sketch mean — edges divided by DISTINCT
        endpoints on that side.  This is what makes the two
        orientations of a chain price differently on asymmetric edges
        (1M edges out of 10 hubs: ~100k per frontier node walking out
        of the hub side, ~1 walking out of the wide side); the
        direction-blind edges/total-nodes average prices both walks
        identically.  Falls back to edges/total when a sketch carries
        no distinct count (empty or folded-away domain)."""
        total = self.total_nodes
        if total <= 0:
            return 0.0
        want = frozenset(rel_types)
        rows = 0
        distinct = 0
        for t, r in self.rels.items():
            if want and t not in want:
                continue
            rows += r.rows
            distinct += (r.out if outgoing else r.inn).distinct
        if rows <= 0:
            return 0.0
        if distinct <= 0:
            return rows / total
        return rows / min(max(distinct, 1), max(total, 1))

    def skew(self, rel_types: Iterable[str] = (),
             outgoing: bool = True) -> float:
        """Worst max/mean degree skew across the matching types."""
        want = frozenset(rel_types)
        out = 1.0
        for t, r in self.rels.items():
            if want and t not in want:
                continue
            sk = (r.out if outgoing else r.inn).skew
            out = max(out, sk)
        return out

    def hot_keys(self, rel_types: Iterable[str] = (),
                 outgoing: bool = True) -> Tuple[Tuple[int, int], ...]:
        want = frozenset(rel_types)
        hits: List[Tuple[int, int]] = []
        for t, r in self.rels.items():
            if want and t not in want:
                continue
            hits.extend((r.out if outgoing else r.inn).hot_keys)
        return tuple(sorted(hits, key=lambda kv: -kv[1])[:_HOT_KEYS])

    def eq_distinct(self, labels: Iterable[str],
                    prop: str) -> Optional[int]:
        """Distinct values of a property over the label set, or None
        when the sketch has no count (too big at ingest / never seen)."""
        want = frozenset(labels)
        total = 0
        seen = False
        for (combo, p), n in self.property_distinct.items():
            if p == prop and (not want or want <= combo):
                total += n
                seen = True
        return total if seen else None

    def summary(self) -> Dict[str, Any]:
        return {
            "nodes": self.total_nodes,
            "rels": self.total_rels,
            "label_combos": len(self.node_combos),
            "rel_types": sorted(self.rels),
            "max_skew": max([r.out.skew for r in self.rels.values()]
                            + [1.0]),
            "version": self.version,
        }

    # -- persistence (plan_store.py payload section) --------------------

    def to_payload(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "node_combos": [[sorted(k), v]
                            for k, v in sorted(self.node_combos.items(),
                                               key=lambda kv: sorted(kv[0]))],
            "rels": {t: r.to_payload() for t, r in self.rels.items()},
            "property_distinct": [[sorted(k), p, v]
                                  for (k, p), v
                                  in sorted(self.property_distinct.items(),
                                            key=lambda kv: (sorted(kv[0][0]),
                                                            kv[0][1]))],
        }

    @staticmethod
    def from_payload(p: Mapping[str, Any]) -> Optional["GraphStatistics"]:
        """Validated inverse of :meth:`to_payload` — a malformed payload
        yields None (the store is a hint, never an authority)."""
        try:
            combos = {frozenset(k): int(v)
                      for k, v in (p.get("node_combos") or ())}
            rels = {str(t): RelStats.from_payload(r)
                    for t, r in (p.get("rels") or {}).items()}
            distinct = {(frozenset(k), str(prop)): int(v)
                        for k, prop, v in (p.get("property_distinct")
                                           or ())}
            return GraphStatistics(combos, rels, distinct,
                                   version=int(p.get("version") or 0))
        except (TypeError, ValueError, AttributeError):
            return None


EMPTY_STATS = GraphStatistics({}, {})


# -- computation -------------------------------------------------------------


def _host_ints(table, col: str) -> Optional[np.ndarray]:
    """One column as a host int64 array (None rows dropped).  Device
    tables expose ``host_column`` (one cached transfer); anything else
    materializes through the Table SPI."""
    host = getattr(table, "host_column", None)
    if host is not None:
        got = host(col)
        if got is not None:
            vals, ok = got
            return np.asarray(vals)[np.asarray(ok)].astype(np.int64)
    vals = table.column_values(col)
    return np.array([v for v in vals if v is not None], dtype=np.int64)


def compute_graph_statistics(graph, version: int = 0) -> GraphStatistics:
    """Host-side sketch of a ScanGraph's entity tables.  One pass at
    ingest (lazy, cached by the graph); failure degrades to
    :data:`EMPTY_STATS` — statistics must never fail a query."""
    node_combos: Dict[FrozenSet[str], int] = {}
    rels: Dict[str, RelStats] = {}
    distinct: Dict[Tuple[FrozenSet[str], str], int] = {}
    try:
        for nt in getattr(graph, "node_tables", ()):
            combo = frozenset(nt.labels)
            n = int(nt.table.exact_size())
            node_combos[combo] = node_combos.get(combo, 0) + n
            if 0 < n <= _MAX_DISTINCT_ROWS:
                props = list(nt.mapping.property_cols.items())
                counts = nt.table.distinct_counts([c for _k, c in props])
                for (key, _col), cnt in zip(props, counts):
                    if cnt is None:  # no count for this column
                        continue
                    k = (combo, key)
                    distinct[k] = distinct.get(k, 0) + cnt
        for rt in getattr(graph, "rel_tables", ()):
            m = rt.mapping
            src = _host_ints(rt.table, m.source_col)
            tgt = _host_ints(rt.table, m.target_col)
            prev = rels.get(rt.rel_type)
            cur = RelStats(rt.rel_type, int(src.shape[0]),
                           out=_sketch(src), inn=_sketch(tgt))
            if prev is not None:
                # same type split over tables: keep the bigger sketch,
                # sum the cardinalities (the mean/skew stays approximate)
                cur = RelStats(rt.rel_type, prev.rows + cur.rows,
                               out=max((prev.out, cur.out),
                                       key=lambda s: s.rows),
                               inn=max((prev.inn, cur.inn),
                                       key=lambda s: s.rows))
            rels[rt.rel_type] = cur
    except Exception:  # pragma: no cover — statistics must not fail
        return EMPTY_STATS
    return GraphStatistics(node_combos, rels, distinct, version=version)


def fold_delta(base: GraphStatistics, state,
               version: int) -> GraphStatistics:
    """Refresh a base sketch with a snapshot's delta counts (cheap —
    the delta records are host-resident): created nodes/rels add to
    their combo/type cardinalities, tombstones subtract from the
    totals proportionally.  Degree sketches keep the base shape (the
    delta is bounded by compaction, so the distortion is too)."""
    combos = dict(base.node_combos)
    for rec in getattr(state, "nodes", ()):
        combo = frozenset(rec.labels)
        combos[combo] = combos.get(combo, 0) + 1
    hidden_n = len(getattr(state, "hidden_nodes", ()))
    if hidden_n and combos:
        total = sum(combos.values()) or 1
        combos = {k: max(0, v - (hidden_n * v) // total)
                  for k, v in combos.items()}
    rels = dict(base.rels)
    added_rels: Dict[str, int] = {}
    for rec in getattr(state, "rels", ()):
        added_rels[rec.rel_type] = added_rels.get(rec.rel_type, 0) + 1
    hidden_r = len(getattr(state, "hidden_rels", ()))
    for t, extra in added_rels.items():
        prev = rels.get(t) or RelStats(t, 0)
        rels[t] = dataclasses.replace(prev, rows=prev.rows + extra)
    if hidden_r and rels:
        total = sum(r.rows for r in rels.values()) or 1
        rels = {t: dataclasses.replace(
            r, rows=max(0, r.rows - (hidden_r * r.rows) // total))
            for t, r in rels.items()}
    return GraphStatistics(combos, rels, base.property_distinct,
                           version=version)


def graph_statistics(graph) -> GraphStatistics:
    """The one entry point planners use: a graph's (lazily computed,
    cached) statistics — :data:`EMPTY_STATS` for graphs that have none
    (EmptyGraph, union graphs, mocks)."""
    fn = getattr(graph, "statistics", None)
    if fn is None:
        return EMPTY_STATS
    try:
        got = fn()
    except Exception:  # pragma: no cover — statistics must not fail
        return EMPTY_STATS
    return got if isinstance(got, GraphStatistics) else EMPTY_STATS
