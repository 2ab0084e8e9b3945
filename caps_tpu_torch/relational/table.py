"""The columnar ``Table`` SPI — the port surface every backend implements.

Mirrors the reference's ``Table[T]`` trait (select/filter/drop/join/
unionAll/orderBy/skip/limit/distinct/group/withColumn/size/physicalColumns/
columnType/rows/cache) (ref: okapi-relational/.../api/table/Table.scala —
reconstructed, mount empty; SURVEY.md §2 "Table SPI").

Like the reference — where ``filter(expr)`` takes an okapi ``Expr`` and each
backend compiles it (SparkSQLExprMapper for Spark) — expression-bearing
methods here receive ``(expr, header, parameters)`` and the backend brings
its own expression compiler.  Aggregations and sort keys are pre-projected
to physical columns by the relational planner, so ``group``/``order_by``
deal in column names only.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from caps_tpu_torch.ir.exprs import Expr
from caps_tpu_torch.okapi.types import CypherType
from caps_tpu_torch.relational.header import RecordHeader


class ExprEvalError(Exception):
    """A runtime error of an expression on a row (division by zero, a
    malformed temporal value): every backend raises this class."""


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregation over a pre-projected input column.

    kind: count_star | count | sum | avg | min | max | collect | stdev
          | percentile_cont | percentile_disc
    """
    name: str
    kind: str
    col: Optional[str] = None       # None for count_star
    distinct: bool = False
    percentile: Optional[float] = None
    result_type: Optional[CypherType] = None


JoinType = str  # "inner" | "left" | "cross"


class Table(abc.ABC):
    """Immutable columnar table."""

    # -- shape --------------------------------------------------------------

    @property
    @abc.abstractmethod
    def columns(self) -> Tuple[str, ...]:
        ...

    @property
    @abc.abstractmethod
    def size(self) -> int:
        ...

    def exact_size(self) -> int:
        """The exact live row count.  Equal to ``size`` everywhere except
        a device table under generic fused replay, where ``size`` is a
        served upper bound and this method pays the one materialization
        sync.  Use at materialization boundaries only."""
        return self.size

    def size_hint(self) -> int:
        """A row count that NEVER syncs: exact when known (eager mode, or
        after a materialization already paid the sync), otherwise the
        served upper bound.  For metrics/logging only."""
        return self.size

    def branch_empty(self) -> bool:
        """``size == 0`` as a CONTROL-FLOW predicate.  Plan code must use
        this (not ``.size``) when branching on emptiness: under generic
        fused replay ``size`` is a served upper bound, and this method
        routes the decision through the record/replay stream so a
        divergent branch is detected instead of silently followed."""
        return self.size == 0

    @property
    def nbytes(self) -> int:
        """Approximate resident bytes of this table's columns — the input
        to the per-operator bytes-touched accounting (SURVEY.md §5.5; the
        single-chip roofline proxy: achieved GB/s = bytes / wall-clock).
        Backends override with exact buffer sizes; the default assumes 8
        bytes + validity per cell."""
        return self.size * len(self.columns) * 9

    @abc.abstractmethod
    def column_type(self, col: str) -> CypherType:
        ...

    # -- column ops ---------------------------------------------------------

    @abc.abstractmethod
    def select(self, cols: Sequence[str]) -> "Table":
        """Narrow to exactly these columns, in order."""

    @abc.abstractmethod
    def rename(self, mapping: Mapping[str, str]) -> "Table":
        ...

    @abc.abstractmethod
    def with_column(self, name: str, expr: Expr, header: RecordHeader,
                    parameters: Mapping[str, Any],
                    cypher_type: CypherType) -> "Table":
        """Append a column computed from ``expr`` (backend-compiled)."""

    @abc.abstractmethod
    def with_literal_column(self, name: str, value: Any,
                            cypher_type: CypherType) -> "Table":
        ...

    @abc.abstractmethod
    def with_row_index(self, name: str) -> "Table":
        """Append a unique int64 row-id column (used for Optional joins)."""

    @abc.abstractmethod
    def copy_column(self, src: str, dst: str) -> "Table":
        """Append ``dst`` as a copy of ``src`` (entity aliasing)."""

    # -- row ops ------------------------------------------------------------

    @abc.abstractmethod
    def filter(self, expr: Expr, header: RecordHeader,
               parameters: Mapping[str, Any]) -> "Table":
        """Keep rows where ``expr`` evaluates to exactly true (3VL)."""

    @abc.abstractmethod
    def join(self, other: "Table", how: JoinType,
             pairs: Sequence[Tuple[str, str]]) -> "Table":
        """Join on equality of column pairs; null keys never match.
        Column sets must be disjoint."""

    @abc.abstractmethod
    def union_all(self, other: "Table") -> "Table":
        """Bag union; ``other`` must have the same columns."""

    def drop_in(self, col: str, values) -> "Table":
        """Drop rows whose ``col`` value is in ``values`` — the tombstone
        mask of the versioned-snapshot overlay (relational/updates.py).
        Device backends keep this on-device (a padded ``isin`` mask over
        a size-bucketed id array, so the compiled program is shared
        across snapshots); null cells never match and are kept."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement drop_in")

    @abc.abstractmethod
    def distinct(self) -> "Table":
        ...

    @abc.abstractmethod
    def order_by(self, items: Sequence[Tuple[str, bool]]) -> "Table":
        """Stable multi-key sort; (column, ascending); Cypher null ordering
        (nulls last ascending, first descending)."""

    @abc.abstractmethod
    def skip(self, n: int) -> "Table":
        ...

    @abc.abstractmethod
    def limit(self, n: int) -> "Table":
        ...

    @abc.abstractmethod
    def group(self, by: Sequence[str], aggs: Sequence[AggSpec]) -> "Table":
        """Group by columns, compute aggregations.  Empty ``by`` = one
        global group (which aggregates over zero rows to count=0/sum=0/
        null for min/max/avg, per Cypher)."""

    @abc.abstractmethod
    def explode(self, list_col: str, out_col: str,
                out_type: CypherType) -> "Table":
        """UNWIND: one output row per element of ``list_col``; empty lists
        and nulls produce no rows."""

    @abc.abstractmethod
    def pack_list(self, cols: Sequence[str], out_col: str,
                  out_type: CypherType) -> "Table":
        """Combine columns into one list-valued column per row, skipping
        nulls (used for variable-length relationship lists)."""

    # -- materialization ----------------------------------------------------

    @abc.abstractmethod
    def column_values(self, col: str) -> List[Any]:
        """Materialize one column to host Python values (None for null)."""

    def rows(self) -> List[Dict[str, Any]]:
        cols = self.columns
        data = {c: self.column_values(c) for c in cols}
        return [{c: data[c][i] for c in cols} for i in range(self.size)]

    def cache(self) -> "Table":
        return self

    def device_sync(self) -> None:
        """Wait for any in-flight device work producing this table
        (PROFILE's per-operator device-time mode — obs/).  Host-side
        backends are synchronous already: no-op.  Never transfers data
        or consumes fused-replay sizes — purely a completion barrier."""
        return None


class TableFactory(abc.ABC):
    """Backend-side constructors for tables."""

    @abc.abstractmethod
    def from_columns(self, data: Mapping[str, Sequence[Any]],
                     types: Mapping[str, CypherType]) -> Table:
        ...

    @abc.abstractmethod
    def unit(self) -> Table:
        """One row, zero columns (the Start operator's table)."""

    @abc.abstractmethod
    def empty(self, cols: Sequence[str],
              types: Mapping[str, CypherType]) -> Table:
        ...

    def prepare_rel_table(self, rel_table) -> None:
        """Backend hook called once per relationship table at graph
        creation: device backends build their physical adjacency layout
        (HBM-resident CSR over the source/target columns) here so every
        later Expand hop probes it.  Default: no-op."""
