"""Pure-Python columnar Table implementation (the correctness oracle).

Fills the role the reference's ``SparkTable.DataFrameTable`` plays for
Spark (ref: spark-cypher/.../impl/table/SparkTable.scala — reconstructed,
mount empty; SURVEY.md §2): the ``Table`` SPI over a concrete columnar
representation.  Columns are Python lists with ``None`` for null, giving
exact Cypher value semantics; the TPU backend is differential-tested
against this one.
"""
from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from caps_tpu_torch.ir.exprs import Expr
from caps_tpu_torch.okapi.types import CypherType
from caps_tpu_torch.okapi.values import cypher_equals, order_key
from caps_tpu_torch.relational.header import RecordHeader
from caps_tpu_torch.relational.table import AggSpec, Table, TableFactory


def _hashable(v: Any) -> Any:
    if isinstance(v, list):
        return ("__list__",) + tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return ("__map__",) + tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, bool):
        return ("__bool__", v)  # keep True distinct from 1
    return v


def _as_list(values: Sequence[Any]) -> List[Any]:
    """A column's values as a list of Python values: a numpy array (the
    bulk columns ``interop.py`` and ``io/fs.py`` hand over) gives its
    ``tolist()``, so every value keeps exact Cypher semantics."""
    if not isinstance(values, list) and hasattr(values, "tolist"):
        return values.tolist()
    return list(values)


class LocalTable(Table):
    def __init__(self, columns: Sequence[str],
                 data: Mapping[str, Sequence[Any]],
                 types: Mapping[str, CypherType],
                 size: Optional[int] = None):
        self._columns = tuple(columns)
        self._data: Dict[str, List[Any]] = {c: _as_list(data[c])
                                            for c in columns}
        self._types: Dict[str, CypherType] = dict(types)
        sizes = {len(v) for v in self._data.values()}
        if len(sizes) > 1:
            raise ValueError(f"ragged columns: { {c: len(v) for c, v in self._data.items()} }")
        if sizes:
            self._size = sizes.pop()
            if size is not None and size != self._size:
                raise ValueError(f"size mismatch: {size} != {self._size}")
        else:
            # Zero-column tables (e.g. the unit table) carry an explicit size.
            self._size = size or 0

    # -- shape --------------------------------------------------------------

    @property
    def columns(self) -> Tuple[str, ...]:
        return self._columns

    @property
    def size(self) -> int:
        return self._size

    def column_type(self, col: str) -> CypherType:
        return self._types[col]

    def _with(self, columns, data, types, size=None) -> "LocalTable":
        return LocalTable(columns, data, types, size=size)

    # -- column ops ---------------------------------------------------------

    def select(self, cols: Sequence[str]) -> "LocalTable":
        missing = [c for c in cols if c not in self._data]
        if missing:
            raise KeyError(f"missing columns {missing}; have {self._columns}")
        return self._with(tuple(cols), {c: self._data[c] for c in cols},
                          {c: self._types[c] for c in cols})

    def rename(self, mapping: Mapping[str, str]) -> "LocalTable":
        cols = tuple(mapping.get(c, c) for c in self._columns)
        if len(set(cols)) != len(cols):
            raise ValueError(f"rename collision: {cols}")
        data = {mapping.get(c, c): v for c, v in self._data.items()}
        types = {mapping.get(c, c): t for c, t in self._types.items()}
        return self._with(cols, data, types)

    def with_column(self, name: str, expr: Expr, header: RecordHeader,
                    parameters: Mapping[str, Any],
                    cypher_type: CypherType) -> "LocalTable":
        from caps_tpu_torch.backends.local.expr import evaluate
        values = evaluate(expr, self._size, lambda c: self._data[c], header,
                          parameters)
        return self._append(name, values, cypher_type)

    def with_literal_column(self, name: str, value: Any,
                            cypher_type: CypherType) -> "LocalTable":
        return self._append(name, [value] * self._size, cypher_type)

    def with_row_index(self, name: str) -> "LocalTable":
        from caps_tpu_torch.okapi.types import CTInteger
        return self._append(name, list(range(self._size)), CTInteger)

    def copy_column(self, src: str, dst: str) -> "LocalTable":
        return self._append(dst, list(self._data[src]), self._types[src])

    def _append(self, name: str, values: List[Any],
                cypher_type: CypherType) -> "LocalTable":
        if name in self._data:
            cols = self._columns
        else:
            cols = self._columns + (name,)
        data = dict(self._data)
        data[name] = values
        types = dict(self._types)
        types[name] = cypher_type
        return self._with(cols, data, types)

    # -- row ops ------------------------------------------------------------

    def filter(self, expr: Expr, header: RecordHeader,
               parameters: Mapping[str, Any]) -> "LocalTable":
        from caps_tpu_torch.backends.local.expr import evaluate
        mask = evaluate(expr, self._size, lambda c: self._data[c], header,
                        parameters)
        keep = [i for i, v in enumerate(mask) if v is True]
        return self._take(keep)

    def _take(self, idx: List[int]) -> "LocalTable":
        data = {c: [v[i] for i in idx] for c, v in self._data.items()}
        return self._with(self._columns, data, self._types, size=len(idx))

    def join(self, other: Table, how: str,
             pairs: Sequence[Tuple[str, str]]) -> "LocalTable":
        assert isinstance(other, LocalTable)
        shared = set(self._columns) & set(other._columns)
        if shared:
            raise ValueError(f"join column collision: {shared}")
        out_cols = self._columns + other._columns
        out_types = {**self._types, **other._types}
        out: Dict[str, List[Any]] = {c: [] for c in out_cols}

        if how == "cross":
            for i in range(self._size):
                for j in range(other._size):
                    for c in self._columns:
                        out[c].append(self._data[c][i])
                    for c in other._columns:
                        out[c].append(other._data[c][j])
            return self._with(out_cols, out, out_types,
                              size=self._size * other._size)

        right_index: Dict[Any, List[int]] = {}
        rkeys = [other._data[rc] for _, rc in pairs]
        for j in range(other._size):
            key = tuple(_hashable(k[j]) for k in rkeys)
            if any(k[j] is None for k in rkeys):
                continue  # null keys never match
            right_index.setdefault(key, []).append(j)
        lkeys = [self._data[lc] for lc, _ in pairs]
        for i in range(self._size):
            if any(k[i] is None for k in lkeys):
                matches: List[int] = []
            else:
                key = tuple(_hashable(k[i]) for k in lkeys)
                matches = right_index.get(key, [])
            if matches:
                for j in matches:
                    for c in self._columns:
                        out[c].append(self._data[c][i])
                    for c in other._columns:
                        out[c].append(other._data[c][j])
            elif how == "left":
                for c in self._columns:
                    out[c].append(self._data[c][i])
                for c in other._columns:
                    out[c].append(None)
            elif how != "inner":
                raise ValueError(f"unknown join type {how}")
        return self._with(out_cols, out, out_types)

    def union_all(self, other: Table) -> "LocalTable":
        assert isinstance(other, LocalTable)
        if set(other._columns) != set(self._columns):
            raise ValueError(
                f"union column mismatch: {self._columns} vs {other._columns}")
        data = {c: self._data[c] + other._data[c] for c in self._columns}
        types = {c: self._types[c].join(other._types[c]) for c in self._columns}
        return self._with(self._columns, data, types,
                          size=self._size + other._size)

    def drop_in(self, col: str, values) -> "LocalTable":
        dropped = frozenset(values)
        if not dropped:
            return self
        vals = self._data[col]
        keep = [i for i in range(self._size)
                if vals[i] is None or vals[i] not in dropped]
        return self._take(keep)

    def distinct(self) -> "LocalTable":
        seen = set()
        keep = []
        for i in range(self._size):
            key = tuple(_hashable(self._data[c][i]) for c in self._columns)
            if key not in seen:
                seen.add(key)
                keep.append(i)
        return self._take(keep)

    def order_by(self, items: Sequence[Tuple[str, bool]]) -> "LocalTable":
        idx = list(range(self._size))
        for col, asc in reversed(list(items)):
            vals = self._data[col]
            idx.sort(key=lambda i: order_key(vals[i]), reverse=not asc)
        return self._take(idx)

    def skip(self, n: int) -> "LocalTable":
        n = max(0, n)  # negative counts behave as 0, never wrap around
        return self._take(list(range(min(n, self._size), self._size)))

    def limit(self, n: int) -> "LocalTable":
        return self._take(list(range(min(max(0, n), self._size))))

    def group(self, by: Sequence[str], aggs: Sequence[AggSpec]) -> "LocalTable":
        groups: Dict[Tuple, List[int]] = {}
        order: List[Tuple] = []
        for i in range(self._size):
            key = tuple(_hashable(self._data[c][i]) for c in by)
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(i)
        if not by and not order:
            order.append(())
            groups[()] = []

        out_cols = tuple(by) + tuple(a.name for a in aggs)
        out: Dict[str, List[Any]] = {c: [] for c in out_cols}
        types = {c: self._types[c] for c in by}
        for a in aggs:
            from caps_tpu_torch.okapi.types import CTAny
            types[a.name] = a.result_type or CTAny
        for key in order:
            rows = groups[key]
            if rows:
                first = rows[0]
                for c in by:
                    out[c].append(self._data[c][first])
            else:
                for c in by:
                    out[c].append(None)
            for a in aggs:
                out[a.name].append(self._aggregate(a, rows))
        return self._with(out_cols, out, types, size=len(order))

    def _aggregate(self, a: AggSpec, rows: List[int]) -> Any:
        if a.kind == "count_star":
            return len(rows)
        if a.kind == "first":
            # carries grouped-entity auxiliary columns (same value per group)
            return self._data[a.col][rows[0]] if rows else None
        vals = [self._data[a.col][i] for i in rows]
        vals = [v for v in vals if v is not None]
        if a.distinct:
            seen = set()
            uniq = []
            for v in vals:
                h = _hashable(v)
                if h not in seen:
                    seen.add(h)
                    uniq.append(v)
            vals = uniq
        if a.kind == "count":
            return len(vals)
        if a.kind == "collect":
            return vals
        if a.kind == "sum":
            return sum(vals) if vals else 0
        if a.kind == "avg":
            return (sum(vals) / len(vals)) if vals else None
        if a.kind == "min":
            return min(vals, key=order_key) if vals else None
        if a.kind == "max":
            return max(vals, key=order_key) if vals else None
        if a.kind == "stdev":
            return statistics.stdev(vals) if len(vals) > 1 else (0.0 if vals else None)
        if a.kind in ("percentile_cont", "percentile_disc"):
            if not vals:
                return None
            svals = sorted(vals)
            p = a.percentile or 0.0
            if a.kind == "percentile_disc":
                # nearest-rank (Neo4j semantics): 1-based rank ceil(p*n)
                rank = max(1, math.ceil(p * len(svals)))
                return svals[min(len(svals), rank) - 1]
            pos = p * (len(svals) - 1)
            lo, hi = int(pos), min(int(pos) + 1, len(svals) - 1)
            frac = pos - int(pos)
            return svals[lo] * (1 - frac) + svals[hi] * frac
        raise ValueError(f"unknown aggregation kind {a.kind}")

    def explode(self, list_col: str, out_col: str,
                out_type: CypherType) -> "LocalTable":
        out_cols = tuple(c for c in self._columns if c != list_col) + (out_col,)
        out: Dict[str, List[Any]] = {c: [] for c in out_cols}
        for i in range(self._size):
            lst = self._data[list_col][i]
            if lst is None:
                continue
            for item in lst:
                for c in self._columns:
                    if c != list_col:
                        out[c].append(self._data[c][i])
                out[out_col].append(item)
        types = {c: t for c, t in self._types.items() if c != list_col}
        types[out_col] = out_type
        return self._with(out_cols, out, types)

    def pack_list(self, cols: Sequence[str], out_col: str,
                  out_type: CypherType) -> "LocalTable":
        values = [[self._data[c][i] for c in cols if self._data[c][i] is not None]
                  for i in range(self._size)]
        return self._append(out_col, values, out_type)

    # -- materialization ----------------------------------------------------

    def column_values(self, col: str) -> List[Any]:
        return list(self._data[col])


class LocalTableFactory(TableFactory):
    def from_columns(self, data: Mapping[str, Sequence[Any]],
                     types: Mapping[str, CypherType]) -> LocalTable:
        return LocalTable(tuple(data.keys()), data, types)

    def unit(self) -> LocalTable:
        return LocalTable((), {}, {}, size=1)

    def empty(self, cols: Sequence[str],
              types: Mapping[str, CypherType]) -> LocalTable:
        return LocalTable(tuple(cols), {c: [] for c in cols}, types)
