"""Expr → device column compiler.

The counterpart of ``caps_tpu/backends/tpu/expr.py`` (the analog of the
reference's ``SparkSQLExprMapper``, SURVEY.md §2): compiles okapi
expressions to (data, valid) column computations in torch with
3-valued null logic carried in validity masks.  String semantics ride the
StringPool: equality on codes, ordering via the rank array, literal string
predicates via per-pool lookup tables, unary string functions via mapping
LUTs.  Anything without a device representation raises
:class:`UnsupportedOnDevice`; there is no host fallback.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from caps_tpu_torch.backends.cuda.column import Column, kind_for
from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.okapi.types import (
    CTBoolean, CTFloat, CTInteger, CTString, CypherType,
)
from caps_tpu_torch.relational.header import RecordHeader


class UnsupportedOnDevice(Exception):
    """Raised when an expression/operator has no device path (yet).  The
    message names the operator; nothing falls back to the host."""


class DeviceExprCompiler:
    def __init__(self, columns: Mapping[str, Column], capacity: int,
                 header: RecordHeader, params: Mapping[str, Any], pool,
                 row_ok: torch.Tensor):
        self.columns = columns
        self.capacity = capacity
        self.header = header
        self.params = dict(params)
        self.pool = pool
        self.row_ok = row_ok
        self.device = row_ok.device
        # per-row runtime-error mask: dense
        # vectorized execution can't raise mid-kernel, so error sites OR
        # their row conditions here; the table syncs ONCE after compile —
        # only for expressions that contain an error site — and raises
        # with oracle-matching semantics.
        self.error_mask = None
        self.error_what = ""

    def _note_row_error(self, rows, what: str) -> None:
        rows = rows & self.row_ok
        self.error_mask = rows if self.error_mask is None \
            else (self.error_mask | rows)
        self.error_what = self.error_what or what

    # ------------------------------------------------------------------

    def compile(self, e: E.Expr) -> Column:  # noqa: C901
        if self.header.has(e):
            col = self.columns[self.header.column(e)]
            return col

        if isinstance(e, E.Lit):
            return self._literal(e.value)
        if isinstance(e, E.Param):
            if e.name not in self.params:
                raise KeyError(f"missing parameter ${e.name}")
            v = self.params[e.name]
            if isinstance(v, (list, tuple)):
                return self._const_list(list(v))
            if isinstance(v, dict):
                raise UnsupportedOnDevice("map parameter value")
            return self._literal(v)
        if isinstance(e, E.ListLit):
            values = []
            for item in e.items:
                if isinstance(item, E.Lit):
                    values.append(item.value)
                elif isinstance(item, E.Param):
                    values.append(self.params.get(item.name))
                else:
                    raise UnsupportedOnDevice("non-constant list literal")
            return self._const_list(values)
        if isinstance(e, E.Index):
            return self._index(e)
        if isinstance(e, E.Id):
            return self.compile(e.entity)

        if isinstance(e, E.Ands):
            return self._and_or(e.exprs, is_and=True)
        if isinstance(e, E.Ors):
            return self._and_or(e.exprs, is_and=False)
        if isinstance(e, E.Not):
            c = self._bool(self.compile(e.expr))
            return Column("bool", ~c.data, c.valid, CTBoolean)
        if isinstance(e, E.Xor):
            l = self._bool(self.compile(e.lhs))
            r = self._bool(self.compile(e.rhs))
            return Column("bool", l.data ^ r.data, l.valid & r.valid, CTBoolean)
        if isinstance(e, E.IsNull):
            c = self.compile(e.expr)
            return Column("bool", ~c.valid, self._full(True),
                          CTBoolean)
        if isinstance(e, E.IsNotNull):
            c = self.compile(e.expr)
            return Column("bool", c.valid, self._full(True),
                          CTBoolean)
        if isinstance(e, E.Exists):
            c = self.compile(e.expr)
            return Column("bool", c.valid, self._full(True),
                          CTBoolean)

        if isinstance(e, (E.Equals, E.NotEquals)):
            return self._equality(e)
        if isinstance(e, (E.LessThan, E.LessThanOrEqual, E.GreaterThan,
                          E.GreaterThanOrEqual)):
            return self._ordering(e)
        if isinstance(e, (E.StartsWith, E.EndsWith, E.Contains, E.RegexMatch)):
            return self._string_predicate(e)
        if isinstance(e, E.In):
            return self._in_list(e)

        if isinstance(e, (E.Add, E.Subtract, E.Multiply, E.Divide, E.Modulo,
                          E.Power)):
            return self._arith(e)
        if isinstance(e, E.Negate):
            c = self.compile(e.expr)
            if c.kind not in ("int", "float", "id"):
                raise UnsupportedOnDevice("negate non-numeric")
            return Column(c.kind, -c.data, c.valid, c.ctype)

        if isinstance(e, E.CaseExpr):
            return self._case(e)
        if isinstance(e, E.Coalesce):
            cols = [self.compile(x) for x in e.exprs]
            out = cols[-1]
            for c in reversed(cols[:-1]):
                c2, o2 = self._promote(c, out)
                out = Column(c2.kind,
                             torch.where(c2.valid, c2.data, o2.data),
                             c2.valid | o2.valid, c2.ctype)
            return out
        if isinstance(e, E.FunctionExpr):
            return self._function(e)
        if isinstance(e, E.Type):
            raise UnsupportedOnDevice(f"{e!r} not in header")
        raise UnsupportedOnDevice(f"no device rule for {type(e).__name__}")

    # -- helpers -------------------------------------------------------

    def _full(self, value: bool) -> torch.Tensor:
        return torch.full((self.capacity,), value, dtype=torch.bool,
                          device=self.device)

    def _lut(self, arr: np.ndarray) -> torch.Tensor:
        """A host lookup table (pool rank / predicate / map LUT) on the
        device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _literal(self, v: Any) -> Column:
        from caps_tpu_torch.backends.cuda.column import literal_column
        from caps_tpu_torch.okapi.types import from_python
        if isinstance(v, (list, tuple, dict)):
            raise UnsupportedOnDevice("collection literal")
        ctype = from_python(v)
        return literal_column(v, ctype if v is not None else CTBoolean,
                              self.capacity, self.pool, self.device)

    def _const_list(self, values) -> Column:
        """A constant list value broadcast to every row (literal lists and
        list parameters)."""
        from caps_tpu_torch.backends.cuda.column import encode_list_elem
        from caps_tpu_torch.okapi.types import CTList, from_python, join_all
        if any(v is None for v in values):
            raise UnsupportedOnDevice("null list elements")
        inner = join_all(from_python(v) for v in values) if values \
            else CTInteger
        ctype = CTList(inner)
        from caps_tpu_torch.backends.cuda.column import list_elem_kind
        ek = list_elem_kind(ctype)
        if ek is None:
            raise UnsupportedOnDevice(f"list of {inner!r} on device")
        try:
            codes = np.array([encode_list_elem(v, ek, self.pool)
                              for v in values], dtype=np.int32)
        except (ValueError, OverflowError) as ex:
            raise UnsupportedOnDevice(str(ex))
        L = max(1, len(values))
        data = self._lut(np.resize(codes, L) if len(values) else
                         np.zeros(L, np.int32))[None, :].expand(
                             self.capacity, L)
        lens = torch.full((self.capacity,), len(values), dtype=torch.int32,
                          device=self.device)
        return Column("list", data, self._full(True), ctype,
                      lens)

    def _index(self, e) -> Column:
        from caps_tpu_torch.backends.cuda.column import _DTYPES, list_elem_kind
        base = self.compile(e.expr)
        if base.kind != "list":
            raise UnsupportedOnDevice(f"indexing kind {base.kind}")
        idx = self.compile(e.idx)
        if idx.kind not in ("int", "id"):
            raise UnsupportedOnDevice("non-integer list index")
        ek = list_elem_kind(base.ctype)
        if ek is None:
            raise UnsupportedOnDevice("indexing host-only list")
        inner = base.ctype.material.inner
        i = idx.data.to(torch.int32)
        i = torch.where(i < 0, i + base.lens, i)  # negative = from the end
        inb = (i >= 0) & (i < base.lens)
        safe = i.clamp(0, base.data.shape[1] - 1).to(torch.int64)
        vals = base.data[torch.arange(self.capacity, device=self.device),
                         safe]
        valid = base.valid & idx.valid & inb
        if ek == "bool":
            return Column("bool", vals != 0, valid, inner)
        return Column(ek, vals.to(_DTYPES[ek]), valid, inner)

    def _bool(self, c: Column) -> Column:
        if c.kind != "bool":
            raise UnsupportedOnDevice(f"expected boolean, got {c.kind}")
        return c

    def _and_or(self, exprs, is_and: bool) -> Column:
        cols = [self._bool(self.compile(x)) for x in exprs]
        decided = self._full(False)   # any False (AND) / True (OR)
        any_null = self._full(False)
        for c in cols:
            hit = c.valid & (~c.data if is_and else c.data)
            decided = decided | hit
            any_null = any_null | ~c.valid
        if is_and:
            data = ~decided & ~any_null
            valid = decided | ~any_null
        else:
            data = decided
            valid = decided | ~any_null
        return Column("bool", data, valid, CTBoolean)

    def _promote(self, l: Column, r: Column):
        """Promote two columns to a common comparable kind."""
        if l.kind == r.kind:
            return l, r
        numeric = {"id", "int", "float"}
        if l.kind in numeric and r.kind in numeric:
            if "float" in (l.kind, r.kind):
                return l.astype_kind("float"), r.astype_kind("float")
            return l.astype_kind("int"), r.astype_kind("int")
        raise UnsupportedOnDevice(f"cannot compare kinds {l.kind}/{r.kind}")

    def _equality(self, e) -> Column:
        l = self.compile(e.lhs)
        r = self.compile(e.rhs)
        valid = l.valid & r.valid
        if l.kind == "list" or r.kind == "list":
            eq = self._list_equal(l, r)
        else:
            try:
                l2, r2 = self._promote(l, r)
                eq = l2.data == r2.data
            except UnsupportedOnDevice:
                # mismatched kinds: never equal
                eq = self._full(False)
        if isinstance(e, E.NotEquals):
            eq = ~eq
        return Column("bool", eq, valid, CTBoolean)

    def _list_equal(self, l: Column, r: Column) -> torch.Tensor:
        """Elementwise list equality: lengths match and every in-range
        element matches.  Device list elements are int32 codes; code
        spaces are only comparable within the same element kind (ids and
        ints share the numeric space)."""
        from caps_tpu_torch.backends.cuda.column import list_elem_kind
        if l.kind != "list" or r.kind != "list":
            return self._full(False)
        ekl = list_elem_kind(l.ctype)
        ekr = list_elem_kind(r.ctype)
        # code spaces only align within one element kind — and 'id' lists
        # hold entities, which never equal integers in openCypher
        if ekl != ekr:
            return self._full(False)
        W = max(l.data.shape[1], r.data.shape[1], 1)

        def pad(d):
            if d.shape[1] == W:
                return d
            return torch.cat(
                [d, torch.zeros((d.shape[0], W - d.shape[1]), dtype=d.dtype,
                                device=d.device)], dim=1)

        ld, rd = pad(l.data), pad(r.data)
        pos = torch.arange(W, device=self.device)[None, :]
        within = pos < l.lens[:, None]
        elems_eq = (ld == rd) | ~within
        return (l.lens == r.lens) & elems_eq.all(dim=1)

    def _ordering(self, e) -> Column:
        l = self.compile(e.lhs)
        r = self.compile(e.rhs)
        valid = l.valid & r.valid
        if l.kind == "str" and r.kind == "str":
            rank = self._lut(self.pool.rank_array())
            ld = _gather(rank, l.data) if rank.shape[0] else l.data
            rd = _gather(rank, r.data) if rank.shape[0] else r.data
        else:
            l2, r2 = self._promote(l, r)
            if l2.kind == "bool":
                raise UnsupportedOnDevice("boolean ordering")
            ld, rd = l2.data, r2.data
        if isinstance(e, E.LessThan):
            out = ld < rd
        elif isinstance(e, E.LessThanOrEqual):
            out = ld <= rd
        elif isinstance(e, E.GreaterThan):
            out = ld > rd
        else:
            out = ld >= rd
        return Column("bool", out, valid, CTBoolean)

    def _string_predicate(self, e) -> Column:
        l = self.compile(e.lhs)
        if l.kind != "str":
            raise UnsupportedOnDevice("string predicate on non-string")
        if not isinstance(e.rhs, (E.Lit, E.Param)):
            raise UnsupportedOnDevice("string predicate needs literal rhs")
        rhs = e.rhs.value if isinstance(e.rhs, E.Lit) else self.params[e.rhs.name]
        if not isinstance(rhs, str):
            raise UnsupportedOnDevice("string predicate rhs not a string")
        if isinstance(e, E.StartsWith):
            lut = self.pool.starts_with_lut(rhs)
        elif isinstance(e, E.EndsWith):
            lut = self.pool.ends_with_lut(rhs)
        elif isinstance(e, E.Contains):
            lut = self.pool.contains_lut(rhs)
        else:
            lut = self.pool.regex_lut(rhs)
        if lut.shape[0] == 0:
            return Column("bool", self._full(False), l.valid,
                          CTBoolean)
        data = _gather(self._lut(lut), l.data)
        return Column("bool", data, l.valid, CTBoolean)

    def _in_list(self, e) -> Column:
        l = self.compile(e.lhs)
        if isinstance(e.rhs, E.ListLit) and all(
                isinstance(i, E.Lit) for i in e.rhs.items):
            values = [i.value for i in e.rhs.items]
        elif isinstance(e.rhs, E.Param):
            values = self.params.get(e.rhs.name)
            if not isinstance(values, (list, tuple)):
                raise UnsupportedOnDevice("IN parameter is not a list")
        else:
            rhs = self.compile(e.rhs)
            if rhs.kind != "list":
                raise UnsupportedOnDevice(f"IN over kind {rhs.kind}")
            return self._in_list_column(l, rhs)
        has_null = any(v is None for v in values)
        values = [v for v in values if v is not None]
        if l.kind == "str":
            arr = self._lut(np.array(
                [self.pool.encode(v) for v in values if isinstance(v, str)],
                dtype=np.int32))
        elif l.kind in ("int", "id"):
            arr = self._lut(np.array(
                [int(v) for v in values
                 if isinstance(v, (int, float)) and not isinstance(v, bool)
                 and float(v) == int(v)], dtype=np.int64))
            l = l.astype_kind("int")
        elif l.kind == "float":
            arr = self._lut(np.array(
                [float(v) for v in values
                 if isinstance(v, (int, float)) and not isinstance(v, bool)],
                dtype=np.float64))
        else:
            raise UnsupportedOnDevice(f"IN over kind {l.kind}")
        found = torch.isin(l.data, arr) if arr.shape[0] else \
            self._full(False)
        valid = l.valid & (found | (not has_null))
        return Column("bool", found, valid, CTBoolean)

    def _in_list_column(self, l: Column, rhs: Column) -> Column:
        """``x IN list`` against a list column, row by row (e.g. a hop's
        relationship id against a var-length path's list).  Device list
        elements are never null: a hit is true, a miss false, except
        that a null ``x`` against a non-empty list and a null list give
        null."""
        from caps_tpu_torch.backends.cuda.column import list_elem_kind
        ek = list_elem_kind(rhs.ctype)
        kinds = {"id": ("id", "int"), "int": ("id", "int"),
                 "str": ("str",), "bool": ("bool",)}.get(ek, ())
        if l.kind not in kinds:
            raise UnsupportedOnDevice(f"{l.kind} IN list of {ek}")
        width = rhs.data.shape[1]
        in_len = (torch.arange(width, device=self.device)[None, :]
                  < rhs.lens[:, None])
        hit = (rhs.data.to(torch.int64)
               == l.data.to(torch.int64)[:, None]) & in_len
        found = hit.any(dim=1) & l.valid
        valid = rhs.valid & (l.valid | (rhs.lens == 0))
        return Column("bool", found, valid, CTBoolean)

    def _arith(self, e) -> Column:
        l = self.compile(e.lhs)
        r = self.compile(e.rhs)
        valid = l.valid & r.valid
        numeric = {"id", "int", "float"}
        # Python-numeric semantics for booleans (True == 1), matching the
        # oracle's behavior
        if l.kind == "bool":
            l = Column("int", l.data.to(torch.int64), l.valid, CTInteger)
        if r.kind == "bool":
            r = Column("int", r.data.to(torch.int64), r.valid, CTInteger)
        if l.kind not in numeric or r.kind not in numeric:
            raise UnsupportedOnDevice(
                f"arithmetic on kinds {l.kind}/{r.kind}")
        if isinstance(e, E.Power):
            lf, rf = l.astype_kind("float"), r.astype_kind("float")
            return Column("float", torch.pow(lf.data, rf.data), valid, CTFloat)
        both_int = l.kind != "float" and r.kind != "float"
        if both_int:
            a = l.astype_kind("int").data
            b = r.astype_kind("int").data
            if isinstance(e, E.Divide):
                self._note_row_error(valid & (b == 0), "division by zero")
                bb = torch.where(b == 0, torch.ones_like(b), b)
                q = torch.sign(a) * torch.sign(b) * (a.abs() // bb.abs())
                return Column("int", q, valid & (b != 0), CTInteger)
            if isinstance(e, E.Modulo):
                self._note_row_error(valid & (b == 0), "division by zero")
                bb = torch.where(b == 0, torch.ones_like(b), b)
                m = torch.sign(a) * (a.abs() % bb.abs())
                return Column("int", m, valid & (b != 0), CTInteger)
            ops: Dict[type, Callable] = {E.Add: torch.add,
                                         E.Subtract: torch.subtract,
                                         E.Multiply: torch.multiply}
            return Column("int", ops[type(e)](a, b), valid, CTInteger)
        a = l.astype_kind("float").data
        b = r.astype_kind("float").data
        if isinstance(e, E.Divide):
            self._note_row_error(valid & (b == 0.0), "division by zero")
            bb = torch.where(b == 0.0, torch.ones_like(b), b)
            return Column("float", a / bb, valid & (b != 0.0), CTFloat)
        if isinstance(e, E.Modulo):
            self._note_row_error(valid & (b == 0.0), "division by zero")
            bb = torch.where(b == 0, torch.ones_like(b), b)
            m = torch.sign(a) * (a.abs() % bb.abs())
            return Column("float", m, valid & (b != 0.0), CTFloat)
        ops = {E.Add: torch.add, E.Subtract: torch.subtract,
               E.Multiply: torch.multiply}
        return Column("float", ops[type(e)](a, b), valid, CTFloat)

    def _case(self, e: E.CaseExpr) -> Column:
        conds = [self._bool(self.compile(c)) for c in e.conditions]
        vals = [self.compile(v) for v in e.values]
        default = self.compile(e.default) if e.default is not None else None
        out = default
        if out is None:
            proto = vals[0]
            out = Column(proto.kind, torch.zeros_like(proto.data),
                         self._full(False), proto.ctype)
        for c, v in zip(reversed(conds), reversed(vals)):
            v2, o2 = self._promote(v, out)
            take = c.valid & c.data
            out = Column(v2.kind, torch.where(take, v2.data, o2.data),
                         torch.where(take, v2.valid, o2.valid), v2.ctype)
        return out

    def _function(self, e: E.FunctionExpr) -> Column:  # noqa: C901
        name = e.name
        if name in ("date", "datetime", "localdatetime") \
                and len(e.args) == 1 and isinstance(e.args[0], E.Lit) \
                and isinstance(e.args[0].value, str):
            # constant temporal literal → one int64 constant column (the
            # encodings are device-comparable; see column.py kinds)
            from caps_tpu_torch.okapi.types import CTDate, CTDateTime
            from caps_tpu_torch.okapi.values import CypherDate, CypherDateTime
            try:
                if name == "date":
                    enc, kind, ct = (CypherDate.parse(e.args[0].value).days,
                                     "date", CTDate)
                else:
                    enc, kind, ct = (
                        CypherDateTime.parse(e.args[0].value).micros,
                        "datetime", CTDateTime)
            except ValueError as ex:
                raise UnsupportedOnDevice(str(ex))
            return Column(kind, torch.full((self.capacity,), enc,
                                           dtype=torch.int64,
                                           device=self.device),
                          self._full(True), ct)
        args = [self.compile(a) for a in e.args]

        unary_float = {"sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
                       "log10": torch.log10, "sin": torch.sin,
                       "cos": torch.cos, "tan": torch.tan,
                       "atan": torch.atan, "asin": torch.asin,
                       "acos": torch.acos, "ceil": torch.ceil,
                       "floor": torch.floor}
        # out-of-domain inputs are null in Cypher, not nan/inf — fold the
        # domain into the validity mask (dense twin of the oracle's guards)
        unary_domain = {"sqrt": lambda v: v >= 0, "log": lambda v: v > 0,
                        "log10": lambda v: v > 0,
                        "asin": lambda v: v.abs() <= 1,
                        "acos": lambda v: v.abs() <= 1}
        if name in unary_float:
            c = args[0].astype_kind("float")
            valid = c.valid
            if name in unary_domain:
                valid = valid & unary_domain[name](c.data)
            safe = torch.where(valid, c.data, torch.ones_like(c.data))
            return Column("float", unary_float[name](safe), valid, CTFloat)
        if name == "round":
            c = args[0].astype_kind("float")
            return Column("float", torch.floor(c.data + 0.5), c.valid, CTFloat)
        if name == "abs":
            c = args[0]
            if c.kind not in ("int", "float", "id"):
                raise UnsupportedOnDevice("abs non-numeric")
            return Column(c.kind, c.data.abs(), c.valid, c.ctype)
        if name == "sign":
            c = args[0]
            return Column("int", torch.sign(c.data).to(torch.int64), c.valid,
                          CTInteger)
        if name in ("tointeger", "toint"):
            c = args[0]
            if c.kind in ("int", "id"):
                return c.astype_kind("int")
            if c.kind == "float":
                return Column("int", c.data.to(torch.int64), c.valid,
                              CTInteger)
            raise UnsupportedOnDevice("toInteger on non-numeric")
        if name == "tofloat":
            c = args[0]
            if c.kind in ("int", "id", "float"):
                return c.astype_kind("float")
            raise UnsupportedOnDevice("toFloat on non-numeric")
        if name in ("toupper", "touppercase", "tolower", "tolowercase",
                    "trim", "ltrim", "rtrim", "reverse"):
            c = args[0]
            if c.kind != "str":
                raise UnsupportedOnDevice(f"{name} on non-string")
            fns = {"toupper": str.upper, "touppercase": str.upper,
                   "tolower": str.lower, "tolowercase": str.lower,
                   "trim": str.strip, "ltrim": str.lstrip,
                   "rtrim": str.rstrip, "reverse": lambda s: s[::-1]}
            lut = self.pool.map_lut(name, fns[name])
            if lut.shape[0] == 0:
                return c
            return Column("str", _gather(self._lut(lut), c.data),
                          c.valid, CTString)
        if name in ("size", "length"):
            c = args[0]
            if c.kind == "list":
                return Column("int", c.lens.to(torch.int64), c.valid,
                              CTInteger)
            if c.kind == "str":
                lengths = self.pool.lengths_array()
                if lengths.shape[0] == 0:
                    return Column("int", torch.zeros(self.capacity,
                                                     dtype=torch.int64,
                                                     device=self.device),
                                  c.valid, CTInteger)
                return Column("int", _gather(self._lut(lengths), c.data),
                              c.valid, CTInteger)
            raise UnsupportedOnDevice(f"size() on kind {c.kind}")
        if name in ("e", "pi"):
            import math
            return self._literal(math.e if name == "e" else math.pi)
        raise UnsupportedOnDevice(f"function {name}() has no device path")


def _gather(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``table[codes]`` with codes clamped into range (padding rows carry
    code 0 and are masked by validity)."""
    return table[codes.clamp(0, table.shape[0] - 1).to(torch.int64)]
