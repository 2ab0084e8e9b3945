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

from caps_tpu_torch.backends.cuda import kernels as K
from caps_tpu_torch.backends.cuda.column import Column, kind_for
from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.okapi.types import (
    CTBoolean, CTFloat, CTInteger, CTNull, CTString, CypherType,
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
        if isinstance(e, E.Slice):
            return self._slice(e)
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
            if _is_null(c):
                return self._null()
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
        if v is None:
            return self._null()
        return literal_column(v, from_python(v), self.capacity, self.pool,
                              self.device)

    def _null(self) -> Column:
        """An all-null column of no value type: a null literal's (and a
        missing property's), and what a null-propagating function or
        operator gives for one.  Its kind is a placeholder that
        ``_promote`` swaps for the other operand's."""
        return Column("bool", self._full(False), self._full(False), CTNull)

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
        base = self.compile(e.expr)
        if base.kind != "list":
            raise UnsupportedOnDevice(f"indexing kind {base.kind}")
        idx = self.compile(e.idx)
        if idx.kind not in ("int", "id"):
            raise UnsupportedOnDevice("non-integer list index")
        i = idx.data.to(torch.int32)
        i = torch.where(i < 0, i + base.lens, i)  # negative = from the end
        inb = (i >= 0) & (i < base.lens)
        return self._element(base, i, idx.valid & inb)

    def _element(self, base: Column, i: torch.Tensor,
                 valid: torch.Tensor) -> Column:
        """Each row's element ``i`` of a list column (``valid`` says
        where ``i`` is in range), as a column of the element kind."""
        from caps_tpu_torch.backends.cuda.column import _DTYPES, list_elem_kind
        ek = list_elem_kind(base.ctype)
        if ek is None:
            raise UnsupportedOnDevice("indexing host-only list")
        inner = base.ctype.material.inner
        safe = i.clamp(0, base.data.shape[1] - 1).to(torch.int64)
        vals = base.data[torch.arange(self.capacity, device=self.device),
                         safe]
        valid = base.valid & valid
        if ek == "bool":
            return Column("bool", vals != 0, valid, inner)
        return Column(ek, vals.to(_DTYPES[ek]), valid, inner)

    def _list_function(self, name: str, c: Column) -> Column:
        """head / last / tail / reverse of a list column."""
        if c.kind != "list":
            raise UnsupportedOnDevice(f"{name}() on kind {c.kind}")
        n = c.lens.to(torch.int64)
        if name == "head":
            return self._element(c, torch.zeros_like(n), n > 0)
        if name == "last":
            return self._element(c, n - 1, n > 0)
        if name == "tail":
            return self._sublist(c, torch.ones_like(n), (n - 1).clamp(min=0),
                                 self._full(True))
        return self._sublist(c, n - 1, n, self._full(True), step=-1)

    def _sublist(self, base: Column, start: torch.Tensor,
                 length: torch.Tensor, valid: torch.Tensor,
                 step: int = 1) -> Column:
        """Each row's ``length`` elements of a list column from position
        ``start`` on (``step`` -1 walks backwards), left-aligned."""
        width = max(1, base.data.shape[1])
        j = torch.arange(width, device=self.device)[None, :]
        src = (start.to(torch.int64)[:, None] + step * j).clamp(0, width - 1)
        data = torch.gather(base.data, 1, src.expand(self.capacity, width))
        data = torch.where(j < length[:, None], data, torch.zeros_like(data))
        return Column("list", data, base.valid & valid, base.ctype,
                      length.to(torch.int32))

    def _slice(self, e) -> Column:
        """``list[lower..upper]``: from ``lower`` up to but not including
        ``upper``, each counted from the end when negative and clamped
        into the list."""
        base = self.compile(e.expr)
        if _is_null(base):
            return self._null()
        if base.kind != "list":
            raise UnsupportedOnDevice(f"slicing kind {base.kind}")
        n = base.lens.to(torch.int64)
        valid = self._full(True)

        def bound(x, default):
            nonlocal valid
            if x is None:
                return default
            c = self.compile(x)
            if _is_null(c):
                return None
            if c.kind not in ("int", "id"):
                raise UnsupportedOnDevice("non-integer slice bound")
            valid = valid & c.valid
            v = c.data.to(torch.int64)
            return torch.where(v < 0, v + n, v).clamp(min=0)

        lo = bound(e.lower, torch.zeros_like(n))
        hi = bound(e.upper, n)
        if lo is None or hi is None:
            return self._null()
        lo, hi = torch.minimum(lo, n), torch.minimum(hi, n)
        return self._sublist(base, lo, (hi - lo).clamp(min=0), valid)

    def _concat_lists(self, l: Column, r: Column) -> Column:
        """``a + b`` of two list columns of one element kind: each row's
        elements of ``a`` then those of ``b``."""
        from caps_tpu_torch.backends.cuda.column import list_elem_kind
        from caps_tpu_torch.okapi.types import CTList
        ek = list_elem_kind(l.ctype)
        if ek is None or ek != list_elem_kind(r.ctype):
            raise UnsupportedOnDevice("concatenation of lists of different "
                                      "element kinds")
        wl, wr = l.data.shape[1], r.data.shape[1]
        width = wl + wr
        jl = torch.arange(wl, device=self.device)[None, :]
        jr = torch.arange(wr, device=self.device)[None, :]
        data = torch.zeros((self.capacity, width + 1), dtype=torch.int32,
                           device=self.device)
        data[:, :wl] = torch.where(jl < l.lens[:, None], l.data,
                                   torch.zeros_like(l.data))
        # the right side's elements go after each row's left elements;
        # those past its length go to a spare last column
        dest = torch.where(jr < r.lens[:, None],
                           l.lens[:, None].to(torch.int64) + jr,
                           torch.full_like(jr, width))
        data.scatter_(1, dest.expand(self.capacity, wr),
                      r.data.expand(self.capacity, wr).to(torch.int32))
        inner = l.ctype.material.inner.join(r.ctype.material.inner)
        return Column("list", data[:, :width], l.valid & r.valid,
                      CTList(inner), l.lens + r.lens)

    def _concat_strings(self, e, l: Column, r: Column) -> Column:
        """``a + b`` of two strings, one of them a literal or parameter."""
        if isinstance(e.rhs, (E.Lit, E.Param)):
            v = self._constant(e.rhs)
            out = self._map_held(l, lambda s: s + v)
        elif isinstance(e.lhs, (E.Lit, E.Param)):
            v = self._constant(e.lhs)
            out = self._map_held(r, lambda s: v + s)
        else:
            raise UnsupportedOnDevice("concatenation of two string columns")
        return Column("str", out.data, l.valid & r.valid, CTString)

    def _held(self, c: Column):
        """The distinct codes that a string column's valid rows hold
        (sorted, on the device) and each row's position among them;
        None where no row is valid.  A function that makes new strings
        maps only these, so running a query again adds nothing to the
        pool (a table over the whole pool would map the last run's
        results too).  The caller reads them to the host: on the card,
        one device-to-host copy."""
        held = torch.unique(c.data[c.valid])
        if held.numel() == 0:
            return None, None
        pos = torch.searchsorted(held, c.data).clamp(max=held.numel() - 1)
        return held, pos

    def _map_held(self, c: Column, fn: Callable[[str], str]) -> Column:
        """fn of each string of a string column, new strings added to
        the pool (see :meth:`_held`)."""
        held, pos = self._held(c)
        if held is None:
            return Column("str", torch.zeros_like(c.data), c.valid, CTString)
        codes = self.pool.map_codes(held.cpu().numpy(), fn)
        return Column("str", self._lut(codes)[pos], c.valid, CTString)

    def _parse_strings(self, c: Column, name: str, fn, kind: str,
                       ctype: CypherType) -> Column:
        """A conversion of a string column: a lookup table over the pool
        (null where the string does not parse), applied as a gather."""
        from caps_tpu_torch.backends.cuda.column import _NP_DTYPES
        try:
            values, ok = self.pool.value_lut(name, fn, _NP_DTYPES[kind])
        except OverflowError:
            raise UnsupportedOnDevice(f"{name} of a string beyond int64")
        if values.shape[0] == 0:
            return self._null()
        return Column(kind, _gather(self._lut(values), c.data),
                      c.valid & _gather(self._lut(ok), c.data), ctype)

    def _to_string(self, arg: E.Expr, c: Column) -> Column:
        """toString of a string or boolean column, or of a number given
        as a literal or parameter."""
        if c.kind == "str":
            return c
        if c.kind == "bool":
            codes = torch.where(
                c.data, torch.full_like(c.data, self.pool.encode("true"),
                                        dtype=torch.int32),
                torch.full_like(c.data, self.pool.encode("false"),
                                dtype=torch.int32))
            return Column("str", codes, c.valid, CTString)
        if c.kind in ("int", "float") and isinstance(arg, (E.Lit, E.Param)):
            return self._literal(str(self._constant(arg)))
        raise UnsupportedOnDevice(f"toString on kind {c.kind}")

    def _string_function(self, name: str, e, c: Column) -> Column:
        """substring / left / right / replace / split of a string column
        with constant further arguments (see :meth:`_held`)."""
        if c.kind != "str":
            raise UnsupportedOnDevice(f"{name}() on kind {c.kind}")
        rest = [self._constant(a) for a in e.args[1:]]
        if any(v is None for v in rest):
            return self._null()
        fn = _STRING_FUNCTIONS[name](*rest)
        if name != "split":
            return self._map_held(c, fn)
        from caps_tpu_torch.okapi.types import CTList
        held, pos = self._held(c)
        if held is None:
            return Column("list", torch.zeros((self.capacity, 1),
                                              dtype=torch.int32,
                                              device=self.device),
                          c.valid, CTList(CTString),
                          torch.zeros_like(c.data, dtype=torch.int32))
        codes, lens = self.pool.list_codes(held.cpu().numpy(), fn)
        return Column("list", self._lut(codes)[pos], c.valid,
                      CTList(CTString), self._lut(lens)[pos])

    def _constant(self, e: E.Expr):
        """The host value of a literal or parameter expression."""
        if isinstance(e, E.Lit):
            return e.value
        if isinstance(e, E.Param):
            return self.params.get(e.name)
        if isinstance(e, E.Negate):
            v = self._constant(e.expr)
            return None if v is None else -v
        raise UnsupportedOnDevice(f"{type(e).__name__} is not a constant")

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
        if _is_null(l) or _is_null(r):
            # an all-null side takes the other side's kind and type (also
            # where its placeholder kind is the other's), so a result built
            # from both is typed by the side that holds values
            null, other = (l, r) if _is_null(l) else (r, l)
            null = Column(other.kind, torch.zeros_like(other.data),
                          null.valid, other.ctype,
                          None if other.lens is None
                          else torch.zeros_like(other.lens))
            return (null, other) if _is_null(l) else (other, null)
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
        if _is_null(l) or _is_null(r):
            return self._null()
        if l.kind == "str" and r.kind == "str":
            rank = self._lut(self.pool.rank_array())
            ld = _gather(rank, l.data) if rank.shape[0] else l.data
            rd = _gather(rank, r.data) if rank.shape[0] else r.data
        else:
            try:
                l2, r2 = self._promote(l, r)
            except UnsupportedOnDevice:
                if "list" in (l.kind, r.kind):
                    raise
                # values of incomparable types: the comparison is null
                return self._null()
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
        if _is_null(l):
            return self._null()
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
        if _is_null(l):
            # null IN a list is null, but false for an empty list
            rhs = self.compile(e.rhs)
            if _is_null(rhs):
                return self._null()
            if rhs.kind != "list":
                raise UnsupportedOnDevice(f"IN over kind {rhs.kind}")
            return Column("bool", self._full(False),
                          rhs.valid & (rhs.lens == 0), CTBoolean)
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
        elif l.kind == "bool":
            arr = self._lut(np.array(
                [int(v) for v in values if isinstance(v, bool)],
                dtype=np.int64))
            l = Column("int", l.data.to(torch.int64), l.valid, CTInteger)
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
        if _is_null(l) or _is_null(r):
            return self._null()
        if isinstance(e, E.Add) and l.kind == "str" and r.kind == "str":
            return self._concat_strings(e, l, r)
        if isinstance(e, E.Add) and l.kind == "list" and r.kind == "list":
            return self._concat_lists(l, r)
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
                # an invalid literal is a runtime error of every live row
                self._note_row_error(self._full(True), f"{name}(): {ex}")
                return self._null()
            return Column(kind, torch.full((self.capacity,), enc,
                                           dtype=torch.int64,
                                           device=self.device),
                          self._full(True), ct)
        args = [self.compile(a) for a in e.args]
        if any(_is_null(a) for a in args):
            # every function of the compiler returns null for a null
            # argument
            return self._null()

        unary_float = {"sqrt": K.sqrt_f64, "exp": torch.exp,
                       "log": torch.log, "log10": torch.log10,
                       "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
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
            if c.kind == "str":
                return self._parse_strings(c, "tointeger", _to_int,
                                           "int", CTInteger)
            raise UnsupportedOnDevice("toInteger on non-numeric")
        if name == "tofloat":
            c = args[0]
            if c.kind in ("int", "id", "float"):
                return c.astype_kind("float")
            if c.kind == "str":
                return self._parse_strings(c, "tofloat", _to_float,
                                           "float", CTFloat)
            raise UnsupportedOnDevice("toFloat on non-numeric")
        if name == "toboolean":
            c = args[0]
            if c.kind == "bool":
                return c
            if c.kind == "str":
                return self._parse_strings(c, "toboolean", _to_bool,
                                           "bool", CTBoolean)
            raise UnsupportedOnDevice(f"toBoolean on kind {c.kind}")
        if name == "tostring":
            return self._to_string(e.args[0], args[0])
        if name in _STRING_FUNCTIONS:
            return self._string_function(name, e, args[0])
        if name in ("head", "last", "tail") or (
                name == "reverse" and args[0].kind == "list"):
            return self._list_function(name, args[0])
        if name == "range":
            bounds = [self._constant(a) for a in e.args]
            if not all(isinstance(b, int) and not isinstance(b, bool)
                       for b in bounds) or len(bounds) not in (2, 3):
                raise UnsupportedOnDevice("range() of non-constant bounds")
            step = bounds[2] if len(bounds) == 3 else 1
            if step == 0:
                self._note_row_error(self._full(True), "range() step of 0")
                return self._const_list([])
            end = bounds[1] + (1 if step > 0 else -1)
            return self._const_list(list(range(bounds[0], end, step)))
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


# Functions of a string and constant further arguments, each given as a
# maker of the string -> value function (the oracle's semantics).
_STRING_FUNCTIONS: Dict[str, Callable] = {
    "substring": lambda start, length=None: (
        (lambda s: s[start:]) if length is None
        else (lambda s: s[start:start + length])),
    "left": lambda n: lambda s: s[:n],
    "right": lambda n: lambda s: s[-n:] if n > 0 else "",
    "replace": lambda find, repl: lambda s: s.replace(find, repl),
    "split": lambda sep: lambda s: s.split(sep),
}


def _to_int(s: str):
    """toInteger of a string: null where it does not parse."""
    try:
        return int(float(s)) if "." in s or "e" in s.lower() else int(s)
    except (ValueError, OverflowError):
        return None


def _to_float(s: str):
    try:
        return float(s)
    except ValueError:
        return None


def _to_bool(s: str):
    return {"true": True, "false": False}.get(s.lower())


def _is_null(c: Column) -> bool:
    """True for the all-null column of :meth:`DeviceExprCompiler._null`."""
    return c.ctype == CTNull


def _gather(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``table[codes]`` with codes clamped into range (padding rows carry
    code 0 and are masked by validity)."""
    return table[codes.clamp(0, table.shape[0] - 1).to(torch.int64)]
