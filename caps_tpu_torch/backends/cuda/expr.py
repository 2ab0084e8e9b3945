"""Expr → device column compiler.

The counterpart of ``caps_tpu/backends/tpu/expr.py`` (the analog of the
reference's ``SparkSQLExprMapper``, SURVEY.md §2): compiles okapi
expressions to (data, valid) column computations in torch with
3-valued null logic carried in validity masks.  String semantics ride the
StringPool: equality on codes, ordering via the rank array, literal string
predicates via per-pool lookup tables, unary string functions via mapping
LUTs.  List expressions (comprehensions, quantifiers, reduce, list
literals of columns, entity access inside a lambda) run in
:mod:`caps_tpu_torch.backends.cuda.lists`.  Anything without a device
representation raises :class:`UnsupportedOnDevice`; there is no host
fallback.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from caps_tpu_torch.backends.cuda import kernels as K
from caps_tpu_torch.backends.cuda.column import (
    Column, decode_any, elem_at, list_elem_kind, null_like, pad_width,
)
from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.okapi.types import (
    CTBoolean, CTDate, CTDateTime, CTDuration, CTFloat, CTInteger, CTNull,
    CTString, CypherType, _CTList,
)
from caps_tpu_torch.relational.header import RecordHeader


class UnsupportedOnDevice(Exception):
    """Raised when an expression/operator has no device path (yet).  The
    message names the operator; nothing falls back to the host."""


class DeviceExprCompiler:
    def __init__(self, columns: Mapping[str, Column], capacity: int,
                 header: RecordHeader, params: Mapping[str, Any], pool,
                 row_ok: torch.Tensor, backend=None, entity_ctx=None):
        from caps_tpu_torch.relational.ops import ENTITY_CTX_PARAM
        self.columns = columns
        self.capacity = capacity
        self.header = header
        self.params = dict(params)
        # the graph's entities, for property and label access on lambda
        # variables (lists.py EntityIndex)
        self.entity_ctx = self.params.pop(ENTITY_CTX_PARAM, entity_ctx)
        self.pool = pool
        self.row_ok = row_ok
        self.device = row_ok.device
        self.backend = backend
        # lambda variables in scope (lists.py Bound), by name: a child
        # compiler over a list's elements binds them; they shadow the
        # header's columns of the same name
        self.bound: Dict[str, Any] = {}
        # index lookups of id columns, by the column's data tensor
        self.lookups: Dict[tuple, Any] = {}
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

    def child(self, columns: Mapping[str, Column], capacity: int,
              row_ok: torch.Tensor, bound: Dict[str, Any]
              ) -> "DeviceExprCompiler":
        """A compiler over a lambda's rows (a list's elements, or one
        step of a reduce) with ``bound`` in scope."""
        c = DeviceExprCompiler(columns, capacity, self.header, self.params,
                               self.pool, row_ok, backend=self.backend,
                               entity_ctx=self.entity_ctx)
        c.bound = bound
        return c

    # ------------------------------------------------------------------

    def compile(self, e: E.Expr) -> Column:  # noqa: C901
        if self.bound:
            hit = L.bound_access(self, e)
            if hit is not None:
                return hit
        if self.header.has(e) and not (
                self.bound and L.mentions(e, self.bound)):
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
            return self._literal(v)
        if isinstance(e, E.ListLit):
            if not all(isinstance(i, (E.Lit, E.Param)) for i in e.items):
                return L.list_literal(self, e)
            return self._const_list([self._constant(i) for i in e.items])
        if isinstance(e, E.MapLit):
            return M.literal(self, e)
        if isinstance(e, E.Properties):
            return M.properties(self, e)
        if isinstance(e, E.Property):
            return self._property(e)
        if isinstance(e, E.ListComprehension):
            return L.comprehension(self, e)
        if isinstance(e, E.QuantifiedPredicate):
            return L.quantify(self, e)
        if isinstance(e, E.Reduce):
            return L.reduce(self, e)
        if isinstance(e, (E.Labels, E.Keys)):
            return L.labels_or_keys(self, e)
        if isinstance(e, E.PathNodes):
            return L.path_nodes(self, e)
        if isinstance(e, E.Disjoint):
            return L.disjoint(self, e)
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
            c = self._truth(self.compile(e.expr))
            return Column("bool", ~c.data, c.valid, CTBoolean)
        if isinstance(e, E.Xor):
            l = self._truth(self.compile(e.lhs))
            r = self._truth(self.compile(e.rhs))
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
            if c.kind == "duration":
                # the oracle has no negation of a duration: a type error
                self._note_row_error(c.valid, "bad operand type for unary "
                                     "-: 'CypherDuration'")
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
                c2, o2 = self._unify(c, out)
                out = self._choose(c2.valid, c2, o2)
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
        if isinstance(v, (list, tuple)):
            return self._const_list(list(v))
        if isinstance(v, dict):
            return M.constant(self, v)
        if v is None:
            return self._null()
        return literal_column(v, from_python(v), self.capacity, self.pool,
                              self.device)

    def _property(self, e: E.Property) -> Column:
        """``x.key`` of a value that is not a header entity: a map's
        entry, a temporal value's component, null for any other value
        (the oracle's lenient null)."""
        base = self.compile(e.entity)
        if _is_null(base):
            return self._null()
        if base.kind == "map":
            return M.field(self, base, e.key)
        if base.kind in ("date", "datetime", "duration"):
            v = T.component(base, e.key)
            if v is None:
                return self._null()
            return Column("int", v, base.valid, CTInteger)
        if base.kind == "any":
            return self._any_component(base, e.key)
        if base.kind == "id":
            raise UnsupportedOnDevice(f"no device rule for Property "
                                      f"{e.key!r} of an entity")
        return self._null()

    def _any_component(self, c: Column, key: str) -> Column:
        """``x.key`` of "any" values: a date's or datetime's component,
        null for the other kinds."""
        from caps_tpu_torch.backends.cuda.column import TAG
        out = self._null()
        for kind in ("date", "datetime", "duration"):
            if kind == "duration" and c.data.dim() == c.tags.dim():
                continue
            data = c.data if kind == "duration" else A.payload(c)
            v = T.component(Column(kind, data, c.valid, CTInteger), key)
            if v is None:
                continue
            hit = c.valid & (c.tags == TAG[kind])
            here = Column("int", v, hit, CTInteger)
            out = here if _is_null(out) else self._choose(hit, here, out)
        return out

    def _null(self) -> Column:
        """An all-null column of no value type: a null literal's (and a
        missing property's), and what a null-propagating function or
        operator gives for one.  Its kind is a placeholder that
        ``_promote`` swaps for the other operand's."""
        return Column("bool", self._full(False), self._full(False), CTNull)

    def _const_list(self, values) -> Column:
        """A constant list value broadcast to every row (literal lists and
        list parameters); a null element is marked in ``elem_valid``."""
        from caps_tpu_torch.backends.cuda.column import (
            _NP_DTYPES, encode_any, encode_list_elem, put_payload,
        )
        from caps_tpu_torch.okapi.types import from_python
        from caps_tpu_torch.okapi.values import CypherDuration
        ctype = from_python(values)   # (``[]``: a list of no type)
        inner = ctype.material.inner
        if isinstance(inner.material, _CTList):
            return self._const_nested(values, ctype)
        ek = list_elem_kind(ctype)
        if ek is None and all(v is None for v in values):
            ek = "int"  # only nulls: no value to type the elements
        if ek is None:
            raise UnsupportedOnDevice(f"list of {inner!r} on device")
        if ek == "map":
            return M.stack(self, [self._literal(v) for v in values])
        width = max(1, len(values))
        wide = ek == "duration" or ek == "any" and any(
            isinstance(v, CypherDuration) for v in values)
        codes = np.zeros((width, 3) if wide else width, dtype=_NP_DTYPES[ek])
        tags = np.zeros(width, dtype=np.int8)
        ok = np.ones(width, dtype=bool)
        try:
            for i, v in enumerate(values):
                if v is None:
                    ok[i] = False
                elif ek == "any":
                    tags[i], code = encode_any(v, self.pool)
                    put_payload(codes, i, code)
                else:
                    codes[i] = encode_list_elem(v, ek, self.pool)
        except (ValueError, OverflowError) as ex:
            raise UnsupportedOnDevice(str(ex))

        def rows(a):
            return self._lut(a)[None].expand(self.capacity, *a.shape)

        lens = torch.full((self.capacity,), len(values), dtype=torch.int32,
                          device=self.device)
        return Column("list", rows(codes), self._full(True), ctype, lens,
                      elem_valid=None if ok.all() else rows(ok),
                      tags=rows(tags) if ek == "any" else None)

    def _const_nested(self, values, ctype) -> Column:
        """A constant list of lists, at any depth, broadcast to every row:
        its inner lists built once as a child column (a null inner list
        is a null element), every row pointing at them."""
        from caps_tpu_torch.backends.cuda.column import make_column
        try:
            col = make_column([values], ctype, 1, self.pool, self.device)
        except (ValueError, OverflowError) as ex:
            raise UnsupportedOnDevice(str(ex))
        return col.take(torch.zeros(self.capacity, dtype=torch.int64,
                                    device=self.device))

    def _index(self, e) -> Column:
        base = self.compile(e.expr)
        if base.kind == "map" and isinstance(e.idx, (E.Lit, E.Param)) \
                and isinstance(self._constant(e.idx), str):
            return M.field(self, base, self._constant(e.idx))
        if _is_null(base) or base.kind not in ("list", "map"):
            return self._null()  # the oracle's index of any other value
        if base.kind == "map":
            return self._map_entry(base, self.compile(e.idx))
        idx = self.compile(e.idx)
        if _is_null(idx):
            return self._null()
        if idx.kind not in ("int", "id", "float", "bool"):
            raise UnsupportedOnDevice("non-integer list index")
        # the oracle's int(i): a float truncates, a boolean is 0 or 1
        i = idx.data.to(torch.int64).to(torch.int32)
        i = torch.where(i < 0, i + base.lens, i)  # negative = from the end
        inb = (i >= 0) & (i < base.lens)
        return self._element(base, i, idx.valid & inb)

    def _map_entry(self, m: Column, key: Column) -> Column:
        """``m[key]`` with a column key: each row the entry its key
        names, null where the map lacks it or the key is not a
        string."""
        out = self._null()
        if key.kind != "str":
            return out
        for k in m.fields:
            here = key.valid & (key.data == self.pool.encode(k))
            v = M.field(self, m, k)
            v = dataclasses.replace(v, valid=v.valid & here)
            v, out = self._unify(v, out)
            out = self._choose(here, v, out)
        return out

    def _element(self, base: Column, i: torch.Tensor,
                 valid: torch.Tensor) -> Column:
        """Each row's element ``i`` of a list column (``valid`` says
        where ``i`` is in range), as a column of the element kind."""
        safe = i.clamp(0, base.data.shape[1] - 1).to(torch.int64)
        rows = torch.arange(self.capacity, device=self.device)
        return elem_at(base, rows, safe, base.valid & valid)

    def _list_function(self, name: str, c: Column) -> Column:
        """head / last / tail / reverse of a list column; head / last of
        a string is its first / last character (the oracle's ``v[0]``),
        null for the empty string."""
        if c.kind == "str" and name == "tail":
            return self._held_string_lists([c.data], c.valid, lambda rows: [
                list(t[1:]) for t in self.pool.decode_many(rows[:, 0])])
        if c.kind == "str" and name in ("head", "last"):
            lengths = self.pool.lengths_array()
            filled = c.valid if lengths.shape[0] == 0 else \
                c.valid & (_gather(self._lut(lengths), c.data) > 0)
            out = self._map_held(dataclasses.replace(c, valid=filled),
                                 (lambda s: s[:1]) if name == "head"
                                 else (lambda s: s[-1:]))
            return Column("str", out.data, filled, CTString)
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
        ``start`` on (``step`` -1 walks backwards), left-aligned: every
        per-element tensor (inner lists, map entries, tags) gathered
        along the list axis."""
        width = max(1, base.data.shape[1])
        j = torch.arange(width, device=self.device)[None, :]
        src = (start.to(torch.int64)[:, None] + step * j).clamp(0, width - 1)
        src = src.expand(self.capacity, width)
        keep = j < length[:, None]

        def pick(t, fill=0):
            if t is None:
                return None
            at = src.view(*src.shape, *([1] * (t.dim() - 2))).expand(
                src.shape + t.shape[2:])
            out = torch.gather(t, 1, at)
            k = keep.view(*keep.shape, *([1] * (t.dim() - 2)))
            return torch.where(k, out, torch.full_like(out, fill))

        return dataclasses.replace(
            base, data=pick(base.data), valid=base.valid & valid,
            lens=length.to(torch.int32), host=None,
            elem_valid=pick(base.elem_valid, True), tags=pick(base.tags),
            fields=(None if base.fields is None else {
                k: self._sublist(c, start, length, valid, step)
                for k, c in base.fields.items()}))

    def _slice(self, e) -> Column:
        """``list[lower..upper]``: from ``lower`` up to but not including
        ``upper``, each counted from the end when negative and clamped
        into the list."""
        base = self.compile(e.expr)
        if _is_null(base):
            return self._null()
        if base.kind == "str":
            return self._slice_string(base, e)
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

    def _slice_string(self, s: Column, e) -> Column:
        """``s[lower..upper]`` of a string: the oracle slices it and
        lists the characters (``list(s[lo:hi])``); a null bound is no
        bound.  Each held (string, bounds) row is sliced once."""
        planes, present = [s.data], []
        for x in (e.lower, e.upper):
            c = None if x is None else self.compile(x)
            if c is None or _is_null(c):
                present.append(False)
                continue
            if c.kind not in ("int", "id"):
                raise UnsupportedOnDevice("non-integer slice bound")
            present.append(True)
            planes += [c.data, c.valid]

        def apply(rows):
            out = []
            for r, text in zip(rows.tolist(),
                               self.pool.decode_many(rows[:, 0])):
                at, bounds = 1, []
                for here in present:
                    bounds.append(r[at] if here and r[at + 1] else None)
                    at += 2 if here else 0
                lo, hi = bounds
                out.append(list(text[(lo if lo is not None else 0):
                                     (hi if hi is not None
                                      else len(text))]))
            return out
        return self._held_string_lists(planes, s.valid, apply)

    def _concat_lists(self, l: Column, r: Column) -> Column:
        """``a + b`` of two list columns of one element kind: each row's
        elements of ``a`` then those of ``b`` (of two lists of lists of
        one depth: over both sides' inner lists)."""
        from caps_tpu_torch.backends.cuda.table import share_child
        from caps_tpu_torch.okapi.types import CTList
        l, r = _nest_like(l, r)
        if l.nested and r.nested and l.depth == r.depth:
            l, r = share_child(l, r)
        elif l.elem_kind != r.elem_kind and not (
                l.fields or r.fields or l.nested or r.nested):
            l, r = A.list_to_any(l), A.list_to_any(r)
        if l.tags is not None and l.data.dim() != r.data.dim():
            l, r = A.widen(l), A.widen(r)
        if l.elem_kind != r.elem_kind or l.fields is not None \
                or l.nested != r.nested:
            raise UnsupportedOnDevice("concatenation of lists of different "
                                      "element kinds")
        wl, wr = l.data.shape[1], r.data.shape[1]
        width = wl + wr
        jl = torch.arange(wl, device=self.device)[None, :]
        jr = torch.arange(wr, device=self.device)[None, :]
        # the right side's elements go after each row's left elements;
        # those past its length go to a spare last column
        dest = torch.where(jr < r.lens[:, None],
                           l.lens[:, None].to(torch.int64) + jr,
                           torch.full_like(jr, width))
        dest = dest.expand(self.capacity, wr)

        def concat(a, b, fill):
            # (an element may be a row of its own: a duration's fields)
            rest = a.shape[2:]
            tail = (1,) * len(rest)
            out = torch.full((self.capacity, width + 1) + rest, fill,
                             dtype=a.dtype, device=self.device)
            out[:, :wl] = torch.where(
                (jl < l.lens[:, None]).view(-1, wl, *tail), a,
                torch.full_like(a, fill))
            at = dest.view(-1, wr, *tail).expand(self.capacity, wr, *rest)
            return out.scatter_(1, at, b.expand(self.capacity, wr, *rest))[
                :, :width]

        ev = None
        if l.elem_valid is not None or r.elem_valid is not None:
            ev = concat(l.valid_elems(), r.valid_elems(), True)
        inner = l.ctype.material.inner.join(r.ctype.material.inner)
        return Column("list", concat(l.data, r.data, 0), l.valid & r.valid,
                      CTList(inner), l.lens + r.lens, elem_valid=ev,
                      tags=(None if l.tags is None
                            else concat(l.tags, r.tags, 0)), child=l.child)

    def _concat_strings(self, e, l: Column, r: Column) -> Column:
        """``a + b`` of two strings: one of them a literal or parameter
        maps the other column's held strings; two columns concatenate
        their held (left, right) pairs (:meth:`_held_rows`)."""
        if isinstance(e.rhs, (E.Lit, E.Param)):
            v = self._constant(e.rhs)
            out = self._map_held(l, lambda s: s + v)
        elif isinstance(e.lhs, (E.Lit, E.Param)):
            v = self._constant(e.lhs)
            out = self._map_held(r, lambda s: v + s)
        else:
            # one int64 key per (left, right) pair of codes
            out = self._format_held(
                [l.data.to(torch.int64) * (1 << 31) + r.data],
                l.valid & r.valid, self._pair_text)
        return Column("str", out.data, l.valid & r.valid, CTString)

    def _held(self, values: torch.Tensor, ok: torch.Tensor):
        """The distinct values of the rows ``ok`` read to the host
        (sorted) and each row's position among them.  A function that
        makes new strings maps only these, so running a query again
        adds nothing to the pool (a table over the whole pool would map
        the last run's results too).  On the card the read is one
        device-to-host copy, counted in the backend's ``held_reads``."""
        held = torch.unique(values[ok])
        pos = torch.searchsorted(held, values).clamp(
            max=max(held.numel() - 1, 0))
        return self._read_held(held), pos

    def _read_held(self, t: torch.Tensor) -> np.ndarray:
        """One device-to-host read of held values, counted."""
        if self.backend is not None:
            self.backend.held_reads += 1
        return t.cpu().numpy()

    def _map_held(self, c: Column, fn: Callable[[str], str]) -> Column:
        """fn of each string of a string column, new strings added to
        the pool (see :meth:`_held`)."""
        return self._format_held([c.data], c.valid, lambda rows: [
            fn(s) for s in self.pool.decode_many(rows[:, 0])])

    def _format_held(self, planes, valid: torch.Tensor, fn) -> Column:
        """A string per row made from the row's values of ``planes``
        (int64 tensors, or an int64 matrix for a value of several
        planes): the distinct value rows that the valid live rows hold
        go to the host in one counted read, ``fn`` formats them (an
        int64 matrix, a row per value, to a list of strings), they are
        encoded into the pool, and the rows gather their codes.
        A held value that the pool already has adds nothing, so running
        the query again adds no string."""
        rows, pos = self._held_planes(planes, valid)
        strings = fn(rows) if len(rows) else []
        if not strings:
            return Column("str", torch.zeros_like(valid, dtype=torch.int32),
                          valid, CTString)
        codes = np.array(self.pool.encode_many(strings), dtype=np.int32)
        return Column("str", self._lut(codes)[pos], valid, CTString)

    def _held_string_lists(self, planes, valid: torch.Tensor,
                           fn) -> Column:
        """A list of strings per row made from the row's values of
        ``planes`` as :meth:`_format_held` makes a string: ``fn`` maps
        the held rows to lists of strings."""
        from caps_tpu_torch.okapi.types import CTList
        rows, pos = self._held_planes(planes, valid)
        if not len(rows):
            return Column("list", torch.zeros((self.capacity, 1),
                                              dtype=torch.int32,
                                              device=self.device),
                          valid, CTList(CTString),
                          torch.zeros_like(valid, dtype=torch.int32))
        codes, lens = self.pool.string_lists(fn(rows))
        return Column("list", self._lut(codes)[pos], valid,
                      CTList(CTString), self._lut(lens)[pos])

    def _decide_held(self, planes, valid: torch.Tensor, fn) -> Column:
        """A boolean per row decided from the row's values of ``planes``
        as :meth:`_format_held` makes a string: ``fn`` maps the held rows
        to booleans."""
        rows, pos = self._held_planes(planes, valid)
        if not len(rows):
            return Column("bool", self._full(False), valid, CTBoolean)
        lut = self._lut(np.array(fn(rows), dtype=bool))
        return Column("bool", lut[pos], valid, CTBoolean)

    def _held_planes(self, planes, valid: torch.Tensor):
        """(held rows, each row's position among them) of the values
        of ``planes`` (int64 tensors, or int64 matrices for a value of
        several planes) that the valid live rows hold: an int64 matrix,
        a row per distinct value, read in one counted transfer."""
        ok = valid & self.row_ok
        cols = [c for p in planes for c in (
            p.to(torch.int64).unbind(1) if p.dim() == 2
            else (p.to(torch.int64),))]
        if len(cols) == 1:
            held, pos = self._held(cols[0], ok)
            return held[:, None], pos
        return self._held_rows(cols, ok)

    def _held_rows(self, cols, ok: torch.Tensor):
        """The distinct rows of several int64 planes among the rows
        ``ok`` (read to the host, counted) and each row's position among
        them: a stable sort by the planes, the neighbours that differ,
        their running count scattered back."""
        keys = [(~ok).to(torch.int64)] + [torch.where(ok, c,
                                                      torch.zeros_like(c))
                                          for c in cols]
        perm = K.sort_perm(keys, self.capacity)
        ordered = [k[perm] for k in keys]
        change = K.neighbor_change_keys(ordered) & ~ordered[0].bool()
        group = torch.cumsum(change.to(torch.int64), 0) - 1
        pos = torch.empty_like(group)
        pos[perm] = group.clamp(min=0)
        rows = self._read_held(torch.stack(ordered[1:], dim=1)[change])
        return rows, pos

    def _convert_any(self, c: Column, name: str) -> Column:
        """toInteger / toFloat / toBoolean of "any" values, row by row
        by kind, as each kind's own conversion: strings parse, numbers
        convert (an integer of a float truncates), a boolean is itself
        to toBoolean and null to the others, other values null."""
        from caps_tpu_torch.backends.cuda.column import TAG
        out = self._null()
        for kind in ("str", "int", "float", "bool"):
            hit = c.valid & (c.tags == TAG[kind])
            p = A.payload(c)
            data = (p.to(torch.int32) if kind == "str" else
                    A.bits_float(p) if kind == "float" else
                    p.to(torch.bool) if kind == "bool" else p)
            ctype = {"str": CTString, "int": CTInteger, "float": CTFloat,
                     "bool": CTBoolean}[kind]
            part = self._function(E.FunctionExpr(name, (E.Var("_x"),)),
                                  {"_x": Column(kind, data, hit, ctype)})
            if _is_null(part):
                continue
            part = dataclasses.replace(part, valid=part.valid & hit)
            part, out = self._unify(part, out)
            out = self._choose(hit, part, out)
        return out

    def _parse_strings(self, c: Column, name: str, fn, kind: str,
                       ctype: CypherType) -> Column:
        """A conversion of a string column: a lookup table over the pool
        (null where the string does not parse), applied as a gather."""
        from caps_tpu_torch.backends.cuda.column import _NP_DTYPES
        if kind == "int":
            # a string whose integer lies beyond int64 has no device
            # value: an error of the rows that hold one
            big, _ok = self.pool.value_lut(
                f"{name}#big", lambda s: _beyond_int64(fn(s)), np.bool_)
            if big.shape[0]:
                self._note_row_error(c.valid & _gather(self._lut(big),
                                                       c.data),
                                     f"{name}() of a string beyond int64")
            fn = _within_int64(fn)
        values, ok = self.pool.value_lut(name, fn, _NP_DTYPES[kind])
        if values.shape[0] == 0:
            return self._null()
        return Column(kind, _gather(self._lut(values), c.data),
                      c.valid & _gather(self._lut(ok), c.data), ctype)

    def _to_string(self, c: Column) -> Column:
        """toString of a column: a string is itself, a boolean 'true' or
        'false'; numbers, temporal values and "any" values format their
        held values on the host (:meth:`_format_held`) as the oracle's
        ``_to_str`` does (``str`` of the number, ``iso()`` of the
        temporal value)."""
        if c.kind == "str":
            return c
        if c.kind == "bool":
            codes = torch.where(
                c.data, torch.full_like(c.data, self.pool.encode("true"),
                                        dtype=torch.int32),
                torch.full_like(c.data, self.pool.encode("false"),
                                dtype=torch.int32))
            return Column("str", codes, c.valid, CTString)
        from caps_tpu_torch.okapi import values as V
        if c.kind == "float":
            planes = [c.data.contiguous().view(torch.int64)]
        elif c.kind == "any":
            planes = [c.tags, c.data]   # (the payload may be 3-wide)
        elif c.kind in ("int", "date", "datetime", "duration"):
            planes = [c.data]
        elif c.kind == "list" and not (c.nested or c.fields) \
                and c.elem_kind in ("int", "id", "float", "str", "bool"):
            return self._list_text(c)
        else:
            raise UnsupportedOnDevice(f"toString on kind {c.kind}")
        one = {"int": str, "date": lambda d: V.CypherDate(d).iso(),
               "datetime": lambda us: V.CypherDateTime(us).iso()}

        def fmt(rows):
            if c.kind == "float":
                return [str(v) for v in rows[:, 0].view(np.float64).tolist()]
            if c.kind == "duration":
                return [V.CypherDuration(*r).iso() for r in rows.tolist()]
            if c.kind == "any":
                return [_text(v) for v in decode_any(
                    rows[:, 0].astype(np.int8),
                    rows[:, 1] if rows.shape[1] == 2 else rows[:, 1:],
                    self.pool)]
            return [one[c.kind](v) for v in rows[:, 0].tolist()]
        return self._format_held(planes, c.valid, fmt)

    def _list_text(self, c: Column) -> Column:
        """toString of a list of numbers, strings or booleans: the
        oracle's ``str`` of the Python list, a null element ``None``.
        Each held (length, elements, their validity) row is formatted
        once."""
        ek = c.elem_kind
        data = c.data.contiguous().view(torch.int64) if ek == "float" \
            else c.data.to(torch.int64)
        W = data.shape[1]

        def fmt(rows):
            out = []
            for r in rows.tolist():
                n, vals, oks = r[0], r[1:1 + W], r[1 + W:]
                items = []
                for v, ok in zip(vals[:n], oks[:n]):
                    if not ok:
                        items.append(None)
                    elif ek == "float":
                        items.append(float(np.int64(v).view(np.float64)))
                    elif ek == "str":
                        items.append(self.pool.decode(v))
                    elif ek == "bool":
                        items.append(bool(v))
                    else:
                        items.append(v)
                out.append(str(items))
            return out
        return self._format_held([c.lens, data, c.valid_elems()], c.valid,
                                 fmt)

    def _pair_text(self, rows: np.ndarray):
        """The concatenations of (left, right) string code pairs packed
        as ``left << 31 | right``."""
        keys = rows[:, 0]
        left = self.pool.decode_many(keys >> 31)
        right = self.pool.decode_many(keys & ((1 << 31) - 1))
        return [a + b for a, b in zip(left, right)]

    def _string_function(self, name: str, e, args) -> Column:
        """substring / left / right / replace / split of a string column.
        Constant further arguments make one function of the string
        (see :meth:`_held`); column arguments go to the host with the
        string as further planes of its held rows, so each distinct
        (string, arguments) row is computed once."""
        c = args[0]
        if c.kind != "str":
            raise UnsupportedOnDevice(f"{name}() on kind {c.kind}")
        consts = [self._fold(a) for a in e.args[1:]]
        if all(k is not None for k in consts):
            rest = [k[0] for k in consts]
            if any(v is None for v in rest):
                return self._null()
            fn = _STRING_FUNCTIONS[name](*rest)
            if name != "split":
                return self._map_held(c, fn)
            planes, valid = [c.data], c.valid

            def apply(rows):
                return [fn(s) for s in self.pool.decode_many(rows[:, 0])]
        else:
            want = "str" if name in ("replace", "split") else "int"
            for a in args[1:]:
                if a.kind not in ((want,) if want == "str"
                                  else ("int", "id")):
                    raise UnsupportedOnDevice(
                        f"{name}() with an argument of kind {a.kind}")
            # substring's null length means no length (the oracle's
            # ``s[start:]``): its validity rides as one more plane
            open_end = name == "substring" and len(args) == 3
            planes = [c.data] + [a.data for a in args[1:]]
            valid = c.valid
            for a in args[1:2] if open_end else args[1:]:
                valid = valid & a.valid
            if open_end:
                planes.append(args[2].valid)

            def apply(rows):
                cols = [self.pool.decode_many(rows[:, i]) if i == 0
                        or want == "str" else rows[:, i].tolist()
                        for i in range(rows.shape[1])]
                if open_end:
                    cols = cols[:2] + [[n if ok else None for n, ok in
                                        zip(cols[2], cols[3])]]
                return [_STRING_FUNCTIONS[name](*vals[1:])(vals[0])
                        for vals in zip(*cols)]
        if name != "split":
            return self._format_held(planes, valid, apply)
        return self._held_string_lists(planes, valid, apply)

    def _constant(self, e: E.Expr):
        """The host value of a literal or parameter expression (or of a
        map or list literal of them)."""
        if isinstance(e, E.Lit):
            return e.value
        if isinstance(e, E.Param):
            return self.params.get(e.name)
        if isinstance(e, E.Negate):
            v = self._constant(e.expr)
            return None if v is None else -v
        if isinstance(e, E.MapLit):
            return {k: self._constant(v) for k, v in zip(e.keys, e.values)}
        if isinstance(e, E.ListLit):
            return [self._constant(v) for v in e.items]
        raise UnsupportedOnDevice(f"{type(e).__name__} is not a constant")

    def _fold(self, e: E.Expr):
        """(value,) of a constant expression, None for any other."""
        try:
            return (self._constant(e),)
        except UnsupportedOnDevice:
            return None

    def _temporal_function(self, name: str, args) -> Column:
        """date() / datetime() / localdatetime() / duration() (the
        oracle's ``temporal_construct``): a constant argument folds once
        here; a column converts on the device (a datetime to its date, a
        date to its midnight, a string through a table over the pool, a
        map literal of component columns through ``temporal.py``).  A
        malformed value is an error of its row."""
        from caps_tpu_torch.okapi.values import temporal_construct
        target = {"localdatetime": "datetime"}.get(name, name)
        if not args:
            self._note_row_error(
                self._full(True), f"{name}() without an argument (current "
                "time) is non-deterministic and not supported")
            return self._null()
        arg = args[0]
        const = self._fold(arg)
        if const is not None:
            if const[0] is None:
                return self._null()
            try:
                return self._literal(temporal_construct(name, const[0]))
            except (ValueError, TypeError, KeyError, OverflowError) as ex:
                self._note_row_error(self._full(True), f"{name}(): {ex}")
                return self._null()
        if isinstance(arg, E.MapLit):
            parts = {}
            for k, v in zip(arg.keys, arg.values):
                c = self.compile(v)
                parts[k] = Column("int", torch.zeros(
                    self.capacity, dtype=torch.int64, device=self.device),
                    self._full(False), CTInteger) if _is_null(c) else c
            ints = T.int_parts(parts)
            if ints is None:
                raise UnsupportedOnDevice(f"{name}() of a map of "
                                          f"non-numeric components")
            col, bad, what = T.construct(target, ints, self._full(True),
                                         self.device)
            self._note_row_error(bad, what)
            col.valid = ~bad
            return col
        c = self.compile(arg)
        if _is_null(c):
            return self._null()
        if c.kind == target:
            return c
        if target == "date" and c.kind == "datetime":
            return Column("date", T.to_date(c), c.valid, CTDate)
        if target == "datetime" and c.kind == "date":
            return Column("datetime", c.data * T.US_PER_DAY, c.valid,
                          CTDateTime)
        if c.kind == "str":
            return self._parse_temporal(name, target, c)
        if c.kind == "map":
            return self._temporal_of_map(name, target, c)
        if c.kind == "any":
            return self._temporal_of_any(name, target, c)
        self._note_row_error(c.valid, f"cannot construct {name}() from a "
                             f"{c.kind}")
        return self._null()

    def _temporal_of_any(self, name: str, target: str, c: Column) -> Column:
        """date() / datetime() of "any" values, row by row by kind: a
        string parses, a date or datetime converts; another value is an
        error of its row, as the oracle's ``temporal_construct``."""
        from caps_tpu_torch.backends.cuda.column import TAG
        out = None
        kinds = ("str",) if target == "duration" else ("str", "date",
                                                       "datetime")
        for kind in kinds:
            hit = c.valid & (c.tags == TAG[kind])
            p = A.payload(c)
            src = Column(kind, p.to(torch.int32) if kind == "str" else p,
                         hit, CTString)
            if kind == "str":
                got = self._parse_temporal(name, target, src)
            elif kind == target:
                got = src
            elif kind == "datetime":
                got = Column("date", T.to_date(src), hit, CTDate)
            else:
                got = Column("datetime", src.data * T.US_PER_DAY, hit,
                             CTDateTime)
            if _is_null(got):
                continue
            out = got if out is None else self._choose(hit, got, out)
        other = c.valid
        for kind in kinds:
            other = other & (c.tags != TAG[kind])
        self._note_row_error(other, f"cannot construct {name}() from a "
                             f"value of another type")
        return self._null() if out is None else out

    def _temporal_of_map(self, name: str, target: str, m: Column) -> Column:
        """date() / datetime() / duration() of a map column: each key a
        component, a key a row lacks taking its default (none for the
        year, which that row then lacks); the map literal's rules
        otherwise (``temporal.py construct``)."""
        defaults = dict(T._DATE_PARTS + T._DATETIME_PARTS)
        parts, missing = {}, self._full(False)
        for k, child in m.fields.items():
            present = m.data[:, list(m.fields).index(k)]
            if _is_null(child):
                child = Column("int", torch.zeros(
                    self.capacity, dtype=torch.int64, device=self.device),
                    self._full(False), CTInteger)
            ints = T.int_parts({k: child})
            if ints is None:
                raise UnsupportedOnDevice(f"{name}() of a map of "
                                          f"non-numeric components")
            v = ints[k]
            if k == "year" and target != "duration":
                missing = ~present
            fill = 0 if target == "duration" else (defaults.get(k) or 0)
            data = torch.where(present, v.data,
                               torch.full_like(v.data, fill))
            parts[k] = Column("int", data, torch.where(
                present, v.valid, self._full(True)), CTInteger)
        col, bad, what = T.construct(target, parts, m.valid, self.device)
        bad = bad | (missing & m.valid)
        self._note_row_error(bad, what)
        col.valid = m.valid & ~bad
        return col

    def _parse_temporal(self, name: str, target: str, c: Column) -> Column:
        """date() / datetime() / duration() of a string column: a table
        over the pool per plane; a string that does not parse is an
        error of its row."""
        from caps_tpu_torch.okapi.values import temporal_construct

        def plane(i):
            def parse(s):
                try:
                    v = temporal_construct(name, s)
                except ValueError:
                    return None
                return ((v.months, v.days, v.seconds)[i]
                        if target == "duration" else
                        v.days if target == "date" else v.micros)
            return self.pool.value_lut(f"{name}#{i}", parse, np.int64)

        n = 3 if target == "duration" else 1
        luts = [plane(i) for i in range(n)]
        if luts[0][0].shape[0] == 0:
            return self._null()
        ok = _gather(self._lut(luts[0][1]), c.data)
        self._note_row_error(c.valid & ~ok, f"{name}(): a string that is "
                             f"not a {target}")
        planes = [_gather(self._lut(v), c.data) for v, _ok in luts]
        data = planes[0] if n == 1 else torch.stack(planes, dim=1)
        ctype = {"date": CTDate, "datetime": CTDateTime,
                 "duration": CTDuration}[target]
        return Column(target, data, c.valid & ok, ctype)

    def as_bool(self, c: Column, other: bool = False) -> Column:
        """A boolean column of ``c``: a boolean is itself (so is a
        boolean among "any" values), any other value ``other`` (False:
        not true, as the oracle's ``is True`` tests read it)."""
        if c.kind == "bool" or _is_null(c):
            return c
        data = torch.full_like(c.valid, other)
        if c.kind == "any":
            from caps_tpu_torch.backends.cuda.column import TAG
            data = torch.where(c.tags == TAG["bool"], A.payload(c) != 0,
                               data)
        return Column("bool", data, c.valid, CTBoolean)

    def _truth(self, c: Column) -> Column:
        """A value's truth as the oracle's ``not v`` / ``bool(v)`` read
        it: a boolean itself, a number not zero, a string, list or map
        not empty, a temporal value always."""
        if c.kind == "bool" or _is_null(c):
            return c
        from caps_tpu_torch.backends.cuda.column import TAG
        if c.kind == "str":
            lengths = self.pool.lengths_array()
            data = self._full(False) if lengths.shape[0] == 0 else \
                _gather(self._lut(lengths), c.data) > 0
        elif c.kind in ("int", "id", "float"):
            data = c.data != 0
        elif c.kind == "list":
            data = c.lens > 0
        elif c.kind == "map":
            data = (c.data & c.valid[:, None]).any(dim=1)
        elif c.kind == "any":
            p = A.payload(c)
            text = self._truth(Column("str", p.to(torch.int32), c.valid,
                                      CTString)).data
            num = torch.where(c.tags == TAG["float"], A.bits_float(p) != 0,
                              p != 0)
            data = torch.where(
                (c.tags == TAG["str"]) | (c.tags == TAG["int"])
                | (c.tags == TAG["float"]) | (c.tags == TAG["bool"]),
                torch.where(c.tags == TAG["str"], text, num),
                self._full(True))
        else:
            data = self._full(True)
        return Column("bool", data, c.valid, CTBoolean)

    def _and_or(self, exprs, is_and: bool) -> Column:
        # a value that is not a boolean is neither false nor null to the
        # oracle: true-like in AND, false-like in OR
        cols = [self.as_bool(self.compile(x), other=is_and) for x in exprs]
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
            null = null_like(other, null.valid)
            return (null, other) if _is_null(l) else (other, null)
        if l.kind == r.kind:
            return l, r
        numeric = {"id", "int", "float"}
        if l.kind in numeric and r.kind in numeric:
            if "float" in (l.kind, r.kind):
                return l.astype_kind("float"), r.astype_kind("float")
            return l.astype_kind("int"), r.astype_kind("int")
        if "any" in (l.kind, r.kind) and {l.kind, r.kind} <= set(
                A.HELD_KINDS + ("any",)):
            return A.to_any(l), A.to_any(r)
        raise UnsupportedOnDevice(f"cannot compare kinds {l.kind}/{r.kind}")

    def _rank(self) -> torch.Tensor:
        if self.backend is not None:
            return self.backend.rank_tensor()
        return self._lut(self.pool.rank_array())

    def equal_cols(self, l: Column, r: Column):
        """``cypher_equals`` of two columns as (equal, known): ``known``
        False where the answer is null (a null operand, or a null among
        the elements or entries it hangs on)."""
        valid = l.valid & r.valid
        if l.kind == "list" or r.kind == "list":
            eq, known = self._list_equal(l, r)
            return eq, valid & known
        if l.kind == "map" or r.kind == "map":
            if l.kind != r.kind:
                return self._full(False), valid
            eq, known = M.equal(l, r, self.equal_cols)
            return eq, valid & known
        if _is_null(l) or _is_null(r):
            return self._full(False), valid
        if "any" in (l.kind, r.kind):
            return A.equal(l, r, self._rank()), valid
        if l.kind == "duration" and r.kind == "duration":
            return (l.data == r.data).all(dim=1), valid
        try:
            l2, r2 = self._promote(l, r)
            eq = l2.data == r2.data
        except UnsupportedOnDevice:
            # mismatched kinds: never equal
            eq = self._full(False)
        return eq, valid

    def _equality(self, e) -> Column:
        eq, valid = self.equal_cols(self.compile(e.lhs), self.compile(e.rhs))
        if isinstance(e, E.NotEquals):
            eq = ~eq
        return Column("bool", eq, valid, CTBoolean)

    def _list_equal(self, l: Column, r: Column):
        """Elementwise list equality as (equal, known): lengths match and
        every in-range element matches; a null element pair makes the
        answer null (``known`` False) unless another pair differs, as
        the oracle's ``cypher_equals``.  Elements compare within one
        element kind (ints and floats numerically); 'id' lists hold
        entities, which never equal integers in openCypher."""
        if l.kind != "list" or r.kind != "list":
            return self._full(False), self._full(True)
        if l.nested or r.nested or {l.elem_kind, r.elem_kind} & {
                "any", "map", "duration"}:
            return self._list_equal_by_element(l, r)
        ekl, ekr = l.elem_kind, r.elem_kind
        if ekl != ekr and {ekl, ekr} != {"int", "float"}:
            return self._full(False), self._full(True)
        W = max(l.data.shape[1], r.data.shape[1], 1)
        dtype = torch.float64 if "float" in (ekl, ekr) else l.data.dtype

        def pad(d, fill):
            return F.pad(d, (0, W - d.shape[1]), value=fill)

        ld, rd = pad(l.data.to(dtype), 0), pad(r.data.to(dtype), 0)
        both = pad(l.valid_elems(), True) & pad(r.valid_elems(), True)
        pos = torch.arange(W, device=self.device)[None, :]
        within = pos < l.lens[:, None]
        same_len = l.lens == r.lens
        differ = (within & both & (ld != rd)).any(dim=1)
        unknown = (within & ~both).any(dim=1)
        eq = same_len & ~differ & ~unknown
        return eq, ~same_len | differ | ~unknown

    def _elements(self, c: Column):
        """Each list position of a list column as a column of its
        elements (null past a row's length or on a null element)."""
        rows = torch.arange(self.capacity, device=self.device)
        j = torch.arange(c.data.shape[1], device=self.device)
        return [elem_at(c, rows, torch.full_like(rows, i),
                        c.valid & (j[i] < c.lens))
                for i in range(c.data.shape[1])]

    def _list_equal_by_element(self, l: Column, r: Column):
        """``cypher_equals`` of lists of lists, of maps, of durations or
        of mixed values: position by position through
        :meth:`equal_cols` (which recurses into inner lists and maps);
        lengths that differ are unequal, an unknown pair makes the
        answer null unless another pair differs."""
        same_len = l.lens == r.lens
        differ, unknown = self._full(False), self._full(False)
        for i, (a, b) in enumerate(zip(self._elements(l),
                                       self._elements(r))):
            inside = same_len & (i < l.lens)
            eq, known = self.equal_cols(a, b)
            differ = differ | (inside & known & ~eq)
            unknown = unknown | (inside & ~known)
        return same_len & ~differ & ~unknown, ~same_len | differ | ~unknown

    def _ordering(self, e) -> Column:
        l = self.compile(e.lhs)
        r = self.compile(e.rhs)
        valid = l.valid & r.valid
        if _is_null(l) or _is_null(r):
            return self._null()
        if "any" in (l.kind, r.kind) and "list" not in (l.kind, r.kind):
            if {l.kind, r.kind} - set(A.HELD_KINDS + ("any", "id")):
                return self._null()  # a map or duration: incomparable
            lt = isinstance(e, (E.LessThan, E.LessThanOrEqual))
            a, b = (l, r) if lt else (r, l)
            out, known = A.less(a, b, self._rank(),
                                or_equal=isinstance(e, (E.LessThanOrEqual,
                                                        E.GreaterThanOrEqual)))
            return Column("bool", out, valid & known, CTBoolean)
        if l.kind in ("duration", "map") or r.kind in ("duration", "map"):
            return self._null()  # durations and maps do not order
        if l.kind == "str" and r.kind == "str":
            rank = self._lut(self.pool.rank_array())
            ld = _gather(rank, l.data) if rank.shape[0] else l.data
            rd = _gather(rank, r.data) if rank.shape[0] else r.data
        else:
            try:
                l2, r2 = self._promote(l, r)
            except UnsupportedOnDevice:
                # values of incomparable types: the comparison is null
                return self._null()
            if l2.kind == "list":
                raise UnsupportedOnDevice("ordering of lists")
            ld, rd = l2.data, r2.data
            if l2.kind == "bool":
                ld, rd = ld.to(torch.int8), rd.to(torch.int8)
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
        """STARTS WITH / ENDS WITH / CONTAINS / =~: a constant right
        side is a lookup table over the pool; a column right side is
        decided once per held (left, right) pair of codes.  A value that
        is not a string on either side gives null (the oracle's
        ``_strpred``)."""
        l = self._string_operand(self.compile(e.lhs))
        if l is None:
            return self._null()
        if not isinstance(e.rhs, (E.Lit, E.Param)):
            r = self._string_operand(self.compile(e.rhs))
            if r is None:
                return self._null()
            return self._decide_held(
                [l.data, r.data], l.valid & r.valid,
                lambda rows: _decide_pairs(rows, self.pool,
                                           _STRING_PREDICATES[type(e)]))
        rhs = e.rhs.value if isinstance(e.rhs, E.Lit) else self.params[e.rhs.name]
        if not isinstance(rhs, str):
            return self._null()
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

    def _string_operand(self, c: Column):
        """A string predicate's operand as a string column, null where a
        row holds another value; None where no row holds a string."""
        if c.kind == "str":
            return c
        if c.kind == "any":
            from caps_tpu_torch.backends.cuda.column import TAG
            is_str = c.tags == TAG["str"]
            p = A.payload(c)
            return Column("str", torch.where(is_str, p, torch.zeros_like(p)
                                             ).to(torch.int32),
                          c.valid & is_str, CTString)
        return None

    def _in_list(self, e) -> Column:
        l = self.compile(e.lhs)
        if _is_null(l):
            # null IN a list is null, but false for an empty list
            rhs = self.compile(e.rhs)
            if _is_null(rhs):
                return self._null()
            if rhs.kind == "str":
                return self._in_string(l, rhs)
            if rhs.kind != "list":
                raise UnsupportedOnDevice(f"IN over kind {rhs.kind}")
            return Column("bool", self._full(False),
                          rhs.valid & (rhs.lens == 0), CTBoolean)
        if l.kind not in ("str", "int", "id", "float", "bool"):
            # a list, map, temporal or "any" value looked up: element by
            # element (:meth:`_in_list_by_element`)
            rhs = self.compile(e.rhs)
            if rhs.kind != "list":
                raise UnsupportedOnDevice(f"IN over kind {rhs.kind}")
            return self._in_list_column(l, rhs)
        if isinstance(e.rhs, E.ListLit) and all(
                isinstance(i, E.Lit) for i in e.rhs.items):
            values = [i.value for i in e.rhs.items]
        elif isinstance(e.rhs, E.Param):
            values = self.params.get(e.rhs.name)
            if not isinstance(values, (list, tuple)):
                raise UnsupportedOnDevice("IN parameter is not a list")
        else:
            rhs = self.compile(e.rhs)
            if rhs.kind == "str":
                return self._in_string(l, rhs)
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
        relationship id against a var-length path's list): a hit is
        true; a miss is null where the list holds a null element, else
        false; a null ``x`` gives null against a non-empty list and a
        null list gives null."""
        if rhs.nested or rhs.tags is not None or rhs.fields is not None \
                or l.kind in ("list", "map", "any", "duration") \
                or rhs.elem_kind == "duration":
            return self._in_list_by_element(l, rhs)
        ek = rhs.elem_kind
        numeric = ("id", "int", "float")
        kinds = {"str": ("str",), "bool": ("bool",), "date": ("date",),
                 "datetime": ("datetime",)}.get(ek, numeric)
        if l.kind not in kinds:
            return self._in_list_by_element(l, rhs)
        dtype = torch.float64 if "float" in (l.kind, ek) else torch.int64
        width = rhs.data.shape[1]
        in_len = (torch.arange(width, device=self.device)[None, :]
                  < rhs.lens[:, None])
        ev = rhs.valid_elems()
        hit = (rhs.data.to(dtype) == l.data.to(dtype)[:, None]) & in_len & ev
        found = hit.any(dim=1) & l.valid
        has_null = (in_len & ~ev).any(dim=1)
        valid = rhs.valid & ((l.valid & (found | ~has_null))
                             | (rhs.lens == 0))
        return Column("bool", found, valid, CTBoolean)

    def _in_string(self, l: Column, s: Column) -> Column:
        """``x IN s`` for a string ``s``: the oracle iterates its
        characters, so a string is found where it is one of them, any
        other value never; a null ``x`` gives null against a non-empty
        string."""
        lengths = self.pool.lengths_array()
        filled = s.valid if lengths.shape[0] == 0 else \
            s.valid & (_gather(self._lut(lengths), s.data) > 0)
        if _is_null(l):
            return Column("bool", self._full(False), s.valid & ~filled,
                          CTBoolean)
        valid = s.valid & l.valid
        if l.kind != "str":
            return Column("bool", self._full(False), valid, CTBoolean)
        return self._decide_held(
            [l.data, s.data], valid,
            lambda rows: _decide_pairs(rows, self.pool,
                                       lambda a, b: a in list(b)))

    def _in_list_by_element(self, l: Column, rhs: Column) -> Column:
        """:meth:`_in_list_column` position by position through
        :meth:`equal_cols` (the oracle's loop of ``cypher_equals``):
        lists of lists, of maps, of mixed values, and lists or maps
        looked up."""
        found, has_null = self._full(False), self._full(False)
        for i, el in enumerate(self._elements(rhs)):
            inside = i < rhs.lens
            eq, known = self.equal_cols(l, el)
            found = found | (inside & known & eq)
            has_null = has_null | (inside & ~known)
        found = found & l.valid
        valid = rhs.valid & ((l.valid & (found | ~has_null))
                             | (rhs.lens == 0))
        return Column("bool", found, valid, CTBoolean)

    def _arith(self, e) -> Column:
        l = self.compile(e.lhs)
        r = self.compile(e.rhs)
        if _is_null(l) or _is_null(r):
            return self._null()
        if "any" in (l.kind, r.kind) and "list" not in (l.kind, r.kind):
            return self._any_arith(e, l, r)
        temporal = ("date", "datetime", "duration")
        if l.kind in temporal or r.kind in temporal:
            return self._temporal_arith(e, l, r)
        if isinstance(e, E.Add) and "str" in (l.kind, r.kind) \
                and "list" not in (l.kind, r.kind):
            # a string and a value: the value's text (``_to_str``)
            l, r = self._to_string(l), self._to_string(r)
            return self._concat_strings(e, l, r)
        if isinstance(e, E.Add) and l.kind == "list" and r.kind == "list":
            return self._concat_lists(l, r)
        return self._numeric_arith(e, l, r)

    def _numeric_arith(self, e, l: Column, r: Column) -> Column:
        """Arithmetic of two numeric (or boolean) columns."""
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

    def _any_arith(self, e, l: Column, r: Column) -> Column:
        """Arithmetic where a side holds "any" values, row by row by the
        values' kinds (the oracle's ``_arith``): ``+`` with a string on
        either side concatenates the two values' texts; numbers and
        booleans compute as numbers (an integer where both are integers
        or booleans, else a float; ``^`` always a float); temporal
        values follow :meth:`_temporal_arith` (null with a number); a
        string in another operation is an error of its row.  The result
        is an "any" column."""
        from caps_tpu_torch.backends.cuda.column import TAG
        a, b = A.to_any(l), A.to_any(r)
        wide = a.data.dim() > a.tags.dim() or b.data.dim() > b.tags.dim()
        pa, pb = A.payload(a), A.payload(b)
        valid = a.valid & b.valid
        ta, tb = a.tags, b.tags

        def of(t, *kinds):
            out = t == TAG[kinds[0]]
            for k in kinds[1:]:
                out = out | (t == TAG[k])
            return out
        strs = valid & (of(ta, "str") | of(tb, "str"))
        temporal = of(ta, "date", "datetime", "duration") \
            | of(tb, "date", "datetime", "duration")
        ints = valid & of(ta, "int", "bool") & of(tb, "int", "bool")
        if isinstance(e, E.Power):
            ints = self._full(False)
        nums = valid & of(ta, "int", "bool", "float") \
            & of(tb, "int", "bool", "float")
        floats = nums & ~ints
        if not isinstance(e, E.Add):
            self._note_row_error(strs & ~temporal,
                                 f"unsupported operand types for "
                                 f"{type(e).__name__.lower()}: a string")

        def as_int(c, p, ok):
            return Column("int", p, ok, CTInteger)

        def as_float(c, p, ok):
            f = torch.where(c.tags == TAG["float"], A.bits_float(p),
                            p.to(torch.float64))
            return Column("float", f, ok, CTFloat)
        i = self._numeric_arith(e, as_int(a, pa, ints), as_int(b, pb, ints))
        f = self._numeric_arith(e, as_float(a, pa, floats),
                                as_float(b, pb, floats))
        payload = torch.where(ints, i.data.to(torch.int64),
                              A.float_bits(f.data))
        tags = torch.where(ints, TAG["int"], TAG["float"]).to(torch.int8)
        out_ok = (ints & i.valid) | (floats & f.valid)
        if isinstance(e, E.Add):
            keep = strs & ~temporal
            ls = self._to_string(dataclasses.replace(a, valid=keep))
            rs = self._to_string(dataclasses.replace(b, valid=keep))
            cat = self._concat_strings(E.Add(E.Var("_l"), E.Var("_r")),
                                       ls, rs)
            payload = torch.where(keep, cat.data.to(torch.int64), payload)
            tags = torch.where(keep, TAG["str"], tags).to(torch.int8)
            out_ok = out_ok | (keep & cat.valid)
        from caps_tpu_torch.okapi.types import CTAny
        out_ok = out_ok & ~temporal
        if not wide:
            return Column("any", payload, out_ok, CTAny, tags=tags)
        # durations among the values: each pairing of temporal kinds
        # through the temporal arithmetic, into a 3-wide payload
        z = torch.zeros_like(payload)
        payload = torch.stack([payload, z, z], dim=1)
        ctypes = {"date": CTDate, "datetime": CTDateTime,
                  "duration": CTDuration}
        for lk, rk in (("date", "duration"), ("datetime", "duration"),
                       ("duration", "date"), ("duration", "datetime"),
                       ("duration", "duration")):
            hit = valid & (ta == TAG[lk]) & (tb == TAG[rk])
            res = self._temporal_arith(
                e, *(Column(k, c.data if k == "duration" else p, hit,
                            ctypes[k])
                     for k, c, p in ((lk, A.widen(a), pa),
                                     (rk, A.widen(b), pb))))
            if _is_null(res):
                continue
            data = res.data if res.kind == "duration" else torch.stack(
                [res.data, z, z], dim=1)
            payload = torch.where(hit[:, None], data, payload)
            tags = torch.where(hit, TAG[res.kind], tags).to(torch.int8)
            out_ok = out_ok | (hit & res.valid)
        return Column("any", payload, out_ok, CTAny, tags=tags)

    def _temporal_arith(self, e, l: Column, r: Column) -> Column:
        """date/datetime ± duration and duration ± duration (the
        oracle's ``_temporal_arith``); any other pairing is null.  A
        result outside years 1–9999 is an error of its row."""
        valid = l.valid & r.valid
        add = isinstance(e, E.Add)
        if not add and not isinstance(e, E.Subtract):
            return self._null()
        if l.kind == "duration" and r.kind == "duration":
            return Column("duration", l.data + r.data if add
                          else l.data - r.data, valid, l.ctype)
        if add and l.kind == "duration" and r.kind in ("date", "datetime"):
            l, r = r, l
        if l.kind in ("date", "datetime") and r.kind == "duration":
            out, bad = T.plus(l, r.data, 1 if add else -1)
            self._note_row_error(valid & bad, f"{l.kind} out of range")
            return Column(l.kind, out, valid & ~bad, l.ctype)
        return self._null()

    def _case(self, e: E.CaseExpr) -> Column:
        # a condition that is not a boolean is not true (the oracle takes
        # a branch where its condition is True)
        conds = [self.as_bool(self.compile(x)) for x in e.conditions]
        vals = [self.compile(v) for v in e.values]
        default = self.compile(e.default) if e.default is not None else None
        out = default
        if out is None:
            out = null_like(vals[0], self._full(False))
        for c, v in zip(reversed(conds), reversed(vals)):
            v2, o2 = self._unify(v, out)
            out = self._choose(c.valid & c.data, v2, o2)
        return out

    def _unify(self, l: Column, r: Column):
        """Two columns that one expression chooses between (CASE,
        coalesce), brought to one kind: :meth:`_promote`'s numeric and
        null rules, then values of two kinds as "any" values, and lists
        of two element kinds as lists of "any" values.  Maps keep their
        own keys (:meth:`_choose` takes the union)."""
        if _is_null(l) or _is_null(r) or l.kind == "map" == r.kind:
            return self._promote(l, r)
        if l.kind == "list" and r.kind == "list":
            l, r = _nest_like(l, r)
            if l.elem_kind == r.elem_kind or l.fields is not None \
                    or r.fields is not None or l.nested or r.nested:
                return l, r
            if {l.elem_kind, r.elem_kind} <= {"int", "float", "id"}:
                kind = "float" if "float" in (l.elem_kind, r.elem_kind) \
                    else "int"
                return _list_as(l, kind), _list_as(r, kind)
            return A.list_to_any(l), A.list_to_any(r)
        try:
            return self._promote(l, r)
        except UnsupportedOnDevice:
            return A.to_any(l), A.to_any(r)

    def _choose(self, take: torch.Tensor, a: Column, b: Column) -> Column:
        """Per row ``a`` where ``take`` holds, else ``b`` (two columns of
        one kind; of two lists the narrower is padded; of two maps the
        union of their keys, each present where the chosen map has
        it)."""
        if a.kind == "map" or b.kind == "map":
            return self._choose_maps(take, a, b)
        if a.kind == "any" and a.data.dim() != b.data.dim():
            a, b = A.widen(a), A.widen(b)
        if a.kind != "list":
            t = take.view(-1, *([1] * (a.data.dim() - 1)))
            return Column(a.kind, torch.where(t, a.data, b.data),
                          torch.where(take, a.valid, b.valid), a.ctype,
                          tags=(None if a.tags is None
                                else torch.where(take, a.tags, b.tags)))
        if a.fields is not None and b.fields is not None:
            return self._choose_maps(take, a, b)
        if a.tags is not None and b.tags is not None \
                and a.data.dim() != b.data.dim():
            a, b = A.widen(a), A.widen(b)
        a, b = _nest_like(a, b)
        if a.nested != b.nested or a.depth != b.depth \
                or a.data.dtype != b.data.dtype \
                or a.data.dim() != b.data.dim() \
                or (a.tags is None) != (b.tags is None) \
                or (a.fields is None) != (b.fields is None):
            raise UnsupportedOnDevice("choosing between lists of different "
                                      "kinds")
        if a.nested:
            from caps_tpu_torch.backends.cuda.table import share_child
            a, b = share_child(a, b)
        width = max(a.data.shape[1], b.data.shape[1])

        def pick(x, y, fill):
            if x is None and y is None:
                return None
            x, y = (torch.full_like(y if z is None else z, fill)
                    if z is None else z for z in (x, y))
            x, y = pad_width(x, width, fill), pad_width(y, width, fill)
            return torch.where(take.view(-1, *([1] * (x.dim() - 1))), x, y)

        ev = None
        if a.elem_valid is not None or b.elem_valid is not None:
            ev = pick(a.valid_elems(), b.valid_elems(), True)
        return Column("list", pick(a.data, b.data, 0),
                      torch.where(take, a.valid, b.valid), a.ctype,
                      torch.where(take, a.lens, b.lens), elem_valid=ev,
                      tags=None if a.tags is None else pick(a.tags, b.tags, 0),
                      child=a.child)

    def _choose_maps(self, take: torch.Tensor, a: Column,
                     b: Column) -> Column:
        """:meth:`_choose` of two maps (or two lists of maps): each key
        of either, its child chosen and present where the chosen side
        holds it."""
        if a.kind != b.kind or a.fields is None or b.fields is None:
            raise UnsupportedOnDevice("choosing between a map and another "
                                      "value")
        keys = sorted(set(a.fields) | set(b.fields))
        no = torch.zeros(a.data.shape[:-1], dtype=torch.bool,
                         device=self.device)

        def side(m, k):
            if k not in m.fields:
                return None, no
            return m.fields[k], m.data[..., list(m.fields).index(k)]

        fields, present = {}, {}
        for k in keys:
            (ca, pa), (cb, pb) = side(a, k), side(b, k)
            ca = null_like(cb, torch.zeros_like(cb.valid)) if ca is None \
                else ca
            cb = null_like(ca, torch.zeros_like(ca.valid)) if cb is None \
                else cb
            ca, cb = self._unify(ca, cb)
            fields[k] = self._choose(take, ca, cb)
            t = take.view(-1, *([1] * (pa.dim() - 1)))
            present[k] = torch.where(t, pa, pb)
        valid = torch.where(take, a.valid, b.valid)
        if a.kind == "map":
            return M.make(fields, present, valid)
        width = max(a.data.shape[1], b.data.shape[1])
        data = (torch.stack([pad_width(present[k], width, False)
                             for k in keys], dim=2) if keys else
                torch.zeros((self.capacity, width, 0), dtype=torch.bool,
                            device=self.device))
        ev = None
        if a.elem_valid is not None or b.elem_valid is not None:
            ev = torch.where(take[:, None],
                             pad_width(a.valid_elems(), width, True),
                             pad_width(b.valid_elems(), width, True))
        return Column("list", data, valid, a.ctype,
                      torch.where(take, a.lens, b.lens), elem_valid=ev,
                      fields=fields)

    def _function(self, e: E.FunctionExpr,
                  given=None) -> Column:  # noqa: C901
        """A function call; ``given`` maps argument variables to
        columns compiled already."""
        name = e.name
        if name in ("date", "datetime", "localdatetime", "duration"):
            return self._temporal_function(name, e.args)
        if name == "tostring" and e.args \
                and (const := self._fold(e.args[0])) is not None:
            return self._literal(None if const[0] is None
                                 else _text(const[0]))
        args = [given[a.name] if given and isinstance(a, E.Var)
                and a.name in given else self.compile(a) for a in e.args]
        if name == "substring" and len(args) == 3 and _is_null(args[2]):
            # a null length is no length (the oracle's ``s[start:]``)
            e = E.FunctionExpr(e.name, tuple(e.args[:2]))
            args = args[:2]
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
            if c.kind == "any":
                return self._convert_any(c, "tointeger")
            return self._null()  # the oracle's _to_int of other values
        if name == "tofloat":
            c = args[0]
            if c.kind in ("int", "id", "float"):
                return c.astype_kind("float")
            if c.kind == "str":
                return self._parse_strings(c, "tofloat", _to_float,
                                           "float", CTFloat)
            if c.kind == "any":
                return self._convert_any(c, "tofloat")
            return self._null()  # the oracle's _to_float of other values
        if name == "toboolean":
            c = args[0]
            if c.kind == "bool":
                return c
            if c.kind == "str":
                return self._parse_strings(c, "toboolean", _to_bool,
                                           "bool", CTBoolean)
            if c.kind == "any":
                return self._convert_any(c, "toboolean")
            return self._null()  # the oracle's _to_bool of other values
        if name == "tostring":
            return self._to_string(args[0])
        if name in _STRING_FUNCTIONS:
            return self._string_function(name, e, args)
        if name in ("head", "last", "tail") or (
                name == "reverse" and args[0].kind == "list"):
            return self._list_function(name, args[0])
        if name == "range":
            folded = [self._fold(a) for a in e.args]
            if any(f is None for f in folded):
                return self._range_of_columns(args)
            bounds = [f[0] for f in folded]
            if not all(isinstance(b, int) and not isinstance(b, bool)
                       for b in bounds) or len(bounds) not in (2, 3):
                raise UnsupportedOnDevice("range() of bounds that are not "
                                          "integers")
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
            if c.kind == "map":
                return Column("int", (c.data & c.valid[:, None]).sum(
                    dim=1).to(torch.int64), c.valid, CTInteger)
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


    def _range_of_columns(self, args) -> Column:
        """``range(lo, hi[, step])`` with column bounds: each row's
        length ``max(0, (hi - lo) // step + 1)`` computed on the card,
        the list matrix as wide as the longest list (one size through
        the size stream, rounded up to a power of two so a replay whose
        lists grow a little still fits), element ``j`` at ``lo + j *
        step``.  A null bound or a step of 0 is an error of its row, as
        the oracle's Python ``range`` raises there."""
        from caps_tpu_torch.okapi.types import CTList
        for a in args:
            if a.kind not in ("int", "id"):
                raise UnsupportedOnDevice(f"range() of a bound of kind "
                                          f"{a.kind}")
        lo, hi = (a.data.to(torch.int64) for a in args[:2])
        step = args[2].data.to(torch.int64) if len(args) == 3 \
            else torch.ones_like(lo)
        valid = self._full(True)
        for a in args:
            valid = valid & a.valid
        self._note_row_error(~valid, "range() of a null bound")
        self._note_row_error(valid & (step == 0), "range() step of 0")
        ok = valid & (step != 0) & self.row_ok
        safe = torch.where(step == 0, torch.ones_like(step), step)
        n = torch.where(ok, ((hi - lo).div(safe, rounding_mode="floor")
                             + 1).clamp(min=0), torch.zeros_like(lo))
        width = 1
        if self.backend is not None:
            longest = n.max().clamp(min=1) if n.numel() else \
                torch.ones((), dtype=torch.int64, device=self.device)
            width = self.backend.consume_count(torch.exp2(torch.ceil(
                torch.log2(longest.to(torch.float64)))).to(torch.int64),
                relation="cap")
        else:
            width = max(1, int(n.max()) if n.numel() else 1)
        j = torch.arange(width, device=self.device, dtype=torch.int64)
        data = lo[:, None] + j[None, :] * step[:, None]
        data = torch.where(j[None, :] < n[:, None], data,
                           torch.zeros_like(data))
        return Column("list", data, valid, CTList(CTInteger),
                      n.to(torch.int32))


def _decide_pairs(rows: np.ndarray, pool, test) -> list:
    """``test`` of each held (left, right) pair of string codes."""
    return [test(a, b) for a, b in zip(pool.decode_many(rows[:, 0]),
                                       pool.decode_many(rows[:, 1]))]


# The string predicates of two strings (the oracle's ``_strpred``).
_STRING_PREDICATES: Dict[type, Callable[[str, str], bool]] = {
    E.StartsWith: lambda a, b: a.startswith(b),
    E.EndsWith: lambda a, b: a.endswith(b),
    E.Contains: lambda a, b: b in a,
    E.RegexMatch: lambda a, b: re.fullmatch(b, a) is not None,
}


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


def _beyond_int64(v) -> bool:
    return v is not None and not -2 ** 63 <= v < 2 ** 63


def _within_int64(fn):
    """``fn`` with results beyond int64 as null."""
    return lambda s: None if _beyond_int64(v := fn(s)) else v


def _to_float(s: str):
    try:
        return float(s)
    except ValueError:
        return None


def _to_bool(s: str):
    return {"true": True, "false": False}.get(s.lower())


def _text(v) -> str:
    """toString of a non-null host value (the oracle's ``_to_str``)."""
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    return v.iso() if hasattr(v, "iso") else str(v)


def _list_as(c: Column, kind: str) -> Column:
    """A list column's elements converted to a numeric kind."""
    from caps_tpu_torch.backends.cuda.column import list_dtype
    return dataclasses.replace(c, data=c.data.to(list_dtype(kind)),
                               host=None)


def _nest_like(l: Column, r: Column):
    """Two list columns of which one is a list of lists and the other a
    list of no element type (only empty lists and null elements, as
    ``[]``): the latter as a list of lists over the former's inner
    lists, its elements null."""
    from caps_tpu_torch.okapi.types import CTVoid
    for a, b in ((l, r), (r, l)):
        m = b.ctype.material
        if a.nested and not b.nested and isinstance(m, _CTList) and (
                m.inner is None or m.inner.material in (CTVoid,
                                                        CTNull.material)):
            shape = b.data.shape[:2]
            b = dataclasses.replace(
                b, data=torch.zeros(shape, dtype=torch.int64,
                                    device=b.data.device),
                elem_valid=torch.zeros(shape, dtype=torch.bool,
                                       device=b.data.device),
                tags=None, fields=None, child=a.child, host=None)
            return (a, b) if a is l else (b, a)
    return l, r


def _is_null(c: Column) -> bool:
    """True for the all-null column of :meth:`DeviceExprCompiler._null`."""
    return c.ctype == CTNull


def _gather(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``table[codes]`` with codes clamped into range (padding rows carry
    code 0 and are masked by validity)."""
    return table[codes.clamp(0, table.shape[0] - 1).to(torch.int64)]


from caps_tpu_torch.backends.cuda import anyvalue as A  # noqa: E402
from caps_tpu_torch.backends.cuda import lists as L  # noqa: E402
from caps_tpu_torch.backends.cuda import maps as M  # noqa: E402
from caps_tpu_torch.backends.cuda import temporal as T  # noqa: E402
