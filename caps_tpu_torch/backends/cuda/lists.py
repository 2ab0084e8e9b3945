"""List expressions on the device: comprehensions, quantifiers, reduce,
list literals of columns, entity access on lambda variables, labels /
keys, nodes of a path and Disjoint.

The JAX package answers these on its host backend; here they run as
tensor operations over the padded list matrix (``column.py``: data
``(capacity, W)``, ``lens``, ``elem_valid``), with the oracle's
semantics (``backends/local/expr.py``).

One design serves the three lambdas.  A list is flattened into
``capacity * W`` element rows; the lambda variable is bound to a column
over those rows (valid where the element is non-null and inside its
row's length), every outer column the body reads is gathered by
``row = arange(capacity * W) // W`` on first read, and the body compiles
with a child :class:`DeviceExprCompiler` over the flattened rows.  A
comprehension left-packs the kept elements by a running count along the
row, a quantifier counts true and null verdicts per row, and a reduce
runs ``W`` steps over the original rows.  Every shape is known on the
host (``W`` is the list's width), so none of this reads the device.

A lambda variable that ranges over entities reads properties, labels,
types and endpoints through :class:`EntityIndex`: the graph's entity
scan on the card, its ids sorted once, looked up by binary search.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from caps_tpu_torch.backends.cuda import anyvalue as A
from caps_tpu_torch.backends.cuda import maps as M
from caps_tpu_torch.backends.cuda.column import Column, elem_at, list_dtype
from caps_tpu_torch.backends.cuda.expr import (
    DeviceExprCompiler, UnsupportedOnDevice, _is_null, _nest_like,
)
from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.okapi.types import (
    CTBoolean, CTList, CTNode, CTNull, CTString, _CTList, _CTNode,
    _CTRelationship, join_all,
)
from caps_tpu_torch.relational.header import RecordHeader


class Bound(NamedTuple):
    """A lambda variable's column over a compiler's rows.  ``kind`` is
    'node' or 'rel' where its values are entity ids (the oracle's static
    ``_elem_kind``), and ``mask`` marks the rows that hold one where that
    varies by list position (a literal ``[n, 5]``); None = every row.
    Where a list holds nodes and relationships (``[n, r]``), ``kind``
    maps each of the two to the mask of the rows that hold one."""
    col: Column
    kind: Optional[object] = None
    mask: Optional[torch.Tensor] = None


def mentions(e: E.Expr, bound: Mapping[str, Bound]) -> bool:
    """True if ``e`` reads a lambda variable: the header must not answer
    it, since the variable shadows a column of the same name."""
    return e.exists(lambda n: isinstance(n, E.Var) and n.name in bound)


class _Gathered(Mapping):
    """The outer columns over a lambda's element rows, each gathered on
    its first read (a body reads few of a table's columns)."""

    def __init__(self, columns: Mapping[str, Column], row: torch.Tensor):
        self._columns = columns
        self._row = row
        self._memo: Dict[str, Column] = {}

    def __getitem__(self, name: str) -> Column:
        if name not in self._memo:
            self._memo[name] = self._columns[name].take(self._row)
        return self._memo[name]

    def __iter__(self):
        return iter(self._columns)

    def __len__(self) -> int:
        return len(self._columns)


# -- static entity kinds (the oracle's _elem_kind / _single_kind) ----------

def _kind_of_type(t) -> Optional[str]:
    m = t.material
    if isinstance(m, _CTNode):
        return "node"
    if isinstance(m, _CTRelationship):
        return "rel"
    return None


def _single_kind(header: RecordHeader, item: E.Expr) -> Optional[str]:
    if isinstance(item, E.PathNode):
        return "node"
    if isinstance(item, E.PathSeg):
        return None if item.is_varlen else "rel"
    if isinstance(item, (E.StartNode, E.EndNode)):
        return "node"
    if header.has(item):
        return _kind_of_type(header.type_of(item))
    return None


def elem_kinds(header: RecordHeader, le: E.Expr):
    """'node' | 'rel' | None for a list expression's elements, or a list
    of them by position (a list literal: mixed items must not make
    plain integers entity ids)."""
    if isinstance(le, E.ListLit):
        kinds = [_single_kind(header, i) for i in le.items]
        return kinds[0] if len(set(kinds)) == 1 else kinds
    if isinstance(le, E.Add):
        lk, rk = elem_kinds(header, le.lhs), elem_kinds(header, le.rhs)
        if isinstance(lk, list) and isinstance(rk, list):
            return lk + rk
        return lk if lk == rk else None
    if isinstance(le, E.PathNodes):
        return "node"
    if isinstance(le, E.PathSeg) and le.is_varlen:
        return "rel"
    if isinstance(le, E.Slice):
        k = elem_kinds(header, le.expr)
        return k if not isinstance(k, list) else None
    if isinstance(le, E.FunctionExpr) and le.name == "tail" and le.args:
        k = elem_kinds(header, le.args[0])
        return k if not isinstance(k, list) else None
    if isinstance(le, E.Collect):
        return _single_kind(header, le.expr) or elem_kinds(header, le.expr)
    if header.has(le):
        t = header.type_of(le).material
        if isinstance(t, _CTList):
            return _kind_of_type(t.inner)
    return None


def _position_kind(kinds, width: int, device
                   ) -> Tuple[Optional[str], Optional[torch.Tensor]]:
    """(entity kind, bool mask over the ``width`` list positions) of
    static kinds; the mask is None where every position is of that
    kind."""
    if not isinstance(kinds, list):
        return kinds, None
    ents = sorted({k for k in kinds if k is not None})
    if not ents:
        return None, None

    def positions(kind):
        at = [k == kind for k in kinds[:width]]
        return torch.tensor(at + [False] * (width - len(at)),
                            dtype=torch.bool, device=device)
    if len(ents) > 1:
        # nodes and relationships: each kind's positions
        return {k: positions(k) for k in ents}, None
    return ents[0], positions(ents[0])


# -- the entity index ----------------------------------------------------

_IX = "__ix"
_TOP = torch.iinfo(torch.int64).max


class EntityIndex:
    """The graph's nodes (or relationships) on the card: the scan of
    every entity (``graph.scan_node`` / ``scan_rel``, so a versioned
    snapshot's index holds its writes), its ids sorted once, and each
    sorted id's scan row.  An id is looked up by binary search; a
    missing one is not ``found``.  Built outside the fused executor's
    size stream: it is built once per graph, and a replay that finds it
    built must consume the same sizes as the run that built it."""

    def __init__(self, backend, graph, kind: str):
        if graph is None:
            raise UnsupportedOnDevice("entity access in a list expression "
                                      "without a graph")
        mode, backend.count_mode = backend.count_mode, None
        try:
            header, table = (graph.scan_node(_IX) if kind == "node"
                             else graph.scan_rel(_IX))
        finally:
            backend.count_mode = mode
        from caps_tpu_torch.backends.cuda.sharded import whole
        from caps_tpu_torch.backends.cuda.table import _on_device
        # a probe of the whole scan: a row-resident one gathers first,
        # onto the compiling shard's device
        table = _on_device(whole(table), backend)
        self.kind = kind
        self.header = header
        self.columns = table._cols
        ids = self.columns[header.column(E.Var(_IX))]
        keys = torch.where(ids.valid & table.row_ok, ids.data.long(),
                           torch.full((), _TOP, dtype=torch.int64,
                                      device=ids.data.device))
        self.keys, self.perm = torch.sort(keys)

    def lookup(self, ids: torch.Tensor, ok: torch.Tensor):
        """(scan row, found) of each id (``ok`` False: not found)."""
        q = ids.long().contiguous()
        pos = torch.searchsorted(self.keys, q).clamp_(
            max=self.keys.shape[0] - 1)
        return self.perm[pos], (self.keys[pos] == q) & ok

    def field(self, e: E.Expr, row: torch.Tensor,
              found: torch.Tensor) -> Optional[Column]:
        """``e`` (an expression of the scan variable) at the rows, null
        where not found; None where the scan has no such column."""
        if not self.header.has(e):
            return None
        c = self.columns[self.header.column(e)].take(row)
        c.valid = c.valid & found
        return c

    def named(self, cls) -> List[Tuple[str, E.Expr]]:
        """(name, expression) of the scan's label or property columns,
        sorted by name (the oracle's order)."""
        out = []
        for he in self.header.exprs:
            if cls is E.HasLabel and isinstance(he, E.HasLabel):
                out.append((he.label, he))
            elif cls is E.Property and isinstance(he, E.Property):
                out.append((he.key, he))
        return sorted(out, key=lambda p: p[0])


def entity_index(comp: DeviceExprCompiler, kind: str) -> EntityIndex:
    ctx = comp.entity_ctx
    if ctx is None or comp.backend is None:
        raise UnsupportedOnDevice("entity access in a list expression "
                                  "without a graph")
    backend = comp.backend
    return ctx.index(("cuda", kind, str(backend.device)),
                     lambda g: EntityIndex(backend, g, kind))


def _lookup(comp: DeviceExprCompiler, b: Bound, idx: EntityIndex):
    """(scan row, found) of a bound variable's ids, looked up once per
    compiler."""
    key = (id(b.col.data), idx.kind)
    hit = comp.lookups.get(key)
    if hit is None or hit[0] is not b.col.data:
        ok = b.col.valid if b.mask is None else b.col.valid & b.mask
        hit = (b.col.data,) + idx.lookup(b.col.data, ok)
        comp.lookups[key] = hit
    return hit[1], hit[2]


# -- entity access on a lambda variable ------------------------------------

def bound_access(comp: DeviceExprCompiler, e: E.Expr) -> Optional[Column]:
    """A lambda variable, or a property, label, type or endpoint of one
    (the oracle's ``_BoundEvaluator``); None for anything else."""
    if isinstance(e, E.Var):
        b = comp.bound.get(e.name)
        return None if b is None else b.col
    if isinstance(e, (E.Property, E.Keys, E.Properties)):
        tgt = e.entity
    elif isinstance(e, (E.Labels, E.HasLabel)):
        tgt = e.node
    elif isinstance(e, (E.Type, E.HasType, E.StartNode, E.EndNode)):
        tgt = e.rel
    else:
        return None
    if not (isinstance(tgt, E.Var) and tgt.name in comp.bound):
        return None
    b = comp.bound[tgt.name]
    if isinstance(b.kind, dict):
        # nodes and relationships by position: each kind's access where
        # it holds, through a compiler with the variable bound to it
        out = comp._null()
        for kind, held in b.kind.items():
            m = held if b.mask is None else held & b.mask
            sub = comp.child(comp.columns, comp.capacity, comp.row_ok,
                             {**comp.bound, tgt.name: Bound(b.col, kind, m)})
            part = bound_access(sub, e)
            part = dataclasses.replace(part, valid=part.valid & m)
            part, out = comp._unify(part, out)
            out = comp._choose(m, part, out)
        return out
    if b.kind is None:
        # a value that names no entity (the oracle's ``_entity_field``):
        # a map's entries, keys and itself, a temporal value's
        # components; null for the rest
        col = b.col
        if col.kind == "map":
            if isinstance(e, E.Property):
                return M.field(comp, col, e.key)
            if isinstance(e, E.Keys):
                return M.keys(comp, col)
            if isinstance(e, E.Properties):
                return col
        elif isinstance(e, E.Property) and col.kind in (
                "date", "datetime", "duration", "any"):
            return comp._property(e)
        return comp._null()
    idx = entity_index(comp, b.kind)
    row, found = _lookup(comp, b, idx)
    present = b.col.valid if b.mask is None else b.col.valid & b.mask
    v = E.Var(_IX)
    if isinstance(e, (E.Property, E.Type, E.StartNode, E.EndNode)):
        if isinstance(e, E.Property):
            field = E.Property(v, e.key)
        elif isinstance(e, E.Type):
            field = E.Type(v) if b.kind == "rel" else None
        else:
            field = type(e)(v) if b.kind == "rel" else None
        out = None if field is None else idx.field(field, row, found)
        return comp._null() if out is None else out
    if isinstance(e, E.Properties):
        names, cols = [], []
        for name, he in idx.named(E.Property):
            names.append(name)
            cols.append(idx.field(he, row, found))
        return M.of_properties(names, cols, present)
    if isinstance(e, (E.HasLabel, E.HasType)):
        if isinstance(e, E.HasLabel):
            f = (idx.field(E.HasLabel(v, e.label), row, found)
                 if b.kind == "node" else None)
            hit = f is not None and (f.data & f.valid)
        else:
            f = idx.field(E.Type(v), row, found) if b.kind == "rel" else None
            hit = f is not None and (
                (f.data == comp.pool.encode(e.rel_type)) & f.valid)
        data = hit if torch.is_tensor(hit) else comp._full(False)
        return Column("bool", data, present, CTBoolean)
    # labels / keys: the entity's names, sorted; empty for an id that
    # names no entity of the kind
    cls = E.HasLabel if isinstance(e, E.Labels) else E.Property
    if isinstance(e, E.Labels) and b.kind != "node":
        return comp._null()
    names, keeps = [], []
    for name, he in idx.named(cls):
        f = idx.field(he, row, found)
        names.append(name)
        keeps.append(f.data & f.valid if cls is E.HasLabel else f.valid)
    return _names_list(comp, names, keeps, present)


def _names_list(comp: DeviceExprCompiler, names: List[str],
                keeps: List[torch.Tensor], valid: torch.Tensor,
                order: Optional[torch.Tensor] = None) -> Column:
    """Per row, the names whose ``keep`` holds, in order (each row's
    own where ``order`` gives each name's place in it), as a string
    list (labels(), keys())."""
    if not names:
        return Column("list", torch.zeros((comp.capacity, 1),
                                          dtype=torch.int32,
                                          device=comp.device),
                      valid, CTList(CTString),
                      torch.zeros(comp.capacity, dtype=torch.int32,
                                  device=comp.device))
    codes = torch.tensor([comp.pool.encode(n) for n in names],
                         dtype=torch.int32, device=comp.device)
    codes = codes[None, :].expand(comp.capacity, len(names))
    keep = torch.stack(keeps, dim=1)
    if order is not None:
        at = torch.argsort(order.to(torch.int64), dim=1, stable=True)
        codes, keep = torch.gather(codes, 1, at), torch.gather(keep, 1, at)
    data, _ev, lens = left_pack(codes, keep)
    return Column("list", data, valid, CTList(CTString), lens)


def labels_or_keys(comp: DeviceExprCompiler, e: E.Expr) -> Column:
    """labels(n) / keys(n) of a header variable: its label columns that
    hold (or property columns that are set), sorted, as a string list;
    null for a null entity."""
    ent = e.node if isinstance(e, E.Labels) else e.entity
    if not isinstance(ent, E.Var):
        from caps_tpu_torch.relational.table import ExprEvalError
        raise ExprEvalError(f"{type(e).__name__.lower()}() on {ent!r}")
    ids = comp.compile(ent)
    names, keeps = [], []
    items = []
    for he in comp.header.exprs:
        if isinstance(e, E.Labels) and isinstance(he, E.HasLabel) \
                and he.node == ent:
            items.append((he.label, he))
        elif isinstance(e, E.Keys) and isinstance(he, E.Property) \
                and he.entity == ent:
            items.append((he.key, he))
    for name, he in sorted(items, key=lambda p: p[0]):
        c = comp.compile(he)
        names.append(name)
        keeps.append(c.data & c.valid if isinstance(e, E.Labels)
                     else c.valid)
    return _names_list(comp, names, keeps, ids.valid)


# -- packing -------------------------------------------------------------

def left_pack(values: torch.Tensor, keep: torch.Tensor,
              elem_valid: Optional[torch.Tensor] = None):
    """Each row's kept entries moved to its left, in order: (data,
    elem_valid or None, lens).  A running count along the row places
    them; the rest go to a spare last column that is cut off.  An entry
    may be a row of its own (``values`` of three dimensions: inner
    lists)."""
    rows, width = keep.shape
    # the running count along each short row, scanned over the row axis
    # of the transpose: a scan along the innermost axis of a tall narrow
    # matrix is slow on the card
    count = torch.cumsum(keep.t().to(torch.int32), dim=0,
                         dtype=torch.int32).t()
    dest = torch.where(keep, (count - 1).long(),
                       torch.full((), width, dtype=torch.int64,
                                  device=keep.device))
    data = torch.zeros((rows, width + 1) + values.shape[2:],
                       dtype=values.dtype, device=values.device)
    at = dest.view(rows, width, *([1] * (values.dim() - 2))).expand(
        values.shape)
    data = data.scatter_(1, at, values)[:, :width]
    ev = None
    if elem_valid is not None:
        ev = torch.ones((rows, width + 1), dtype=torch.bool,
                        device=values.device)
        ev = ev.scatter_(1, dest, elem_valid)[:, :width]
    lens = count[:, -1] if width else torch.zeros(rows, dtype=torch.int32,
                                                  device=keep.device)
    return data, ev, lens.to(torch.int32)


# -- list literals ---------------------------------------------------------

def list_literal(comp: DeviceExprCompiler, e: E.ListLit) -> Column:
    """A list literal of columns (:func:`stack_items`)."""
    return stack_items(comp, [comp.compile(i) for i in e.items])


def stack_items(comp: DeviceExprCompiler, cols: List[Column]) -> Column:
    """Columns as the elements of one list per row: stacked into
    ``(capacity, k)``, a null item a null element; entities become their
    ids.  Ids mixed with ints give an int list (the oracle's values are
    ints too); values of several kinds give a list of "any" values
    (lists and maps among them held by row, ``anyvalue.py``); maps a
    list of maps, lists a list of lists."""
    values = [c for c in cols if not _is_null(c)]
    if values and all(c.kind == "list" for c in values):
        return _nested_literal(comp, cols)
    if values and all(c.kind == "map" for c in values):
        return M.stack(comp, cols)
    kinds = {c.kind for c in values}
    inner = join_all(c.ctype for c in cols)
    lens = torch.full((comp.capacity,), len(cols), dtype=torch.int32,
                      device=comp.device)
    ev = torch.stack([c.valid for c in cols], dim=1)
    if kinds == {"duration"}:
        data = torch.stack([torch.zeros((comp.capacity, 3), dtype=torch.int64,
                                        device=comp.device) if _is_null(c)
                            else c.data for c in cols], dim=1)
        return Column("list", data, comp._full(True), CTList(inner), lens,
                      elem_valid=ev)
    if not kinds:
        ek = "int"
    elif kinds <= {"id", "int"}:
        ek = "id" if kinds == {"id"} else "int"
    elif len(kinds) == 1 and "any" not in kinds:
        ek = next(iter(kinds))
    else:
        out = A.stack([c if not _is_null(c) else comp._literal(0)
                       for c in cols])
        return dataclasses.replace(out, valid=comp._full(True),
                                   ctype=CTList(inner), lens=lens,
                                   elem_valid=ev)
    dtype = list_dtype(ek)
    data = torch.stack([c.data.to(dtype) if not _is_null(c) else
                        torch.zeros(comp.capacity, dtype=dtype,
                                    device=comp.device) for c in cols], dim=1)
    return Column("list", data, comp._full(True), CTList(inner), lens,
                  elem_valid=ev)


def _nested_literal(comp: DeviceExprCompiler, cols: List[Column]) -> Column:
    """A list literal of lists: the items' rows, one item after another,
    become the inner lists (a child of ``k * capacity`` rows, the items
    brought to one kind: lists of other depths or kinds as lists of
    "any" values); element ``i`` of row ``r`` is inner list ``i *
    capacity + r``, a null item a null element."""
    from caps_tpu_torch.backends.cuda.column import null_like
    from caps_tpu_torch.backends.cuda.table import (
        _concat_columns, _union_pair,
    )
    deep = max((c for c in cols if not _is_null(c)), key=lambda c: c.depth)
    # (an item of no element type, ``[]``, is a list of lists too)
    cols = [c if _is_null(c) else _nest_like(deep, c)[1] for c in cols]
    lists = [c for c in cols if not _is_null(c)]
    proto = lists[0]
    for c in lists[1:]:
        proto, _ = _union_pair(proto, c, "list item")
    items = []
    for c in cols:
        c = null_like(proto, comp._full(False)) if _is_null(c) else c
        items.append(_union_pair(proto, c, "list item")[1])
    cap = comp.capacity
    child, n = items[0], cap
    for c in items[1:]:
        child = _concat_columns(child, n, c, cap, n + cap,
                                child.ctype.join(c.ctype))
        n += cap
    rows = torch.arange(cap, device=comp.device)
    data = torch.stack([rows + i * cap for i in range(len(cols))], dim=1)
    lens = torch.full((cap,), len(cols), dtype=torch.int32,
                      device=comp.device)
    return Column("list", data, comp._full(True),
                  CTList(join_all(c.ctype for c in cols)), lens,
                  elem_valid=torch.stack([c.valid for c in cols], dim=1),
                  child=child)


# -- lambdas ---------------------------------------------------------------

def _list_operand(comp: DeviceExprCompiler, le: E.Expr, what: str
                  ) -> Optional[Column]:
    """The list a lambda ranges over; None for a null literal."""
    lst = comp.compile(le)
    if _is_null(lst):
        return None
    if lst.kind != "list":
        raise UnsupportedOnDevice(f"{what} over kind {lst.kind}")
    return lst


def _inner_type(lst: Column):
    m = lst.ctype.material
    return m.inner if isinstance(m, _CTList) else CTNull


class _Flat(NamedTuple):
    child: DeviceExprCompiler   # over the element rows
    ok: torch.Tensor            # (cap * W,) the elements that exist
    var: Column                 # the lambda variable
    width: int


def _flatten(comp: DeviceExprCompiler, var: str, le: E.Expr,
             lst: Column) -> _Flat:
    """A child compiler over ``lst``'s element rows with ``var`` bound
    to the elements (and the enclosing lambdas' variables gathered)."""
    cap, W = lst.data.shape[:2]
    n = cap * W
    dev = comp.device
    flat = torch.arange(n, device=dev)
    row, j = flat // W, flat % W
    ok = ((j < lst.lens[row]) & lst.valid[row] & comp.row_ok[row])
    elem = elem_at(lst, row, j, ok)
    kind, pos = _position_kind(elem_kinds(comp.header, le), W, dev)
    if pos is not None:
        pos = pos[j]
    if isinstance(kind, dict):
        kind = {k: m[j] for k, m in kind.items()}
    bound = {k: Bound(b.col.take(row),
                      {kk: m[row] for kk, m in b.kind.items()}
                      if isinstance(b.kind, dict) else b.kind,
                      None if b.mask is None else b.mask[row])
             for k, b in comp.bound.items()}
    bound[var] = Bound(elem, kind, pos)
    child = comp.child(_Gathered(comp.columns, row), n, ok, bound)
    return _Flat(child, ok, elem, W)


def _adopt_errors(comp: DeviceExprCompiler, child: DeviceExprCompiler,
                  width: int) -> None:
    """A child's row errors, folded onto the rows its elements came from:
    the table still reads one mask."""
    if child.error_mask is None:
        return
    rows = child.error_mask
    if width != 1:
        rows = rows.reshape(comp.capacity, width).any(dim=1)
    comp._note_row_error(rows, child.error_what)


def _verdicts(comp: DeviceExprCompiler, flat: _Flat, predicate: E.Expr,
              other_is_null: bool):
    """The predicate's verdict per element row.  A value that is not a
    boolean is a false verdict to a comprehension (it keeps an element
    where its predicate is True) and a null one to a quantifier (the
    oracle's ``_quantify`` counts it with the nulls)."""
    p = flat.child.compile(predicate)
    if other_is_null and p.kind == "any":
        from caps_tpu_torch.backends.cuda.column import TAG
        p = Column("bool", p.data != 0, p.valid & (p.tags == TAG["bool"]),
                   CTBoolean)
    elif other_is_null and p.kind != "bool" and not _is_null(p):
        p = Column("bool", torch.zeros_like(flat.ok),
                   torch.zeros_like(flat.ok), CTBoolean)
    else:
        p = flat.child.as_bool(p)
    _adopt_errors(comp, flat.child, flat.width)
    return p


def comprehension(comp: DeviceExprCompiler,
                  e: E.ListComprehension) -> Column:
    """``[x IN list WHERE p | f]``: the elements whose predicate is
    true, projected, left-packed; the width stays ``W``; a null list
    gives null."""
    lst = _list_operand(comp, e.list_expr, "comprehension")
    if lst is None:
        return comp._null()
    flat = _flatten(comp, e.var, e.list_expr, lst)
    keep = flat.ok
    if e.predicate is not None:
        p = _verdicts(comp, flat, e.predicate, other_is_null=False)
        keep = keep & p.valid & p.data
    if e.projection is not None:
        proj = flat.child.child(flat.child.columns, flat.child.capacity,
                                keep, flat.child.bound)
        v = proj.compile(e.projection)
        _adopt_errors(comp, proj, flat.width)
    else:
        v = flat.var
    cap, W = comp.capacity, flat.width
    ctype = CTList(v.ctype if e.projection is not None else _inner_type(lst))
    out = pack_elements(v, keep.reshape(cap, W), cap, W, ctype)
    out.valid = lst.valid
    if e.projection is None and lst.elem_valid is None:
        out.elem_valid = None
    return out


def pack_elements(v: Column, keep: torch.Tensor, cap: int, W: int,
                  ctype) -> Column:
    """A column over ``cap * W`` element rows packed into one list per
    row: the kept elements of each row, left-aligned (lists of lists,
    of "any" values and of maps too)."""
    valid = v.valid.reshape(cap, W)
    if v.kind == "list":
        # a list of lists, at any depth: the element rows become the
        # inner lists, and each kept element holds its row
        at = torch.arange(cap * W, device=v.data.device).reshape(cap, W)
        data, ev, lens = left_pack(at, keep, valid)
        return Column("list", data, comp_true(lens), ctype, lens,
                      elem_valid=ev, child=v)
    if v.kind == "map":
        data, ev, lens = left_pack(v.data.reshape(cap, W, -1), keep, valid)
        fields = {}
        for k, c in v.fields.items():
            fields[k] = pack_elements(c, keep, cap, W, CTList(c.ctype))
        order = None if v.order is None else \
            left_pack(v.order.reshape(cap, W, -1), keep)[0]
        return Column("list", data, comp_true(lens), ctype, lens,
                      elem_valid=ev, fields=fields, order=order)
    data, ev, lens = left_pack(v.data.reshape(cap, W, *v.data.shape[1:]),
                               keep, valid)
    tags = None
    if v.tags is not None:
        tags, _, _ = left_pack(v.tags.reshape(cap, W), keep)
    return Column("list", data, comp_true(lens), ctype, lens, elem_valid=ev,
                  tags=tags, child=v.child, maps=v.maps)


def comp_true(like: torch.Tensor) -> torch.Tensor:
    return torch.ones(like.shape, dtype=torch.bool, device=like.device)


def quantify(comp: DeviceExprCompiler,
             e: E.QuantifiedPredicate) -> Column:
    """all / any / none / single with the oracle's three-valued table
    (``_quantify``), from each row's counts of true, false and null
    verdicts; a null list gives null."""
    lst = _list_operand(comp, e.list_expr, "quantifier")
    if lst is None:
        return comp._null()
    flat = _flatten(comp, e.var, e.list_expr, lst)
    p = _verdicts(comp, flat, e.predicate, other_is_null=True)
    cap, W = comp.capacity, flat.width

    def count(m):
        return (m & flat.ok).reshape(cap, W).sum(dim=1)

    n_true = count(p.valid & p.data)
    n_false = count(p.valid & ~p.data)
    n_null = count(~p.valid)
    if e.kind == "any":
        data, known = n_true > 0, (n_true > 0) | (n_null == 0)
    elif e.kind == "all":
        data, known = n_false == 0, (n_false > 0) | (n_null == 0)
        data = data & (n_null == 0)
    elif e.kind == "none":
        data, known = n_true == 0, (n_true > 0) | (n_null == 0)
        data = data & (n_null == 0)
    else:  # single
        data = (n_true == 1) & (n_null == 0)
        known = (n_true > 1) | (n_null == 0)
    return Column("bool", data, lst.valid & known, CTBoolean)


def reduce(comp: DeviceExprCompiler, e: E.Reduce) -> Column:
    """``reduce(acc = init, x IN list | body)``: ``W`` steps over the
    rows; step ``j`` binds ``acc`` to the running column and ``x`` to
    element ``j`` and updates the rows whose list is that long.  The
    accumulator keeps the kind of the init (or of the first step, for a
    null init); a body that changes it makes it "any" values (lists and
    maps held by row)."""
    lst = _list_operand(comp, e.list_expr, "reduce")
    acc = comp.compile(e.init)
    if lst is None:
        return comp._null()
    cap, W = lst.data.shape[:2]
    live = lst.valid & comp.row_ok
    rows = torch.arange(cap, device=comp.device)
    kinds = elem_kinds(comp.header, e.list_expr)
    for j in range(W):
        step = live & (lst.lens > j)
        kind = kinds[j] if isinstance(kinds, list) and j < len(kinds) \
            else (None if isinstance(kinds, list) else kinds)
        bound = dict(comp.bound)
        bound[e.acc] = Bound(acc)
        elem = elem_at(lst, rows, torch.full_like(rows, j), step)
        bound[e.var] = Bound(elem, kind)
        child = comp.child(comp.columns, cap, step, bound)
        out = child.compile(e.expr)
        _adopt_errors(comp, child, 1)
        if _is_null(acc) or _is_null(out):
            out, acc = comp._promote(out, acc)
        else:
            # the accumulator may take another kind (``s = 0`` then a
            # string or a map): "any" values, as the oracle's Python
            # values are
            out, acc = comp._unify(out, acc)
        if out.kind != acc.kind:
            raise UnsupportedOnDevice(f"reduce: the accumulator changes "
                                      f"kind from {acc.kind} to {out.kind}")
        ctype = acc.ctype if not _is_null(acc) else out.ctype
        acc = comp._choose(step, out, acc)
        acc.ctype = ctype
    return dataclasses.replace(acc, valid=acc.valid & lst.valid, host=None)


# -- paths and Disjoint ----------------------------------------------------

def path_nodes(comp: DeviceExprCompiler, e: E.PathNodes) -> Column:
    """nodes(p): the start node, then each hop's far end, walking the
    hops' relationships through the index (the oracle's ``_path_nodes``:
    the next node is the relationship's other end from the current
    one); null where a hop is null."""
    start = comp.compile(e.start)
    if _is_null(start):
        return comp._null()
    idx = entity_index(comp, "rel")
    v = E.Var(_IX)
    cur = start.data.long()
    valid = start.valid
    values, keeps = [cur], [comp._full(True)]
    for piece, is_list in zip(e.pieces, e.is_list):
        p = comp.compile(piece)
        if _is_null(p):
            valid = comp._full(False)
            continue
        valid = valid & p.valid
        hops = ([(p.data[:, i], p.lens > i) for i in range(p.data.shape[1])]
                if is_list else [(p.data, comp._full(True))])
        for rid, active in hops:
            row, found = idx.lookup(rid, active & p.valid)
            src = idx.field(E.StartNode(v), row, found).data.long()
            tgt = idx.field(E.EndNode(v), row, found).data.long()
            nxt = torch.where(src == cur, tgt, src)
            cur = torch.where(active, nxt, cur)
            values.append(nxt)
            keeps.append(active)
    data, _ev, lens = left_pack(torch.stack(values, dim=1).to(torch.int32),
                                torch.stack(keeps, dim=1))
    return Column("list", data, valid, CTList(CTNode()), lens)


def disjoint(comp: DeviceExprCompiler, e: E.Disjoint) -> Column:
    """True where two lists share no element: every valid pair of
    elements compared, ``(capacity, Wa, Wb)``."""
    a, b = comp.compile(e.lhs), comp.compile(e.rhs)
    if _is_null(a) or _is_null(b):
        return comp._null()
    if a.kind != "list" or b.kind != "list" or a.nested or b.nested \
            or "any" in (a.elem_kind, b.elem_kind) \
            or "map" in (a.elem_kind, b.elem_kind):
        raise UnsupportedOnDevice(f"Disjoint of kinds {a.kind}/{b.kind} "
                                  f"of {a.elem_kind}/{b.elem_kind}")
    dtype = torch.float64 if "float" in (a.elem_kind, b.elem_kind) \
        else torch.int64
    eq = a.data.to(dtype)[:, :, None] == b.data.to(dtype)[:, None, :]
    both = a.elem_ok()[:, :, None] & b.elem_ok()[:, None, :]
    hit = (eq & both).flatten(1).any(dim=1)
    return Column("bool", ~hit, a.valid & b.valid, CTBoolean)
