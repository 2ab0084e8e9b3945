"""Mixed-type values on the device: "any" columns and lists of them.

An "any" value is a tag (int8, ``column.py ANY_TAGS``) and an int64
payload: a string's pool code, a boolean's 0/1, the integer, the
float's bits, a datetime's epoch microseconds, a date's epoch days, a
list's row in the column's ``child`` (the held lists, a list column of
any kind), a map's row in its ``maps`` (the held maps, one map column).
A list of CTNumber or CTAny elements holds them in its matrix with a
tag matrix beside it (and its held lists and maps the same way).  The
side columns are shared by every column taken from this one, so a
gather of the rows moves no held list or map; where two columns of
"any" values meet (a CASE, a UNION, a list literal) their side columns
are concatenated once (:func:`share`).

Every comparison goes through one view of a value, (class, f, i): the
class is the value's rank in the global sort order (``okapi/values.py
_ORDER_RANK``: map, list, string, boolean, number, datetime, date), and
within a class ``f`` (float64) then ``i`` (int64) order the values (a
held list or map orders and equals by its own planes: ``table.py
_sort_keys``, ``expr.py equal_cols``).  A number's
``f`` is its nearest float and ``i`` what the value lies above that
float (an integer beyond 2^53 against a float compares exactly, as
Python compares them); a string's ``i`` is its rank in the pool, the
others' their payload.  So ``1 = 1.0`` and ``1 <> true``
(``cypher_equals``), values of two classes compare to null
(``cypher_lt``), and DISTINCT, grouping and ORDER BY sort by the class
then the value (``_order_key``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from caps_tpu_torch.backends.cuda.column import (
    ANY_TAGS, TAG, Column, decode_any, elem_at, map_in_order,
)
from caps_tpu_torch.okapi.types import CTAny

# the class (sort rank) of each tag: ints and floats share one; maps then
# lists before strings (an entity id's class is -1: ``view``)
_CLASS_OF_TAG = {"map": -3, "list": -2, "str": 0, "bool": 1, "int": 2,
                 "float": 2, "datetime": 3, "date": 4, "duration": 5}
# the kinds of a list element that an "any" value holds as itself
SCALAR_KINDS = ("str", "bool", "int", "float", "datetime", "date",
                "duration")
# the kinds of a column that an "any" value can hold
HELD_KINDS = SCALAR_KINDS + ("list", "map")
_TWO_63 = 2.0 ** 63
TAG_INT, TAG_FLOAT = TAG["int"], TAG["float"]
# the side column of each tag that an "any" value holds by its row
SIDES = (("list", "child"), ("map", "maps"))


def num_view(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nearest float64, exact remainder) of int64 values: ``x - f`` as
    an integer, computed without overflow where ``f`` is 2^63."""
    f = x.to(torch.float64)
    big = f >= _TWO_63
    fi = torch.where(big, torch.zeros_like(f), f).to(torch.int64)
    half = 1 << 62
    rest = torch.where(big, (x - half) - half, x - fi)
    return f, rest


def float_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64).contiguous().view(torch.int64)


def bits_float(p: torch.Tensor) -> torch.Tensor:
    return p.contiguous().view(torch.float64)


def payload(c: Column) -> torch.Tensor:
    """The one-plane payload of "any" values: the first column of a
    3-wide payload (a duration's months)."""
    return c.data[..., 0] if c.data.dim() > c.tags.dim() else c.data


def widen(c: Column) -> Column:
    """"any" values (or a list of them) with a 3-wide payload."""
    if c.data.dim() > c.tags.dim():
        return c
    z = torch.zeros_like(c.data)
    return dataclasses.replace(c, data=torch.stack([c.data, z, z], dim=-1),
                               host=None)


def extra(c: Column) -> torch.Tensor:
    """A duration's days and seconds per value (zeros for the other
    values)."""
    if c.data.dim() > c.tags.dim():
        return c.data[..., 1:]
    return torch.zeros(c.data.shape + (2,), dtype=torch.int64,
                       device=c.data.device)


def to_any(c: Column) -> Column:
    """A column of a kind an "any" value holds, as "any" values: a list
    or map column becomes the side column of the values, each row
    holding its own row (nothing is copied); an entity id is its
    integer, as the oracle's values are."""
    if c.kind == "any":
        return c
    dev = c.data.device
    if c.kind in ("list", "map"):
        tags = torch.full((c.capacity,), TAG[c.kind], dtype=torch.int8,
                          device=dev)
        side = "child" if c.kind == "list" else "maps"
        return Column("any", torch.arange(c.capacity, device=dev), c.valid,
                      CTAny, tags=tags, **{side: c})
    if c.kind == "id":
        c = c.astype_kind("int")
    if c.kind not in SCALAR_KINDS:
        from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice
        raise UnsupportedOnDevice(f"a value of kind {c.kind} has no device "
                                  f"representation as a mixed value")
    data = float_bits(c.data) if c.kind == "float" \
        else c.data.to(torch.int64)
    shape = c.data.shape[:-1] if c.kind == "duration" else c.data.shape
    tags = torch.full(shape, TAG[c.kind], dtype=torch.int8, device=dev)
    return Column("any", data, c.valid, c.ctype, tags=tags)


def list_to_any(c: Column) -> Column:
    """A list column as a list of "any" values: a list of lists holds
    its inner lists (the same rows of the same child), a list of maps
    its maps (the elements laid out as one map column, a row each), a
    list of ids their integers."""
    if c.tags is not None:
        return c
    dev = c.data.device
    shape = c.data.shape[:2]
    if c.nested:
        return dataclasses.replace(
            c, tags=torch.full(shape, TAG["list"], dtype=torch.int8,
                               device=dev), host=None)
    if c.fields is not None:
        cap, W = shape
        flat = torch.arange(cap * W, device=dev)
        side = elem_at(c, flat // W, flat % W, torch.ones_like(
            flat, dtype=torch.bool))
        return Column("list", flat.reshape(cap, W), c.valid, c.ctype, c.lens,
                      elem_valid=c.elem_valid,
                      tags=torch.full(shape, TAG["map"], dtype=torch.int8,
                                      device=dev), maps=side)
    ek = "int" if c.elem_kind == "id" else c.elem_kind
    if ek not in SCALAR_KINDS:
        from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice
        raise UnsupportedOnDevice(f"a list of {ek} has no device "
                                  f"representation as mixed values")
    data = float_bits(c.data) if ek == "float" else c.data.to(torch.int64)
    tags = torch.full(shape, TAG[ek], dtype=torch.int8, device=dev)
    return dataclasses.replace(c, data=data, tags=tags, host=None)


def held(c: Column, kind: str, where: torch.Tensor = None):
    """The lists (``kind`` 'list') or maps ('map') that "any" values hold,
    one per row of ``c`` (a gather of the side column at the payloads),
    valid where the row holds one (and ``where``); None where ``c``
    holds none."""
    side = getattr(c, dict(SIDES)[kind])
    if side is None:
        return None
    p = payload(c).clamp(0, side.capacity - 1)
    out = side.take(p)
    ok = c.valid & (c.tags == TAG[kind])
    out.valid = out.valid & ok if where is None else out.valid & ok & where
    return out


def _offset(c: Column, kind: str, n: int) -> torch.Tensor:
    """``c``'s payload with ``n`` added where a value of ``kind`` is
    held: its rows moved past ``n`` rows of another side column."""
    hit = c.tags == TAG[kind]
    if c.data.dim() > c.tags.dim():
        first = torch.where(hit, c.data[..., 0] + n, c.data[..., 0])
        return torch.cat([first[..., None], c.data[..., 1:]], dim=-1)
    return torch.where(hit, c.data + n, c.data)


def share(a: Column, b: Column) -> Tuple[Column, Column]:
    """Two columns of "any" values (or lists of them) over one side
    column of each kind: the held lists (maps) of both brought to one
    kind and concatenated, ``b``'s payloads moved past ``a``'s rows
    (nothing moves where both share one, or one side holds none)."""
    from caps_tpu_torch.backends.cuda.table import (
        _concat_columns, _union_pair,
    )
    for kind, attr in SIDES:
        sa, sb = getattr(a, attr), getattr(b, attr)
        if sb is None or sa is sb:
            continue
        if sa is None:
            a = dataclasses.replace(a, **{attr: sb})
            continue
        ca, cb = _union_pair(sa, sb, "held value")
        n_a, n_b = ca.capacity, cb.capacity
        side = _concat_columns(ca, n_a, cb, n_b, n_a + n_b,
                               ca.ctype.join(cb.ctype))
        b = dataclasses.replace(b, data=_offset(b, kind, n_a), host=None,
                                **{attr: side})
        a = dataclasses.replace(a, host=None, **{attr: side})
    return a, b


def share_all(cols: List[Column]) -> List[Column]:
    """:func:`share` over several columns: one side column of each kind
    for all of them."""
    out = list(cols)
    for i in range(1, len(out)):
        out[0], out[i] = share(out[0], out[i])
    sides = {attr: getattr(out[0], attr) for _kind, attr in SIDES}
    return [dataclasses.replace(c, **sides) for c in out]


def view(c: Column, rank: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(class int64, f float64, i int64) of a scalar column of a kind an
    "any" value holds, or of an "any" column; ``rank`` is the pool's
    rank array on the device.  An entity id gets class -1: it equals
    and orders with no value here."""
    dev = c.data.device
    if c.kind != "any":
        if c.kind == "id":
            z = torch.zeros(c.data.shape, dtype=torch.int64, device=dev)
            return z - 1, z.to(torch.float64), c.data.to(torch.int64)
        c = to_any(c)
    tags = c.tags.to(torch.int64)
    classes = torch.tensor([_CLASS_OF_TAG[k] for k in ANY_TAGS],
                           dtype=torch.int64, device=dev)
    cls = classes[tags]
    p = payload(c)
    nf, nrest = num_view(p)
    is_int = tags == TAG["int"]
    is_float = tags == TAG["float"]
    f = torch.where(is_int, nf, torch.where(is_float, bits_float(p),
                                            torch.zeros_like(nf)))
    i = torch.where(is_int, nrest, torch.where(is_float,
                                               torch.zeros_like(p), p))
    is_str = tags == TAG["str"]
    if rank.shape[0]:
        i = torch.where(is_str, rank[p.clamp(0, rank.shape[0] - 1)].to(
            torch.int64), i)
    # (a held list's or map's payload is a row, no value: its own planes
    # order it)
    i = torch.where(cls < 0, torch.zeros_like(i), i)
    return cls, f, i


def equal(l: Column, r: Column, rank: torch.Tensor) -> torch.Tensor:
    """``cypher_equals`` of two columns, one of them "any" (validity
    apart): same class and same value."""
    lc, lf, li = view(l, rank)
    rc, rf, ri = view(r, rank)
    same = (lc == rc) & (lc >= 0) & (lf == rf) & (li == ri)
    if l.kind == "any" and l.data.dim() > l.tags.dim() or \
            r.kind == "any" and r.data.dim() > r.tags.dim():
        same = same & (_extra_of(l) == _extra_of(r)).all(dim=-1)
    return same


def _extra_of(c: Column) -> torch.Tensor:
    """:func:`extra` of "any" values; zeros for a plain column (a
    duration column's days and seconds)."""
    if c.kind == "duration":
        return c.data[..., 1:]
    if c.kind == "any":
        return extra(c)
    return torch.zeros(c.valid.shape + (2,), dtype=torch.int64,
                       device=c.valid.device)


def less(l: Column, r: Column, rank: torch.Tensor, or_equal: bool
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cypher_lt`` (or ``_lte``) of two columns, one of them "any":
    (answer, comparable), null where the classes differ."""
    lc, lf, li = view(l, rank)
    rc, rf, ri = view(r, rank)
    lt = (lf < rf) | ((lf == rf) & (li < ri))
    if or_equal:
        lt = lt | ((lf == rf) & (li == ri))
    # durations do not order
    return lt, (lc == rc) & (lc >= 0) & (lc != _CLASS_OF_TAG["duration"])


def sort_keys(c: Column, ascending: bool, nulls_last: bool,
              rank: torch.Tensor) -> List[torch.Tensor]:
    """Sort planes of an "any" column in the global sort order: the null
    key, the class, then the value's f and i."""
    null_key = (~c.valid).to(torch.int64)
    if not nulls_last:
        null_key = -null_key
    cls, f, i = view(c, rank)
    planes = [cls, f, i]
    if c.data.dim() > c.tags.dim():
        # a duration's days and seconds after its months
        planes += list(extra(c).unbind(-1))
    keys = []
    for k in planes:
        k = torch.where(c.valid, k, torch.zeros_like(k))
        keys.append(k if ascending else -k)
    return [null_key] + keys


def stack(cols: List[Column]) -> Column:
    """Columns of several kinds side by side as ``(capacity, k)`` "any"
    elements, the list of a list literal (a null item's tag is 0): the
    lists and maps among them held in one side column each."""
    parts = share_all([to_any(c) for c in cols])
    if any(p.data.dim() > p.tags.dim() for p in parts):
        parts = [widen(p) for p in parts]
    return Column("list", torch.stack([p.data for p in parts], dim=1),
                  parts[0].valid, parts[0].ctype,
                  tags=torch.stack([p.tags for p in parts], dim=1),
                  child=parts[0].child, maps=parts[0].maps)


def identity(c: Column) -> Tuple[List[torch.Tensor], Callable]:
    """(planes, decode) of a column.  The planes are int64, one value
    per row, equal exactly where two rows hold the same value (the same
    kind, the same bits: 1 and 1.0 differ, as their texts do; a map's
    keys in the same print order): validity, then the value's own
    planes, zero where the value is null; a list's length and each
    position's planes, a map's presence (and each key's place in its
    row's order) and each key's planes, an "any" value's tag and payload
    with its held list's or map's planes.  ``decode(rows, pool)`` turns
    an int64 matrix of rows of those planes into host values (None for a
    null row), so the distinct values of a column are read to the host
    in one transfer however deep they are."""
    v = c.valid
    planes = [v.to(torch.int64)]

    def masked(ps):
        return [torch.where(v, p, torch.zeros_like(p)) for p in ps]

    def part(col: Column) -> Callable:
        """``col``'s planes appended; its decoder of their columns."""
        ps, dec = identity(col)
        at = slice(len(planes), len(planes) + len(ps))
        planes.extend(ps)
        return lambda m, pool: dec(m[:, at], pool)

    if c.kind == "list":
        planes.append(torch.where(v, c.lens.to(torch.int64), 0))
        rows = torch.arange(c.capacity, device=v.device)
        elems = [part(elem_at(c, rows, torch.full_like(rows, j),
                              v & (j < c.lens)))
                 for j in range(c.data.shape[1])]

        def decode(m, pool):
            cols = [d(m, pool) for d in elems]
            return [[col[i] for col in cols[:n]] if ok else None
                    for i, (ok, n) in enumerate(m[:, :2].tolist())]
        return planes, decode
    if c.kind == "map":
        keys = list(c.fields)
        at, kids = [], []
        for j, f in enumerate(c.fields.values()):
            here = v & c.data[:, j]
            at.append(len(planes))
            planes.append(here.to(torch.int64))
            if c.order is not None:
                planes.append(torch.where(here, c.order[:, j].to(
                    torch.int64), 0))
            kids.append(part(dataclasses.replace(f, valid=f.valid & here)))

        def decode(m, pool):
            vals = [d(m, pool) for d in kids]
            out = []
            for i, r in enumerate(m.tolist()):
                ranks = None if c.order is None else [r[a + 1] for a in at]
                out.append(map_in_order(keys, [r[a] for a in at],
                                        [x[i] for x in vals], ranks)
                           if r[0] else None)
            return out
        return planes, decode
    if c.kind == "any":
        side = torch.zeros_like(v)
        for kind, _attr in SIDES:
            side = side | (c.tags == TAG[kind])
        data = c.data if c.data.dim() > 1 else c.data[:, None]
        w = data.shape[1]
        planes += masked([c.tags.to(torch.int64)] + [
            torch.where(side, torch.zeros_like(p), p)
            for p in data.unbind(1)])
        helds = {TAG[kind]: part(h) for kind, _attr in SIDES
                 if (h := held(c, kind)) is not None}

        def decode(m, pool):
            ok = m[:, 0] != 0
            tags = m[:, 1].astype(np.int8)
            out = _fill(ok, decode_any(tags[ok], m[ok, 2] if w == 1
                                       else m[ok, 2:2 + w], pool))
            for tag, d in helds.items():
                vals = d(m, pool)
                for i in np.flatnonzero(ok & (tags == tag)).tolist():
                    out[i] = vals[i]
            return out
        return planes, decode
    if c.kind not in SCALAR_KINDS + ("id",):
        from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice
        raise UnsupportedOnDevice(f"a value of kind {c.kind} has no "
                                  f"host form")
    if c.kind == "float":
        data = c.data.contiguous().view(torch.int64)
    else:
        data = c.data.to(torch.int64)
    planes += masked(list(data.unbind(1)) if data.dim() > 1 else [data])
    tag = TAG["int" if c.kind == "id" else c.kind]

    def decode(m, pool):
        ok = m[:, 0] != 0
        tags = np.full(int(ok.sum()), tag, dtype=np.int8)
        return _fill(ok, decode_any(tags, m[ok, 1] if m.shape[1] == 2
                                    else m[ok, 1:], pool))
    return planes, decode


def _fill(ok: np.ndarray, vals: List[Any]) -> List[Any]:
    """``vals`` placed at the rows ``ok``, None at the others."""
    out: List[Any] = [None] * len(ok)
    for i, x in zip(np.flatnonzero(ok).tolist(), vals):
        out[i] = x
    return out


def as_list(c: Column) -> Column:
    """"any" values as one list per row, a list of "any" values: a held
    list as itself, another value as a list of one (the oracle's ``+``
    and UNWIND of a value that is not a list); null where ``c`` is."""
    from caps_tpu_torch.backends.cuda.column import pad_width
    from caps_tpu_torch.okapi.types import CTList
    dev = c.data.device
    single = Column("list", c.data[:, None], c.valid, CTList(CTAny),
                    torch.ones(c.capacity, dtype=torch.int32, device=dev),
                    tags=c.tags[:, None], child=c.child, maps=c.maps)
    h = held(c, "list")
    if h is None:
        return single
    h, single = share(list_to_any(h), single)
    if h.data.dim() != single.data.dim():
        h, single = widen(h), widen(single)
    take = c.tags == TAG["list"]
    width = max(h.data.shape[1], 1)

    def pick(x, y, fill):
        x, y = pad_width(x, width, fill), pad_width(y, width, fill)
        return torch.where(take.view(-1, *([1] * (x.dim() - 1))), x, y)
    return Column("list", pick(h.data, single.data, 0), c.valid,
                  CTList(CTAny), torch.where(take, h.lens, single.lens),
                  elem_valid=pick(h.valid_elems(), single.valid_elems(),
                                  True),
                  tags=pick(h.tags, single.tags, 0), child=h.child,
                  maps=h.maps)
