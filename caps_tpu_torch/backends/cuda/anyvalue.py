"""Mixed-type values on the device: "any" columns and lists of them.

An "any" value is a tag (int8, ``column.py ANY_TAGS``) and an int64
payload: a string's pool code, a boolean's 0/1, the integer, the
float's bits, a datetime's epoch microseconds, a date's epoch days.  A
list of CTNumber or CTAny elements holds them in its matrix with a tag
matrix beside it.

Every comparison goes through one view of a value, (class, f, i): the
class is the value's rank in the global sort order (``okapi/values.py
_ORDER_RANK``: string, boolean, number, datetime, date), and within a
class ``f`` (float64) then ``i`` (int64) order the values.  A number's
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
from typing import List, Tuple

import torch

from caps_tpu_torch.backends.cuda.column import ANY_TAGS, TAG, Column

# the class (sort rank) of each tag: ints and floats share one
_CLASS_OF_TAG = {"str": 0, "bool": 1, "int": 2, "float": 2, "datetime": 3,
                 "date": 4, "duration": 5}
# plain kinds that an "any" value can hold
HELD_KINDS = ("str", "bool", "int", "float", "datetime", "date",
              "duration")
_TWO_63 = 2.0 ** 63
TAG_INT, TAG_FLOAT = TAG["int"], TAG["float"]


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
    """A column of a kind an "any" value holds, as "any" values."""
    if c.kind == "any":
        return c
    if c.kind not in HELD_KINDS:
        from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice
        raise UnsupportedOnDevice(f"a {c.kind} among values of other types")
    data = float_bits(c.data) if c.kind == "float" \
        else c.data.to(torch.int64)
    shape = c.data.shape[:-1] if c.kind == "duration" else c.data.shape
    tags = torch.full(shape, TAG[c.kind], dtype=torch.int8,
                      device=c.data.device)
    return Column("any", data, c.valid, c.ctype, tags=tags)


def list_to_any(c: Column) -> Column:
    """A list column of a kind an "any" value holds as a list of "any"
    values."""
    if c.tags is not None:
        return c
    ek = c.elem_kind
    if c.nested or c.fields is not None or ek not in HELD_KINDS:
        from caps_tpu_torch.backends.cuda.expr import UnsupportedOnDevice
        raise UnsupportedOnDevice(f"a list of {ek} among lists of other "
                                  f"types")
    data = float_bits(c.data) if ek == "float" else c.data.to(torch.int64)
    tags = torch.full(c.data.shape[:2], TAG[ek], dtype=torch.int8,
                      device=c.data.device)
    return dataclasses.replace(c, data=data, tags=tags, host=None)


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


def stack(cols: List[Column], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(payload, tags) of scalar columns side by side: ``(capacity,
    k)`` "any" elements of a list literal of columns of several kinds
    (a null item's tag is 0)."""
    parts = [to_any(c) for c in cols]
    if any(p.data.dim() > p.tags.dim() for p in parts):
        parts = [widen(p) for p in parts]
    return (torch.stack([p.data for p in parts], dim=1),
            torch.stack([p.tags for p in parts], dim=1))
