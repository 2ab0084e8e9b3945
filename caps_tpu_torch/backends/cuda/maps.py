"""Maps on the device.

A map column has a key set fixed when the expression compiles (in the
order the reference's maps print: a literal's order, then the keys a
CASE or UNION adds) and, per row, which of those keys it holds:
``data`` is bool ``(capacity, K)``, and ``fields`` maps each key to a
child column.  Where rows print their keys in orders of their own (a
CASE of ``{b: 1, a: 2}`` and ``{a: 3, b: 4}``), ``order`` holds each
key's place in its row's order (:func:`ranks`, :func:`in_order`).  A key can be present and null (``{a:
null}``) or absent (``properties(n)`` of a node without that property),
as the reference's dicts tell them apart.  A list of maps is the same
with list columns as children (``column.py``).

The semantics are the oracle's (``backends/local/expr.py``: ``MapLit``,
``Keys`` / ``Properties``, ``Property`` of a map; ``okapi/values.py``:
``cypher_equals`` and ``_order_key`` of dicts).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Tuple

import torch

from caps_tpu_torch.backends.cuda.column import Column
from caps_tpu_torch.ir import exprs as E
from caps_tpu_torch.okapi.types import CTMap


def make(fields: Mapping[str, Column], present: Mapping[str, torch.Tensor],
         valid: torch.Tensor, order: torch.Tensor = None) -> Column:
    """A map column of children and their presence masks, by key (in
    the order of ``fields``, or each row's ``order``)."""
    keys = list(fields)
    data = (torch.stack([present[k] for k in keys], dim=1) if keys else
            torch.zeros((valid.shape[0], 0), dtype=torch.bool,
                        device=valid.device))
    return Column("map", data, valid, CTMap,
                  fields={k: fields[k] for k in keys}, order=order)


def in_order(ms: List[Column], keys: List[str]) -> bool:
    """True where every map (or list of maps) of ``ms`` prints its keys
    in the order they have in ``keys``: a column of them needs no
    ``order``."""
    return all(m.order is None and list(m.fields) == [
        k for k in keys if k in m.fields] for m in ms)


def ranks(m: Column, keys: List[str]) -> torch.Tensor:
    """int8, ``m.data``'s shape over ``keys``: each key's place in each
    row's print order of the map (or list of maps) ``m`` (its ``order``,
    else its keys' order; 0 for a key ``m`` lacks)."""
    own = list(m.fields)
    shape = m.data.shape[:-1]
    out = []
    for k in keys:
        if k not in own:
            out.append(torch.zeros(shape, dtype=torch.int8,
                                   device=m.data.device))
        elif m.order is not None:
            out.append(m.order[..., own.index(k)])
        else:
            out.append(torch.full(shape, own.index(k), dtype=torch.int8,
                                  device=m.data.device))
    return (torch.stack(out, dim=-1) if out else
            torch.zeros(shape + (0,), dtype=torch.int8, device=m.data.device))


def literal(comp, e: E.MapLit) -> Column:
    """``{k: expr, ...}``: every key present in every row."""
    cols = {k: comp.compile(v) for k, v in zip(e.keys, e.values)}
    full = comp._full(True)
    return make(cols, dict.fromkeys(cols, full), full)


def constant(comp, value: Mapping) -> Column:
    """A constant map (a map parameter, a map inside a list constant)
    broadcast to every row."""
    cols = {}
    for k, v in value.items():
        if isinstance(v, Mapping):
            cols[k] = constant(comp, v)
        elif isinstance(v, (list, tuple)):
            cols[k] = comp._const_list(list(v))
        else:
            cols[k] = comp._literal(v)
    full = comp._full(True)
    return make(cols, dict.fromkeys(cols, full), full)


def of_properties(names: List[str], cols: List[Column],
                  valid: torch.Tensor) -> Column:
    """An entity's properties as a map: a key where its property is set
    (``properties(n)``)."""
    return make(dict(zip(names, cols)),
                {k: c.valid for k, c in zip(names, cols)}, valid)


def properties(comp, e: E.Properties) -> Column:
    """``properties(n)`` of a header variable: its property columns (as
    the oracle, whose header holds none for a variable bound to a map
    value, which so gives the empty map)."""
    ent = e.entity
    if not isinstance(ent, E.Var):
        from caps_tpu_torch.relational.table import ExprEvalError
        raise ExprEvalError(f"keys()/properties() on {ent!r}")
    base = comp.compile(ent)
    items = sorted((he.key, he) for he in comp.header.exprs
                   if isinstance(he, E.Property) and he.entity == ent)
    return of_properties([k for k, _ in items],
                         [comp.compile(he) for _, he in items], base.valid)


def field(comp, m: Column, key: str) -> Column:
    """``m.key``: the child where the key is present, else null."""
    c = m.fields.get(key)
    if c is None:
        return comp._null()
    j = list(m.fields).index(key)
    present = m.data[..., j] & m.valid
    return dataclasses.replace(c, valid=c.valid & present, host=None)


def keys(comp, m: Column) -> Column:
    """``keys(m)``: the present keys, sorted, as a string list."""
    from caps_tpu_torch.backends.cuda.lists import _names_list
    names = sorted(m.fields)
    at = list(m.fields)
    return _names_list(comp, names, [m.data[:, at.index(k)] for k in names],
                       m.valid)


EqualFn = Callable[[Column, Column], Tuple[torch.Tensor, torch.Tensor]]


def equal(l: Column, r: Column, equal_cols: EqualFn
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cypher_equals`` of two maps as (equal, known): the key sets
    must match; a null value comparison makes the answer null unless
    another key's values differ."""
    dev = l.valid.device
    cap = l.valid.shape[0]
    no = torch.zeros(cap, dtype=torch.bool, device=dev)
    differ, unknown = no, no
    for k in sorted(set(l.fields) | set(r.fields)):
        pl = l.data[:, list(l.fields).index(k)] if k in l.fields else no
        pr = r.data[:, list(r.fields).index(k)] if k in r.fields else no
        differ = differ | (pl != pr)
        if k in l.fields and k in r.fields:
            eq, known = equal_cols(l.fields[k], r.fields[k])
            both = pl & pr
            differ = differ | (both & known & ~eq)
            unknown = unknown | (both & ~known)
    return ~differ & ~unknown, differ | ~unknown


def sort_keys(c: Column, ascending: bool, nulls_last: bool,
              child_keys: Callable[[Column], List[torch.Tensor]]
              ) -> List[torch.Tensor]:
    """Sort planes of a map column in ``_order_key``'s order: its
    (key, value) pairs sorted by key, compared pair by pair, a shorter
    map first where one is the other's prefix.  Per key: 1 where the
    key is present (then its value's planes), 2 where it is absent and
    a later key is present (the other map's pair sorts first: its key
    is smaller), 0 where no later key is present (the map ends)."""
    null_key = (~c.valid).to(torch.int64)
    if not nulls_last:
        null_key = -null_key
    sign = 1 if ascending else -1
    names = sorted(c.fields)
    order = [list(c.fields).index(k) for k in names]
    present = (c.data & c.valid[:, None])[:, order]
    K = present.shape[1]
    # any key after position j present
    later = torch.zeros_like(present)
    if K > 1:
        rev = torch.flip(present, dims=[1]).to(torch.int32)
        after = torch.flip(torch.cumsum(rev, dim=1), dims=[1]) > 0
        later[:, :-1] = after[:, 1:]
    keys = [null_key]
    for j, child in enumerate(c.fields[k] for k in names):
        tag = torch.where(present[:, j], 1,
                          torch.where(later[:, j], 2, 0)).to(torch.int64)
        keys.append(sign * tag)
        planes = child_keys(child)
        keys.extend(torch.where(present[:, j], p, torch.zeros_like(p))
                    for p in planes)
    return keys


def stack(comp, cols: List[Column]) -> Column:
    """A list literal of maps: ``(capacity, k, K)`` presence over the
    union of their keys and, per key, the list of its values (null
    where an item lacks the key); a null item a null element."""
    from caps_tpu_torch.backends.cuda.expr import _is_null
    from caps_tpu_torch.backends.cuda.lists import stack_items
    names = list(dict.fromkeys(k for c in cols if not _is_null(c)
                               for k in c.fields))
    no = comp._full(False)
    present, fields = [], {}
    for k in names:
        items, here = [], []
        for c in cols:
            if _is_null(c) or k not in c.fields:
                items.append(comp._null())
                here.append(no)
            else:
                items.append(c.fields[k])
                here.append(c.data[:, list(c.fields).index(k)] & c.valid)
        fields[k] = stack_items(comp, items)
        present.append(torch.stack(here, dim=1))
    cap = comp.capacity
    data = (torch.stack(present, dim=2) if names else
            torch.zeros((cap, len(cols), 0), dtype=torch.bool,
                        device=comp.device))
    maps = [c for c in cols if not _is_null(c)]
    order = None if in_order(maps, names) else torch.stack([
        ranks(c, names) if not _is_null(c) else torch.zeros(
            (cap, len(names)), dtype=torch.int8, device=comp.device)
        for c in cols], dim=1)
    from caps_tpu_torch.okapi.types import CTList
    lens = torch.full((cap,), len(cols), dtype=torch.int32,
                      device=comp.device)
    return Column("list", data, comp._full(True), CTList(CTMap), lens,
                  elem_valid=torch.stack([c.valid for c in cols], dim=1),
                  fields=fields, order=order)
