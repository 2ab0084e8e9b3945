"""Device column representation and CypherType → dtype mapping.

A column is (data, valid): a device tensor padded to the table's bucketed
capacity plus a validity mask (False = Cypher null).  Row padding beyond
the table's live row count is tracked table-level, not per column.

Kinds:
    id     int32   entity ids (dense, < 2^31)
    int    int64   CTInteger properties (Cypher integers are 64-bit)
    float  float64 CTFloat/CTNumber
    bool   bool
    str    int32   dictionary codes into the session StringPool
    date / datetime  int64  epoch days / epoch microseconds
    duration int64 (capacity, 3): months, days, seconds
    any    int64 payload + ``tags`` int8: a value of one of ANY_TAGS per
           row (CTAny, and CTNumber elements): string code, 0/1, the
           int, the float's bits, epoch µs, epoch days; where a
           duration is among the values the payload is (capacity, 3),
           a duration's months, days and seconds, the others' payload
           first and zeros after
    map    bool (capacity, K) presence of each key + ``fields``: key →
           child column (keys sorted; a key may be present and null)
    list   2D (capacity, max_len) + lens (+ elem_valid): the element
           kind's dtype — int32 for ids and string codes, int64 for
           ints, dates, datetimes and "any" payloads (+ ``tags``),
           float64 for floats, bool for booleans; a list of durations
           is int64 (capacity, max_len, 3); a list of maps is presence
           (capacity, max_len, K) + ``fields`` of lists; a list of lists,
           at any depth, is int64 (capacity, max_len) + ``child``: each
           element's row in a list column of the inner lists (itself a
           list of any kind, nested again or not)
    object —       host-only values; no device path
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from caps_tpu_torch.okapi.types import (
    CTBoolean, CTDate, CTDateTime, CTDuration, CTFloat, CTInteger, CTMap,
    CTNumber, CTString, CypherType, _CTAny, _CTList, _CTNode,
    _CTRelationship,
)

_DTYPES = {
    "id": torch.int32,
    "int": torch.int64,
    "float": torch.float64,
    "bool": torch.bool,
    "str": torch.int32,
    "date": torch.int64,
    "datetime": torch.int64,
    "duration": torch.int64,
    "any": torch.int64,
    "map": torch.bool,
    "list": torch.int64,   # a list of lists: the inner lists' child rows
}
_NP_DTYPES = {
    "id": np.int32, "int": np.int64, "float": np.float64, "bool": np.bool_,
    "str": np.int32, "date": np.int64, "datetime": np.int64,
    "duration": np.int64, "any": np.int64, "list": np.int64,
}

# The kinds an "any" value may hold, by tag (int8).
ANY_TAGS = ("str", "bool", "int", "float", "datetime", "date", "duration")
TAG = {k: i for i, k in enumerate(ANY_TAGS)}


def list_elem_kind(ctype: CypherType) -> Optional[str]:
    """Element kind of a device-representable list type: rel/node ids,
    int, float, str codes, bool, date, datetime, duration, "any"
    (CTNumber and CTAny elements), map, list (a list of lists, at any
    depth).  None = no device representation (an element type not
    known)."""
    m = ctype.material
    if not isinstance(m, _CTList):
        return None
    inner = m.inner.material if m.inner is not None else None
    if isinstance(inner, _CTList):
        return "list"
    if isinstance(inner, (_CTRelationship, _CTNode)):
        return "id"
    if isinstance(inner, _CTAny) or inner == CTNumber:
        return "any"
    return {CTInteger: "int", CTFloat: "float", CTString: "str",
            CTBoolean: "bool", CTDate: "date", CTDateTime: "datetime",
            CTDuration: "duration", CTMap: "map"}.get(inner)


def kind_for(ctype: CypherType) -> str:
    m = ctype.material
    if isinstance(m, (_CTNode, _CTRelationship)):
        return "id"
    if isinstance(m, _CTList):
        if list_elem_kind(ctype) is not None:
            return "list"
        return "object"
    if isinstance(m, _CTAny):
        return "any"
    if m == CTInteger:
        return "int"
    if m in (CTFloat, CTNumber):
        return "float"
    return {CTBoolean: "bool", CTString: "str", CTDate: "date",
            CTDateTime: "datetime", CTDuration: "duration",
            CTMap: "map"}.get(m, "object")


_BY_DTYPE = {torch.int32: "id", torch.int64: "int", torch.float64: "float",
             torch.bool: "bool"}


@dataclasses.dataclass
class Column:
    kind: str
    data: torch.Tensor            # (capacity,) or (capacity, max_len)
    valid: torch.Tensor           # bool (capacity,)
    ctype: CypherType
    lens: Optional[torch.Tensor] = None  # int32 (capacity,) for kind="list"
    # Ingest-time host mirror (data_np, valid_np): scan columns keep the
    # numpy arrays they were built from, so host-side layout builders (the
    # CSR at ingest) never read graph columns back from the device.
    # Derived columns drop it.
    host: Optional[tuple] = None
    # bool (capacity, max_len) for kind="list": False marks a null
    # element.  None where no element can be null (collect drops nulls,
    # a path's hop ids are never null).
    elem_valid: Optional[torch.Tensor] = None
    # for a list of lists: the inner lists, one row each, at any depth
    # (``data`` holds each element's row; the rows are shared by every
    # column taken from this one, so a gather of the outer rows moves
    # no inner list)
    child: Optional["Column"] = None
    # int8, the shape of ``data``: each "any" value's kind (ANY_TAGS)
    tags: Optional[torch.Tensor] = None
    # a map's (or a list of maps') key → child column (a list column of
    # the list's shape for a list of maps), keys sorted
    fields: Optional[Dict[str, "Column"]] = None

    @property
    def nested(self) -> bool:
        """A list of lists."""
        return self.child is not None

    @property
    def depth(self) -> int:
        """A list column's levels of lists (1 for a list of values)."""
        return 1 + self.child.depth if self.nested else 1

    @property
    def elem_kind(self) -> str:
        """A list column's (innermost) element kind: its type's, else
        its dtype's (a list of no element type, or ids mixed with
        ints)."""
        if self.nested:
            return self.child.elem_kind
        if self.tags is not None:
            return "any"
        if self.fields is not None:
            return "map"
        k = list_elem_kind(self.ctype)
        return _BY_DTYPE[self.data.dtype] \
            if k in (None, "any", "map", "list") else k

    def take(self, idx: torch.Tensor) -> "Column":
        """The rows ``idx`` of this column (every per-row tensor)."""
        def t(x):
            return None if x is None else x[idx]
        return Column(
            self.kind, self.data[idx], self.valid[idx], self.ctype,
            t(self.lens), elem_valid=t(self.elem_valid), tags=t(self.tags),
            fields=(None if self.fields is None else
                    {k: c.take(idx) for k, c in self.fields.items()}),
            child=self.child)

    def to_device(self, device) -> "Column":
        """A copy of this column's tensors on ``device`` (the ingest-time
        host mirror shared)."""
        def t(x):
            return None if x is None else x.to(device, copy=True)
        return Column(
            self.kind, t(self.data), t(self.valid), self.ctype, t(self.lens),
            host=self.host, elem_valid=t(self.elem_valid), tags=t(self.tags),
            fields=(None if self.fields is None else
                    {k: c.to_device(device) for k, c in self.fields.items()}),
            child=None if self.child is None else self.child.to_device(device))

    def valid_elems(self) -> torch.Tensor:
        """bool (capacity, max_len): False on a null element of a list
        column, True elsewhere."""
        if self.elem_valid is not None:
            return self.elem_valid
        return torch.ones(self.data.shape[:2], dtype=torch.bool,
                          device=self.data.device)

    def elem_ok(self) -> torch.Tensor:
        """bool (capacity, max_len): the elements each row holds (within
        its length, non-null), False on a null list."""
        j = torch.arange(self.data.shape[1], device=self.data.device)
        ok = (j[None, :] < self.lens[:, None]) & self.valid[:, None]
        return ok if self.elem_valid is None else ok & self.elem_valid

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def host_arrays(self) -> Tuple[np.ndarray, np.ndarray, bool]:
        """(data, valid, read) as numpy: the ingest-time mirror when
        present (``read`` False), else one device read of each."""
        if self.host is not None:
            return self.host[0], self.host[1], False
        return self.data.cpu().numpy(), self.valid.cpu().numpy(), True

    def astype_kind(self, kind: str) -> "Column":
        if kind == self.kind:
            return self
        return Column(kind, self.data.to(_DTYPES[kind]), self.valid,
                      self.ctype, self.lens, elem_valid=self.elem_valid,
                      child=self.child)


def null_like(col: Column, valid: torch.Tensor) -> Column:
    """A column of ``col``'s kind, type and shape holding only zeros,
    with validity ``valid`` (all False: a null of that kind; a list of
    lists keeps its inner lists' rows)."""
    def z(x):
        return None if x is None else torch.zeros_like(x)
    return Column(col.kind, torch.zeros_like(col.data), valid, col.ctype,
                  z(col.lens), elem_valid=None, tags=z(col.tags),
                  fields=(None if col.fields is None else
                          {k: null_like(c, torch.zeros_like(c.valid))
                           for k, c in col.fields.items()}),
                  child=col.child)


def elem_at(lst: Column, row: torch.Tensor, j: torch.Tensor,
            ok: torch.Tensor) -> Column:
    """The elements ``lst[row, j]`` (index tensors of one shape) as a
    column of the element kind over those positions, valid where ``ok``
    and the element is not null (of a list of lists: the inner lists'
    rows, one level down)."""
    valid = ok & lst.valid_elems()[row, j]
    m = lst.ctype.material
    inner = m.inner if isinstance(m, _CTList) and m.inner is not None \
        else CTInteger
    if lst.nested:
        out = lst.child.take(lst.data[row, j])
        out.valid = out.valid & valid
        if isinstance(inner.material, _CTList):
            out.ctype = inner
        return out
    if lst.fields is not None:
        return Column("map", lst.data[row, j], valid, CTMap, fields={
            k: elem_at(c, row, j, ok) for k, c in lst.fields.items()})
    ek = lst.elem_kind
    return Column(ek, lst.data[row, j].to(_DTYPES[ek]), valid, inner,
                  tags=None if lst.tags is None else lst.tags[row, j])


def pad_width(t: torch.Tensor, width: int, fill=0) -> torch.Tensor:
    """A list tensor (rows, w, ...) padded along its list axis to
    ``width`` with ``fill``."""
    return torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 2) + (0, width - t.shape[1]), value=fill)


def list_dtype(elem_kind: str) -> torch.dtype:
    """The list matrix's dtype for an element kind."""
    return _DTYPES[elem_kind]


def encode_any(x: Any, pool) -> Tuple[int, Any]:
    """(tag, int64 payload) of one non-null host value of an "any"
    column (a duration's payload is its three fields); ValueError for a
    value no tag holds."""
    from caps_tpu_torch.okapi.values import (
        CypherDate, CypherDateTime, CypherDuration,
    )
    if isinstance(x, bool):
        return TAG["bool"], int(x)
    if isinstance(x, int):
        if not -2**63 <= x < 2**63:
            raise ValueError(f"integer {x} exceeds int64")
        return TAG["int"], x
    if isinstance(x, float):
        return TAG["float"], int(np.float64(x).view(np.int64))
    if isinstance(x, str):
        return TAG["str"], pool.encode(x)
    if isinstance(x, CypherDate):
        return TAG["date"], x.days
    if isinstance(x, CypherDateTime):
        return TAG["datetime"], x.micros
    if isinstance(x, CypherDuration):
        return TAG["duration"], (x.months, x.days, x.seconds)
    raise ValueError(f"a value of type {type(x).__name__} among values "
                     f"of other types has no device representation")


def _host_temporal(x: Any, kind: str) -> int:
    if kind == "date":
        return x.days if hasattr(x, "days") else int(x)
    return x.micros if hasattr(x, "micros") else int(x)


def make_column(values: Union[Sequence[Any], np.ndarray], ctype: CypherType,
                capacity: int, pool, device) -> Column:
    """Host values → device column (padded to capacity).  A numpy array
    of a numeric kind (or ``datetime64`` for dates and datetimes) is
    copied in bulk (no per-row Python work); a list may hold None for
    nulls."""
    kind = kind_for(ctype)
    n = len(values)
    valid_np = np.zeros(capacity, dtype=bool)
    if kind == "object":
        raise ValueError(f"type {ctype!r} has no device representation")
    if kind == "list":
        return _make_list(values, ctype, capacity, pool, device)
    if kind == "map":
        return _make_map(values, capacity, pool, device)
    if kind == "duration":
        data_np = np.zeros((capacity, 3), dtype=np.int64)
        for i, v in enumerate(values):
            if v is not None:
                valid_np[i] = True
                data_np[i] = (v.months, v.days, v.seconds)
        return Column(kind, _to(data_np, device), _to(valid_np, device),
                      ctype)
    data_np = np.zeros(capacity, dtype=_NP_DTYPES[kind])
    if kind == "any":
        tags_np = np.zeros(capacity, dtype=np.int8)
        if any(_is_duration(v) for v in values):
            data_np = np.zeros((capacity, 3), dtype=np.int64)
        for i, v in enumerate(values):
            if v is not None:
                valid_np[i] = True
                tags_np[i], code = encode_any(v, pool)
                put_payload(data_np, i, code)
        return Column(kind, _to(data_np, device), _to(valid_np, device),
                      ctype, tags=_to(tags_np, device))
    if kind == "str":
        codes = np.asarray(pool.encode_many(values), dtype=np.int32)
        data_np[:n] = np.where(codes >= 0, codes, 0)
        valid_np[:n] = codes >= 0
    elif (isinstance(values, np.ndarray) and values.dtype.kind == "M"
          and kind in ("date", "datetime")):
        # numpy datetime64: days or microseconds since the epoch in
        # bulk, NaT a null
        unit = "datetime64[D]" if kind == "date" else "datetime64[us]"
        data_np[:n] = values.astype(unit).view(np.int64)
        valid_np[:n] = ~np.isnat(values)
        data_np[:n][~valid_np[:n]] = 0
    elif (isinstance(values, np.ndarray) and values.dtype.kind in "biuf"
          and kind in ("id", "int", "float", "bool")):
        # numpy fast path: every row valid, one bulk conversion
        if kind == "id" and n:
            _check_id(int(values.max()))
            _check_id(int(values.min()))
        data_np[:n] = values
        valid_np[:n] = True
    elif (fast := _ingest_native(values, kind, n)) is not None:
        data_np[:n], valid_np[:n] = fast
    else:
        for i, v in enumerate(values):
            if v is None:
                continue
            valid_np[i] = True
            if kind == "bool":
                data_np[i] = bool(v)
            elif kind == "id":
                data_np[i] = _check_id(int(v))
            elif kind == "float":
                data_np[i] = float(v)
            elif kind in ("date", "datetime"):
                data_np[i] = _host_temporal(v, kind)
            else:
                data_np[i] = int(v)
    return Column(kind, _to(data_np, device), _to(valid_np, device), ctype,
                  host=(data_np, valid_np))


def _make_list(values, ctype, capacity: int, pool, device,
               default: str = "id") -> Column:
    """Host lists (or None) → a list column; ``default`` is the element
    kind of a list type that names none (only nulls and empty lists)."""
    ek = list_elem_kind(ctype) or default
    if ek == "list":
        return _make_nested(values, ctype, capacity, pool, device)
    if ek == "map":
        return _make_map_list(values, ctype, capacity, pool, device)
    max_len = max((len(v) for v in values if v is not None), default=0)
    width = max(1, max_len)
    valid_np = np.zeros(capacity, dtype=bool)
    data_np = np.zeros((capacity, width) + ((3,) if ek == "duration"
                                            else ()), dtype=_NP_DTYPES[ek])
    tags_np = np.zeros((capacity, width), dtype=np.int8) \
        if ek == "any" else None
    if ek == "any" and any(_is_duration(x) for v in values if v
                           for x in v):
        data_np = np.zeros((capacity, width, 3), dtype=np.int64)
    ev_np = np.ones((capacity, width), dtype=bool)
    lens_np = np.zeros(capacity, dtype=np.int32)
    if not _list_native(values, ek, data_np, valid_np, ev_np, lens_np):
        for i, v in enumerate(values):
            if v is None:
                continue
            valid_np[i] = True
            lens_np[i] = len(v)
            for j, x in enumerate(v):
                if x is None:
                    ev_np[i, j] = False
                elif ek == "any":
                    tags_np[i, j], code = encode_any(x, pool)
                    put_payload(data_np, (i, j), code)
                else:
                    data_np[i, j] = encode_list_elem(x, ek, pool)
    return Column("list", _to(data_np, device), _to(valid_np, device),
                  ctype, _to(lens_np, device),
                  elem_valid=None if ev_np.all() else _to(ev_np, device),
                  tags=None if tags_np is None else _to(tags_np, device))


def _slots(values):
    """Host lists (or None) laid out in bulk: (each row's presence and
    length, each element's row and position, the elements in row then
    position order)."""
    n = len(values)
    present = np.fromiter((v is not None for v in values), bool, n)
    lens = np.fromiter((0 if v is None else len(v) for v in values),
                       np.int64, n)
    row = np.repeat(np.arange(n), lens)
    pos = np.arange(row.shape[0]) - np.repeat(np.cumsum(lens) - lens, lens)
    flat = list(itertools.chain.from_iterable(
        v for v in values if v is not None))
    return present, lens, row, pos, flat


def _list_native(values, ek: str, data_np, valid_np, ev_np,
                 lens_np) -> bool:
    """Fill lists of ints, floats or booleans in bulk: the elements
    flattened in row order, converted by the native runtime
    (:func:`_ingest_native`) and placed by each row's offsets.  False
    where the per-element loop must run (another kind, no runtime, a
    value its converters reject)."""
    if ek not in ("int", "float", "bool") or not len(values):
        return False
    present, lens, row, pos, flat = _slots(values)
    fast = _ingest_native(flat, ek, len(flat)) if flat else \
        (np.zeros(0, data_np.dtype), np.zeros(0, bool))
    if fast is None:
        return False
    data_np[row, pos], ev_np[row, pos] = fast
    valid_np[:len(values)] = present
    lens_np[:len(values)] = lens
    return True


def _make_nested(values, ctype, capacity: int, pool, device) -> Column:
    """Host lists of lists → a list of lists: the inner lists, in row
    then element order, become the rows of a child column (of the inner
    list type, nested again for a deeper list); each element holds its
    inner list's row there (a null inner list a null element)."""
    present, lens, row, pos, flat = _slots(values)
    child = _make_list(flat, ctype.material.inner, max(1, len(flat)), pool,
                       device, default="int")
    child.host = None
    width = max(1, int(lens.max(initial=0)))
    data_np = np.zeros((capacity, width), dtype=np.int64)
    ev_np = np.ones((capacity, width), dtype=bool)
    valid_np = np.zeros(capacity, dtype=bool)
    lens_np = np.zeros(capacity, dtype=np.int32)
    data_np[row, pos] = np.arange(len(flat))
    ev_np[row, pos] = np.fromiter((x is not None for x in flat), bool,
                                  len(flat))
    valid_np[:len(values)] = present
    lens_np[:len(values)] = lens
    return Column("list", _to(data_np, device), _to(valid_np, device),
                  ctype, _to(lens_np, device),
                  elem_valid=None if ev_np.all() else _to(ev_np, device),
                  child=child)


def _make_map_list(values, ctype, capacity: int, pool, device) -> Column:
    """Host lists of maps → a list of maps: the presence of each key of
    any map per element, and per key the list of its values (a list
    column of the key's joined type)."""
    from caps_tpu_torch.okapi.types import CTList, from_python, join_all
    keys = sorted({k for v in values if v is not None for x in v
                   if x is not None for k in x})
    width = max([1] + [len(v) for v in values if v is not None])
    present = np.zeros((capacity, width, len(keys)), dtype=bool)
    ev_np = np.ones((capacity, width), dtype=bool)
    valid_np = np.zeros(capacity, dtype=bool)
    lens_np = np.zeros(capacity, dtype=np.int32)
    for i, v in enumerate(values):
        if v is None:
            continue
        valid_np[i] = True
        lens_np[i] = len(v)
        for j, x in enumerate(v):
            if x is None:
                ev_np[i, j] = False
            else:
                present[i, j] = [k in x for k in keys]
    fields = {}
    for k in keys:
        vals = [None if v is None else
                [None if x is None else x.get(k) for x in v] for v in values]
        child_t = join_all(from_python(x) for v in vals if v is not None
                           for x in v)
        if child_t.material == from_python(None).material:
            child_t = CTInteger
        # (each row's list of one key's values is as long as its list
        # of maps, so the key's list is as wide)
        fields[k] = _make_list(vals, CTList(child_t), capacity, pool,
                               device)
    return Column("list", _to(present, device), _to(valid_np, device),
                  ctype, _to(lens_np, device),
                  elem_valid=None if ev_np.all() else _to(ev_np, device),
                  fields=fields)


def put_payload(data: np.ndarray, at, code) -> None:
    """Store one "any" payload: a 3-wide payload array holds a plain
    value's payload first and zeros after."""
    if isinstance(code, tuple) or data[at].ndim == 0:
        data[at] = code
    else:
        data[at] = (code, 0, 0)


def _is_duration(x: Any) -> bool:
    from caps_tpu_torch.okapi.values import CypherDuration
    return isinstance(x, CypherDuration)


def _make_map(values, capacity: int, pool, device) -> Column:
    """Host maps (dicts, or None) → a map column over the union of their
    keys; each key's child column of its values' joined type."""
    from caps_tpu_torch.okapi.types import from_python, join_all
    keys = sorted({k for v in values if v is not None for k in v})
    valid_np = np.zeros(capacity, dtype=bool)
    present = np.zeros((capacity, len(keys)), dtype=bool)
    fields = {}
    for j, k in enumerate(keys):
        vals = [None if v is None else v.get(k) for v in values]
        present[:len(values), j] = [v is not None and k in v for v in values]
        child_t = join_all(from_python(x) for x in vals)
        if child_t.material == from_python(None).material:
            child_t = CTInteger
        fields[k] = make_column(vals, child_t, capacity, pool, device)
    valid_np[:len(values)] = [v is not None for v in values]
    return Column("map", _to(present, device), _to(valid_np, device), CTMap,
                  fields=fields)


def _ingest_native(values, kind: str, n: int):
    """Bulk ingest of a Python sequence by the C++ host runtime
    (native/csrc/host_runtime.cpp): (data, valid) numpy arrays of
    length ``n``, or None for the Python loop — when the caller opted
    out of the native runtime, for kinds it does not convert, and for
    values its strict converters reject (numeric strings, say), so the
    result never depends on which path ran."""
    if kind not in ("int", "id", "float", "bool") or n == 0:
        return None
    from caps_tpu_torch import native
    lib = native.runtime()
    if lib is None:
        return None
    try:
        if kind in ("int", "id"):
            raw_d, raw_v = lib.ingest_i64(values)
            d = np.frombuffer(raw_d, np.int64)
        elif kind == "float":
            raw_d, raw_v = lib.ingest_f64(values)
            d = np.frombuffer(raw_d, np.float64)
        else:
            raw_d, raw_v = lib.ingest_bool(values)
            d = np.frombuffer(raw_d, np.uint8).astype(bool)
    except (TypeError, ValueError, OverflowError):
        return None
    valid = np.frombuffer(raw_v, np.uint8).astype(bool)
    if kind == "id":
        bad = np.flatnonzero(valid & ((d <= -2**31) | (d >= 2**31)))
        if bad.size:
            _check_id(int(d[bad[0]]))  # the first, as the loop raises
    return d, valid


def _to(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(arr).to(device)


def _check_id(iv: int) -> int:
    if not (-2**31 < iv < 2**31):
        raise ValueError(f"entity id {iv} exceeds int32 (ingest "
                         "should densify ids)")
    return iv


def encode_list_elem(x: Any, elem_kind: str, pool):
    """One non-null list element as a value of the list matrix's dtype
    (an "any" element's payload: its tag goes to ``tags``)."""
    if elem_kind == "str":
        return pool.encode(x)
    if elem_kind == "bool":
        return bool(x)
    if elem_kind == "float":
        return float(x)
    if elem_kind in ("date", "datetime"):
        return _host_temporal(x, elem_kind)
    if elem_kind == "duration":
        return (x.months, x.days, x.seconds)
    if elem_kind == "any":
        return encode_any(x, pool)[1]
    iv = int(x if not hasattr(x, "id") else x.id)
    return _check_id(iv) if elem_kind == "id" else iv


def column_to_host(col: Column, n: int, pool) -> List[Any]:
    """Device column → host Python values (None for null): one copy of
    each tensor, converted by ``tolist``."""
    valid = col.valid[:n].cpu().tolist()
    if col.kind in ("any", "map", "duration") or (
            col.kind == "list" and (col.nested or col.elem_kind in (
                "any", "map", "duration"))):
        vals = _decoded(col, n, pool)
        return [v if ok else None for v, ok in zip(vals, valid)]
    conv = _converter(col.elem_kind if col.kind == "list" else col.kind,
                      pool)
    vals = col.data[:n].cpu().tolist()
    if col.kind != "list":
        if conv is None:
            return [v if ok else None for v, ok in zip(vals, valid)]
        return [conv(v) if ok else None for v, ok in zip(vals, valid)]
    lens = col.lens[:n].cpu().tolist()
    ev = None if col.elem_valid is None else col.elem_valid[:n].cpu().tolist()
    out: List[Any] = []
    for i in range(n):
        if not valid[i]:
            out.append(None)
            continue
        row = vals[i][:lens[i]]
        if ev is not None:
            # (a null element's code is no string: decode only the others)
            out.append([(x if conv is None else conv(x)) if ok else None
                        for x, ok in zip(row, ev[i])])
        else:
            out.append(row if conv is None else [conv(x) for x in row])
    return out


def _decoded(col: Column, n: int, pool) -> List[Any]:
    """The first ``n`` rows of an "any", map, duration column (or a list
    of "any" values, of maps or of lists) as host values, validity not
    applied."""
    from caps_tpu_torch.okapi.values import CypherDuration, CypherMap
    if col.kind == "duration":
        return [CypherDuration(*r) for r in col.data[:n].cpu().tolist()]
    if col.kind == "any":
        return decode_any(col.tags[:n].cpu().numpy(),
                          col.data[:n].cpu().numpy(), pool)
    if col.kind == "map":
        keys = list(col.fields)
        present = col.data[:n].cpu().tolist()
        kids = [column_to_host(col.fields[k], n, pool) for k in keys]
        return [CypherMap({k: kid[i] for k, kid, p in zip(keys, kids, ok)
                           if p}) for i, ok in enumerate(present)]
    # a list of "any" values, of maps or of lists: the elements of the
    # valid rows as a column (one level down, for a list of lists), cut
    # into rows by the lengths
    lens = np.where(col.valid[:n].cpu().numpy(),
                    col.lens[:n].cpu().numpy(), 0).astype(np.int64)
    total = int(lens.sum())
    ends = np.cumsum(lens)
    row = np.repeat(np.arange(n), lens)
    j = np.arange(total) - np.repeat(ends - lens, lens)
    dev = col.data.device
    at = (torch.from_numpy(row).to(dev), torch.from_numpy(j).to(dev))
    elems = column_to_host(elem_at(col, *at, torch.ones(
        total, dtype=torch.bool, device=dev)), total, pool)
    return [elems[e - k:e] for e, k in zip(ends.tolist(), lens.tolist())]


def decode_any(tags: np.ndarray, payload: np.ndarray, pool) -> List[Any]:
    """Host values of "any" payloads by their tags (a payload of three
    columns where durations are among them)."""
    from caps_tpu_torch.okapi.values import (
        CypherDate, CypherDateTime, CypherDuration,
    )
    wide = payload.tolist() if payload.ndim == 2 else None
    if wide is not None:
        payload = np.ascontiguousarray(payload[:, 0])
    floats = payload.view(np.float64).tolist()
    ints = payload.tolist()
    out: List[Any] = []
    for n, (t, i, f) in enumerate(zip(tags.tolist(), ints, floats)):
        k = ANY_TAGS[t]
        if k == "duration":
            out.append(CypherDuration(*wide[n]))
        elif k == "int":
            out.append(i)
        elif k == "float":
            out.append(f)
        elif k == "str":
            out.append(pool.decode(i))
        elif k == "bool":
            out.append(bool(i))
        elif k == "date":
            out.append(CypherDate(i))
        else:
            out.append(CypherDateTime(i))
    return out


def _converter(kind: str, pool):
    """The host value of one ``tolist`` element of a kind (None: the
    element is its value)."""
    if kind == "str":
        memo: dict = {}

        def decode(code):
            s = memo.get(code)
            if s is None:
                s = memo[code] = pool.decode(code)
            return s
        return decode
    if kind == "date":
        from caps_tpu_torch.okapi.values import CypherDate
        return CypherDate
    if kind == "datetime":
        from caps_tpu_torch.okapi.values import CypherDateTime
        return CypherDateTime
    return None


def literal_column(value: Any, ctype: CypherType, capacity: int,
                   pool, device) -> Column:
    kind = kind_for(ctype)
    if kind == "object":
        raise ValueError(f"type {ctype!r} has no device representation")
    if value is None:
        if kind == "list":
            ek = list_elem_kind(ctype)
            if ek == "list":
                # a null list of lists: one null inner list to point at
                child = literal_column(None, ctype.material.inner, 1, pool,
                                       device)
                return Column(kind, torch.zeros((capacity, 1),
                                                dtype=torch.int64,
                                                device=device),
                              torch.zeros(capacity, dtype=torch.bool,
                                          device=device), ctype,
                              torch.zeros(capacity, dtype=torch.int32,
                                          device=device), child=child)
            # (a list of durations holds three fields an element, a list
            # of maps the presence of no key)
            tail = {"duration": (3,), "map": (0,)}.get(ek, ())
            return Column(kind,
                          torch.zeros((capacity, 1) + tail,
                                      dtype=list_dtype(ek), device=device),
                          torch.zeros(capacity, dtype=torch.bool,
                                      device=device), ctype,
                          torch.zeros(capacity, dtype=torch.int32,
                                      device=device),
                          tags=(torch.zeros((capacity, 1), dtype=torch.int8,
                                            device=device)
                                if ek == "any" else None),
                          fields={} if ek == "map" else None)
        shape = {"duration": (capacity, 3), "map": (capacity, 0)}.get(
            kind, (capacity,))
        return Column(kind, torch.zeros(shape, dtype=_DTYPES[kind],
                                        device=device),
                      torch.zeros(capacity, dtype=torch.bool, device=device),
                      ctype,
                      tags=(torch.zeros(capacity, dtype=torch.int8,
                                        device=device)
                            if kind == "any" else None),
                      fields={} if kind == "map" else None)
    if kind in ("list", "map", "any", "duration"):
        col = make_column([value], ctype, 1, pool, device)
        idx = torch.zeros(capacity, dtype=torch.int64, device=device)
        return col.take(idx)
    if kind == "str":
        value = pool.encode(value)
    elif kind in ("date", "datetime"):
        value = _host_temporal(value, kind)
    data = torch.full((capacity,), value, dtype=_DTYPES[kind], device=device)
    return Column(kind, data, torch.ones(capacity, dtype=torch.bool,
                                         device=device), ctype)
