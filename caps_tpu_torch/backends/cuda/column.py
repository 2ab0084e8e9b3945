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
    list   2D (capacity, max_len) + lens (+ elem_valid): the element
           kind's dtype — int32 for ids and string codes, int64 for
           ints, float64 for floats, bool for booleans; a list of lists
           is 3D (capacity, max_len, inner max_len) + inner_lens
    object —       host-only values; no device path
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from caps_tpu_torch.okapi.types import (
    CTBoolean, CTDate, CTDateTime, CTFloat, CTInteger, CTNumber, CTString,
    CypherType, _CTList, _CTNode, _CTRelationship,
)

_DTYPES = {
    "id": torch.int32,
    "int": torch.int64,
    "float": torch.float64,
    "bool": torch.bool,
    "str": torch.int32,
    "date": torch.int64,
    "datetime": torch.int64,
}
_NP_DTYPES = {
    "id": np.int32, "int": np.int64, "float": np.float64, "bool": np.bool_,
    "str": np.int32, "date": np.int64, "datetime": np.int64,
}


def list_elem_kind(ctype: CypherType) -> Optional[str]:
    """Element kind of a device-representable list type: rel/node ids,
    int, float, str codes, bool (the list matrix takes the kind's
    dtype).  None = no device representation (CTNumber, CTAny, maps,
    temporal values, nested lists)."""
    m = ctype.material
    if not isinstance(m, _CTList):
        return None
    inner = m.inner.material if m.inner is not None else None
    if isinstance(inner, (_CTRelationship, _CTNode)):
        return "id"
    if inner == CTInteger:
        return "int"
    if inner == CTFloat:
        return "float"
    if inner == CTString:
        return "str"
    if inner == CTBoolean:
        return "bool"
    return None


def kind_for(ctype: CypherType) -> str:
    m = ctype.material
    if isinstance(m, (_CTNode, _CTRelationship)):
        return "id"
    if isinstance(m, _CTList):
        if list_elem_kind(ctype) is not None:
            return "list"
        return "object"
    if m == CTInteger:
        return "int"
    if m in (CTFloat, CTNumber):
        return "float"
    if m == CTBoolean:
        return "bool"
    if m == CTString:
        return "str"
    if m == CTDate:
        return "date"
    if m == CTDateTime:
        return "datetime"
    return "object"


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
    # for a list of lists: int32 (capacity, max_len), each inner list's
    # length, and bool (capacity, max_len, inner max_len), False on a
    # null element of an inner list (None where there is none)
    inner_lens: Optional[torch.Tensor] = None
    inner_valid: Optional[torch.Tensor] = None

    @property
    def elem_kind(self) -> str:
        """A list column's (innermost) element kind: its type's, else
        its dtype's (a list of no element type, or ids mixed with
        ints)."""
        m = self.ctype.material
        if self.data.dim() == 3 and isinstance(m, _CTList) \
                and m.inner is not None:
            m = m.inner
        return list_elem_kind(m) or _BY_DTYPE[self.data.dtype]

    def take(self, idx: torch.Tensor) -> "Column":
        """The rows ``idx`` of this column (every per-row tensor)."""
        return Column(
            self.kind, self.data[idx], self.valid[idx], self.ctype,
            None if self.lens is None else self.lens[idx],
            elem_valid=(None if self.elem_valid is None
                        else self.elem_valid[idx]),
            inner_lens=(None if self.inner_lens is None
                        else self.inner_lens[idx]),
            inner_valid=(None if self.inner_valid is None
                         else self.inner_valid[idx]))

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
                      inner_lens=self.inner_lens,
                      inner_valid=self.inner_valid)


def list_dtype(elem_kind: str) -> torch.dtype:
    """The list matrix's dtype for an element kind."""
    return _DTYPES[elem_kind]


def make_column(values: Union[Sequence[Any], np.ndarray], ctype: CypherType,
                capacity: int, pool, device) -> Column:
    """Host values → device column (padded to capacity).  A numpy array
    of a numeric kind is copied in bulk (no per-row Python work); a list
    may hold None for nulls."""
    kind = kind_for(ctype)
    n = len(values)
    valid_np = np.zeros(capacity, dtype=bool)
    if kind == "object":
        raise ValueError(f"type {ctype!r} has no device representation")
    if kind == "list":
        ek = list_elem_kind(ctype) or "id"
        max_len = max((len(v) for v in values if v is not None), default=0)
        width = max(1, max_len)
        data_np = np.zeros((capacity, width), dtype=_NP_DTYPES[ek])
        ev_np = np.ones((capacity, width), dtype=bool)
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
                    data_np[i, j] = encode_list_elem(x, ek, pool)
        return Column(kind, _to(data_np, device), _to(valid_np, device),
                      ctype, _to(lens_np, device),
                      elem_valid=None if ev_np.all() else _to(ev_np, device))
    data_np = np.zeros(capacity, dtype=_NP_DTYPES[kind])
    if kind == "str":
        codes = np.asarray(pool.encode_many(values), dtype=np.int32)
        data_np[:n] = np.where(codes >= 0, codes, 0)
        valid_np[:n] = codes >= 0
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
            elif kind == "date":
                from caps_tpu_torch.okapi.values import CypherDate
                data_np[i] = v.days if isinstance(v, CypherDate) else int(v)
            elif kind == "datetime":
                from caps_tpu_torch.okapi.values import CypherDateTime
                data_np[i] = v.micros if isinstance(v, CypherDateTime) \
                    else int(v)
            else:
                data_np[i] = int(v)
    return Column(kind, _to(data_np, device), _to(valid_np, device), ctype,
                  host=(data_np, valid_np))


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
    """One non-null list element as a value of the list matrix's dtype."""
    if elem_kind == "str":
        return pool.encode(x)
    if elem_kind == "bool":
        return bool(x)
    if elem_kind == "float":
        return float(x)
    iv = int(x if not hasattr(x, "id") else x.id)
    return _check_id(iv) if elem_kind == "id" else iv


def column_to_host(col: Column, n: int, pool) -> List[Any]:
    """Device column → host Python values (None for null): one copy of
    each tensor, converted by ``tolist``."""
    valid = col.valid[:n].cpu().tolist()
    conv = _converter(col.elem_kind if col.kind == "list" else col.kind,
                      pool)
    vals = col.data[:n].cpu().tolist()
    if col.kind != "list":
        if conv is None:
            return [v if ok else None for v, ok in zip(vals, valid)]
        return [conv(v) if ok else None for v, ok in zip(vals, valid)]
    lens = col.lens[:n].cpu().tolist()
    ev = None if col.elem_valid is None else col.elem_valid[:n].cpu().tolist()
    nested = col.data.dim() == 3
    if nested:
        inner = col.inner_lens[:n].cpu().tolist()
        iv = (None if col.inner_valid is None
              else col.inner_valid[:n].cpu().tolist())

    def items(row, k, oks):
        # (a null element's code is no string: decode only the others)
        row = row[:k]
        if oks is not None:
            return [(x if conv is None else conv(x)) if ok else None
                    for x, ok in zip(row, oks)]
        return row if conv is None else [conv(x) for x in row]

    out: List[Any] = []
    for i in range(n):
        if not valid[i]:
            out.append(None)
            continue
        if nested:
            oks = ev[i] if ev is not None else [True] * lens[i]
            out.append([items(r, inner[i][j], None if iv is None
                              else iv[i][j]) if ok else None
                        for j, (r, ok) in enumerate(
                            zip(vals[i][:lens[i]], oks))])
        else:
            out.append(items(vals[i], lens[i],
                             None if ev is None else ev[i]))
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
            return Column(kind,
                          torch.zeros((capacity, 1), dtype=list_dtype(
                              list_elem_kind(ctype)), device=device),
                          torch.zeros(capacity, dtype=torch.bool,
                                      device=device), ctype,
                          torch.zeros(capacity, dtype=torch.int32,
                                      device=device))
        return Column(kind, torch.zeros(capacity, dtype=_DTYPES[kind],
                                        device=device),
                      torch.zeros(capacity, dtype=torch.bool, device=device),
                      ctype)
    if kind == "str":
        value = pool.encode(value)
    if kind == "list":
        raise ValueError("literal list columns are not supported")
    data = torch.full((capacity,), value, dtype=_DTYPES[kind], device=device)
    return Column(kind, data, torch.ones(capacity, dtype=torch.bool,
                                         device=device), ctype)
