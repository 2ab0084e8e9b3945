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
    list   int32 2D (capacity, max_len) + lens
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
    "list": torch.int32,
    "date": torch.int64,
    "datetime": torch.int64,
}
_NP_DTYPES = {
    "id": np.int32, "int": np.int64, "float": np.float64, "bool": np.bool_,
    "str": np.int32, "date": np.int64, "datetime": np.int64,
}


def list_elem_kind(ctype: CypherType) -> Optional[str]:
    """Element kind of a device-representable list type (values are packed
    into the int32 list matrix): rel/node ids, int (int32-range), str
    codes, bool.  None = no device representation."""
    m = ctype.material
    if not isinstance(m, _CTList):
        return None
    inner = m.inner.material if m.inner is not None else None
    if isinstance(inner, (_CTRelationship, _CTNode)):
        return "id"
    if inner == CTInteger:
        return "int"
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
                      self.ctype, self.lens)


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
        data_np = np.zeros((capacity, max(1, max_len)), dtype=np.int32)
        lens_np = np.zeros(capacity, dtype=np.int32)
        for i, v in enumerate(values):
            if v is None:
                continue
            valid_np[i] = True
            lens_np[i] = len(v)
            for j, x in enumerate(v):
                data_np[i, j] = encode_list_elem(x, ek, pool)
        return Column(kind, _to(data_np, device), _to(valid_np, device),
                      ctype, _to(lens_np, device))
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


def encode_list_elem(x: Any, elem_kind: str, pool) -> int:
    """Pack one list element into the int32 list matrix."""
    if x is None:
        raise ValueError("null list elements have no device representation")
    if elem_kind == "str":
        return pool.encode(x)
    if elem_kind == "bool":
        return int(bool(x))
    iv = int(x if not hasattr(x, "id") else x.id)
    return _check_id(iv)


def decode_list_elem(code: int, elem_kind: str, pool) -> Any:
    if elem_kind == "str":
        return pool.decode(int(code))
    if elem_kind == "bool":
        return bool(code)
    return int(code)


def column_to_host(col: Column, n: int, pool) -> List[Any]:
    """Device column → host Python values (None for null)."""
    valid = col.valid[:n].cpu().numpy()
    if col.kind == "list":
        ek = list_elem_kind(col.ctype) or "id"
        data = col.data[:n].cpu().numpy()
        lens = col.lens[:n].cpu().numpy()
        return [[decode_list_elem(x, ek, pool) for x in data[i, :lens[i]]]
                if valid[i] else None
                for i in range(n)]
    data = col.data[:n].cpu().numpy()
    out: List[Any] = []
    for i in range(n):
        if not valid[i]:
            out.append(None)
        elif col.kind == "str":
            out.append(pool.decode(int(data[i])))
        elif col.kind == "bool":
            out.append(bool(data[i]))
        elif col.kind == "float":
            out.append(float(data[i]))
        elif col.kind == "date":
            from caps_tpu_torch.okapi.values import CypherDate
            out.append(CypherDate(int(data[i])))
        elif col.kind == "datetime":
            from caps_tpu_torch.okapi.values import CypherDateTime
            out.append(CypherDateTime(int(data[i])))
        else:
            out.append(int(data[i]))
    return out


def literal_column(value: Any, ctype: CypherType, capacity: int,
                   pool, device) -> Column:
    kind = kind_for(ctype)
    if kind == "object":
        raise ValueError(f"type {ctype!r} has no device representation")
    if value is None:
        if kind == "list":
            return Column(kind,
                          torch.zeros((capacity, 1), dtype=torch.int32,
                                      device=device),
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
