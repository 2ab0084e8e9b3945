"""Plain tensor operators of the device backend.

The counterparts of ``caps_tpu/backends/tpu/kernels.py``: the operators
the JAX package computes with jnp/lax outside any Pallas kernel stay
plain PyTorch ops here.  The hand-written kernels live in
``caps_tpu_torch/ops``.

Two-phase pattern: operators whose output size is data-dependent
(filter, join, group) first compute a count on the device, read that one
scalar on the host to pick the output bucket, then materialize into a
buffer of that static capacity.

Ids and join keys stay int64: the join sentinels below live in the gap
under every monotone-bitcast float64 key (``table._join_key``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_L_NULL = -(2 ** 63) + 1
_R_NULL = -(2 ** 63) + 2
_L_NAN = -(2 ** 63) + 3
_R_NAN = -(2 ** 63) + 4


def row_mask(capacity: int, n: int, device,
             live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows below ``n``; under generic replay (``live``, a device scalar
    of the exact live count) also below ``live`` — no host read."""
    idx = torch.arange(capacity, device=device)
    m = idx < n
    if live is not None:
        m = m & (idx < live)
    return m


def sqrt_f64(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 square root, as IEEE 754 requires and
    ``jnp.sqrt`` gives.  CUDA's double ``sqrt`` is correctly rounded, so
    on the card this is ``torch.sqrt``.  PyTorch's CPU kernel for
    float64 is not (it is one ulp off on some inputs, 527 of
    sqrt(0 … 99,999)), so a tensor on the CPU goes through numpy's."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.contiguous().numpy()))
    return torch.sqrt(x)


# -- compaction (filter) ----------------------------------------------------

def mask_count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum()


def compact_indices(mask: torch.Tensor, out_cap: int) -> torch.Tensor:
    """Indices of kept rows, in order, padded with 0 to ``out_cap`` —
    computed without a host sync (running count + scatter)."""
    pos = torch.cumsum(mask, 0) - 1
    dest = torch.where(mask & (pos < out_cap), pos,
                       torch.full_like(pos, out_cap))
    idx = torch.zeros(out_cap + 1, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, dest, torch.arange(mask.shape[0], device=mask.device))
    return idx[:out_cap]


# -- sort-merge join --------------------------------------------------------

def probe_count(l_key: torch.Tensor, l_ok: torch.Tensor,
                rk_sorted: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1: per-left-row match counts against the sorted right keys."""
    lk = torch.where(l_ok, l_key, torch.full_like(l_key, _L_NULL))
    lo = torch.searchsorted(rk_sorted, lk)
    hi = torch.searchsorted(rk_sorted, lk, right=True)
    counts = torch.where(l_ok, hi - lo, torch.zeros_like(lo))
    return counts, lo


def join_total(counts: torch.Tensor, l_ok: torch.Tensor,
               left_join: bool = False) -> torch.Tensor:
    if left_join:
        counts = torch.where(l_ok & (counts == 0),
                             torch.ones_like(counts), counts)
    return counts.sum()


# -- multi-key lexicographic sort ------------------------------------------

def sort_perm(keys: Sequence[torch.Tensor], capacity: int) -> torch.Tensor:
    """Stable lexicographic sort permutation by pre-transformed
    int64/float64 keys (nulls/padding already folded into the key
    values): stable sorts chained from the last key to the first.  Floats
    order as ``lax.sort`` orders them: -0.0 == +0.0, NaN last."""
    perm = torch.arange(capacity, device=keys[0].device)
    for k in reversed(list(keys)):
        order = torch.sort(k[perm], stable=True).indices
        perm = perm[order]
    return perm


def distinct_count(data: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Distinct values among the rows ``ok`` (a device scalar), counted
    as a Python ``set`` of the host values counts them: for floats
    -0.0 and 0.0 once and every NaN row on its own.  Kept rows sort
    first, in value order; a kept row counts when its value differs from
    the row before it."""
    nan = torch.zeros_like(ok)
    if data.is_floating_point():
        nan = ok & torch.isnan(data)
        data = torch.where(data == 0, torch.zeros_like(data), data)
    else:
        data = data.to(torch.int64)
    keep = ok & ~nan
    vals = torch.where(keep, data, torch.zeros_like(data))
    perm = sort_perm([(~keep).to(torch.int64), vals], vals.shape[0])
    s, k = vals[perm], keep[perm]
    new = k.clone()
    new[1:] &= s[1:] != s[:-1]
    return new.sum() + nan.sum()


def neighbor_change_keys(sorted_keys: Sequence[torch.Tensor]
                         ) -> torch.Tensor:
    """True where a row starts a new group (row 0 included), comparing
    each sorted key array in its own dtype."""
    first = sorted_keys[0]
    cap = first.shape[0]
    diff = torch.zeros(max(cap - 1, 0), dtype=torch.bool, device=first.device)
    for k in sorted_keys:
        diff = diff | (k[1:] != k[:-1])
    return torch.cat([torch.ones(1, dtype=torch.bool, device=first.device),
                      diff])


# -- segmented aggregation --------------------------------------------------

def sorted_segment_agg(values: torch.Tensor, ok: torch.Tensor,
                       seg_id: torch.Tensor, num_segments: int,
                       kind: str) -> torch.Tensor:
    """Sum/count over *non-decreasing* ``seg_id`` via cumulative sum +
    boundary gather.  Exact for integers (int64 running sum)."""
    if kind == "count":
        v = ok.to(torch.int64)
    elif kind == "sum":
        v = torch.where(ok, values, torch.zeros_like(values))
    else:
        raise ValueError(f"sorted_segment_agg supports count/sum, not {kind}")
    c = torch.cumsum(v, 0)
    segs = torch.arange(num_segments, device=seg_id.device,
                        dtype=seg_id.dtype)
    ends = torch.searchsorted(seg_id, segs, right=True) - 1
    cum = torch.where(ends >= 0, c[ends.clamp(min=0)], torch.zeros_like(c[:1]))
    prev = torch.cat([torch.zeros(1, dtype=cum.dtype, device=cum.device),
                      cum[:-1]])
    return cum - prev


def segment_agg(values: torch.Tensor, ok: torch.Tensor, seg_id: torch.Tensor,
                num_segments: int, kind: str):
    """One aggregation over segments.  ``ok`` masks nulls+padding."""
    seg = seg_id.to(torch.int64)
    dev = values.device
    if kind == "count":
        out = torch.zeros(num_segments, dtype=torch.int64, device=dev)
        return out.index_add_(0, seg, ok.to(torch.int64))
    if kind == "sum":
        v = torch.where(ok, values, torch.zeros_like(values))
        out = torch.zeros(num_segments, dtype=v.dtype, device=dev)
        return out.index_add_(0, seg, v)
    if kind in ("min", "max"):
        if values.dtype == torch.bool:
            values = values.to(torch.int64)
        if values.dtype.is_floating_point:
            ident = float("inf") if kind == "min" else float("-inf")
        else:
            info = torch.iinfo(values.dtype)
            ident = info.max if kind == "min" else info.min
        v = torch.where(ok, values, torch.full_like(values, ident))
        out = torch.full((num_segments,), ident, dtype=values.dtype,
                         device=dev)
        return out.scatter_reduce_(0, seg, v, reduce="a" + kind,
                                   include_self=True)
    if kind == "first":
        cap = values.shape[0]
        pos = torch.where(ok, torch.arange(cap, device=dev),
                          torch.full((cap,), cap, device=dev))
        first_pos = torch.full((num_segments,), cap, dtype=torch.int64,
                               device=dev)
        first_pos.scatter_reduce_(0, seg, pos, reduce="amin",
                                  include_self=True)
        safe = first_pos.clamp(0, max(cap - 1, 0))
        return values[safe], first_pos < cap
    raise ValueError(f"unknown segment aggregation {kind}")


# -- explode ----------------------------------------------------------------

def explode_expand(lens: torch.Tensor, ok: torch.Tensor, out_cap: int):
    """Invert ``cumsum(lens)``: for each of ``out_cap`` output slots its
    source row, its position within that row's run, whether the slot is
    live, and the total (a device scalar).  The function K2 computes
    with ``lo = 0``; kept plain, as the JAX package keeps it outside
    any Pallas kernel."""
    dev = lens.device
    t = torch.arange(out_cap, device=dev)
    if lens.shape[0] == 0:
        zero = torch.zeros_like(t)
        return zero, zero, t < 0, torch.zeros((), dtype=torch.int64,
                                              device=dev)
    counts = torch.where(ok, lens, torch.zeros_like(lens))
    offsets = torch.cumsum(counts, 0)
    total = offsets[-1]
    row = torch.searchsorted(offsets, t, right=True).clamp(
        0, counts.shape[0] - 1)
    seg_start = torch.where(row > 0, offsets[(row - 1).clamp(min=0)],
                            torch.zeros_like(row))
    return row, t - seg_start, t < total, total
