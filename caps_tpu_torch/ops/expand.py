"""Segmented-expand positions + device-resident CSR adjacency.

The counterpart of ``caps_tpu/ops/expand.py``.  The materialization step
of every join / Expand hop: given per-left-row match counts, produce for
every output slot ``t`` the left row it came from and the position of its
match — the inversion of ``offsets = cumsum(counts)``.
``csrc/expand_positions.cu`` computes it on the card with a
load-balanced merge path over the slots and the row ends (design notes
there; launch geometry :func:`expand_geometry`);
:func:`expand_positions_plain` is the same function in plain PyTorch
(searchsorted formulation).

``DeviceCSR`` makes the probe side of Expand O(1) per row: a CSR over a
relationship table's source (or target) id column, built once at ingest
on the host with numpy and moved to the device, so a hop is two
``indptr`` gathers instead of a sort + binary search of the edge table.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from caps_tpu_torch import ops

# Launch geometry of csrc/expand_positions.cu (its THREADS and VT): a
# tile is NV merged items (slots and row ends), a scan tile NV rows.
THREADS = 256
VT = 8
NV = THREADS * VT

_lib = None


def _library():
    global _lib
    if _lib is None:
        from caps_tpu_torch.ops.build import library
        lib = library("expand_positions")
        lib.expand_positions.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.expand_positions.restype = ctypes.c_int
        # the built library, loaded once a process: no run reads or
        # writes it after that, so a replay finds it as recorded
        _lib = lib  # capslint: disable=tracer-purity
    return _lib


def expand_geometry(cap_l: int, out_cap: int) -> Tuple[int, int, int]:
    """(scan_tiles, expand_tiles, scratch_words) of one launch: the scan
    passes take ceil(cap_l / NV) blocks, the expand pass one block per NV
    items of the merged sequence of out_cap slots and cap_l row ends.
    Scratch: merged row ends and bases (cap_l each), the scan blocks'
    sums and the tiles' splits (expand_tiles + 1), int32."""
    scan_tiles = -(-cap_l // NV)
    expand_tiles = -(-(out_cap + cap_l) // NV)
    return (scan_tiles, expand_tiles,
            2 * cap_l + scan_tiles + expand_tiles + 1)


def expand_positions(counts: torch.Tensor, lo: torch.Tensor, out_cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each output slot t in [0, out_cap): the left row index it
    expands from, the match position ``lo[row] + within``, and validity.

    counts: (cap_l,) >= 0 int; lo: (cap_l,) int — per-row match start;
    the caller sizes ``out_cap >= counts.sum()``.  Returns (l_idx int32,
    r_pos int32, out_valid bool), each (out_cap,); invalid slots are 0.
    """
    if counts.device.type == "cpu":
        return expand_positions_plain(counts, lo, out_cap)
    return expand_positions_cuda(counts, lo, out_cap)


def expand_positions_cuda(counts: torch.Tensor, lo: torch.Tensor,
                          out_cap: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel wrapper: checks its inputs, launches
    ``csrc/expand_positions.cu`` on the current stream, or raises.
    ``lo`` holds positions into an int32-indexed table (``r_pos`` is
    int32, as in the JAX kernel).  The caller sizes ``out_cap >=
    counts.sum()``, as for the JAX kernel; the total is never read on
    the host."""
    for name, t in (("counts", counts), ("lo", lo)):
        if t.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"expand_positions_cuda: {name} must be int32 "
                             f"or int64, got {t.dtype}")
    cap_l = counts.shape[0]
    if counts.dim() != 1 or lo.shape != counts.shape \
            or lo.device != counts.device:
        raise ValueError("expand_positions_cuda: counts and lo must be "
                         "(cap_l,) tensors on one device")
    if out_cap < 0 or out_cap + cap_l + NV >= 2 ** 31:
        # merged positions (slots + row ends) are int32 in the kernel
        raise ValueError(f"expand_positions_cuda: out_cap {out_cap} + cap_l "
                         f"{cap_l} exceed int32")
    if counts.device.type != "cuda":
        raise ValueError(f"expand_positions_cuda: needs CUDA tensors, got "
                         f"{counts.device}")
    dev = counts.device
    l_idx = torch.empty(out_cap, dtype=torch.int32, device=dev)
    r_pos = torch.empty(out_cap, dtype=torch.int32, device=dev)
    valid = torch.empty(out_cap, dtype=torch.bool, device=dev)
    if out_cap == 0:
        return l_idx, r_pos, valid
    counts, lo = counts.contiguous(), lo.contiguous()
    scan_tiles, tiles, words = expand_geometry(cap_l, out_cap)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    status = _library().expand_positions(
        counts.data_ptr(), int(counts.dtype == torch.int64), lo.data_ptr(),
        int(lo.dtype == torch.int64), cap_l, out_cap, scan_tiles, tiles,
        scratch.data_ptr(), l_idx.data_ptr(), r_pos.data_ptr(),
        valid.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    ops.check_cuda(status, "expand_positions")
    ops.count_launch("expand_positions")
    return l_idx, r_pos, valid


def expand_positions_plain(counts: torch.Tensor, lo: torch.Tensor,
                           out_cap: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: a searchsorted per slot."""
    dev = counts.device
    cap_l = counts.shape[0]
    if cap_l == 0:
        z = torch.zeros(out_cap, dtype=torch.int32, device=dev)
        return z, z.clone(), torch.zeros(out_cap, dtype=torch.bool,
                                         device=dev)
    offsets = torch.cumsum(counts.to(torch.int64), 0)
    t = torch.arange(out_cap, device=dev)
    l_idx = torch.searchsorted(offsets, t, right=True).clamp_(0, cap_l - 1)
    seg_start = torch.where(l_idx > 0, offsets[(l_idx - 1).clamp(min=0)],
                            torch.zeros_like(l_idx))
    r_pos = lo.to(torch.int64)[l_idx] + (t - seg_start)
    valid = t < offsets[-1]
    zero = torch.zeros_like(l_idx)
    return (torch.where(valid, l_idx, zero).to(torch.int32),
            torch.where(valid, r_pos, zero).to(torch.int32), valid)


def join_expand_via_positions(counts, lo, perm, l_ok, out_cap: int,
                              left_join: bool):
    """Full join materialization on top of :func:`expand_positions`:
    returns (l_idx, r_idx, out_valid, r_matched) — left-join rows with no
    match emit one null-extended row."""
    matched = counts > 0
    eff = counts
    if left_join:
        eff = torch.where(l_ok & ~matched, torch.ones_like(counts), counts)
    l_idx, r_pos, out_valid = expand_positions(eff, lo, out_cap)
    r_pos = r_pos.clamp(0, perm.shape[0] - 1)
    r_idx = perm[r_pos]
    r_matched = out_valid & matched[l_idx]
    return l_idx, r_idx, out_valid, r_matched


# ---------------------------------------------------------------------------
# Device-resident CSR adjacency
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceCSR:
    """Device-resident CSR index over one int-key column: ``perm`` lists
    row indices grouped by key; rows for key k live at
    ``perm[indptr[k] : indptr[k+1]]``.  Domain is [0, n_keys)."""
    indptr: torch.Tensor   # (n_keys + 1,) int32
    perm: torch.Tensor     # (capacity,) int32
    n_keys: int

    def probe(self, keys: torch.Tensor, ok: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-probe-row (counts, lo): two indptr gathers, no search.
        The domain check runs in the key's own dtype (int64 keys must not
        be truncated before the range check)."""
        in_domain = ok & (keys >= 0) & (keys < self.n_keys)
        safe = torch.where(in_domain, keys, torch.zeros_like(keys))
        lo = self.indptr[safe]
        hi = self.indptr[safe + 1]
        counts = torch.where(in_domain, hi - lo, torch.zeros_like(lo))
        return counts, lo


# CSR domains above this multiple of the column capacity keep the sort
# path (indptr would dwarf the data it indexes).
_MAX_DOMAIN_FACTOR = 8
_MIN_DOMAIN = 1 << 16


def build_csr(keys: np.ndarray, ok: np.ndarray, capacity: int,
              device) -> Optional[DeviceCSR]:
    """CSR over the host arrays ``keys`` / ``ok`` (the live rows of a
    column, rows with ``ok`` False excluded), built on the host and moved
    to ``device``; ``perm`` is padded to ``capacity``.  Returns None when
    the key domain is unsuitable (negative / too sparse).

    The C++ host runtime's counting sort builds it
    (native/csrc/host_runtime.cpp ``csr_build``); with the native
    runtime opted out, numpy's stable argsort and a bincount do —
    the same ``indptr`` and ``perm``, bit for bit (a counting sort is
    stable)."""
    keys = np.asarray(keys).astype(np.int64, copy=False)
    live = np.asarray(ok).astype(bool, copy=False)
    if live.any() and int(keys[live].min()) < 0:
        return None  # negative keys are legal on the sort path only
    if not live.any():
        n_keys = 1
    else:
        mx = int(keys[live].max())
        if mx >= max(_MIN_DOMAIN, _MAX_DOMAIN_FACTOR * max(capacity, 1)):
            return None
        n_keys = mx + 1
    # masked rows go to a sentinel bucket past the real domain
    shunted = np.where(live, keys, n_keys)
    from caps_tpu_torch import native
    lib = native.runtime()
    if lib is not None:
        off_b, perm_b = lib.csr_build(np.ascontiguousarray(shunted),
                                      len(shunted), n_keys + 1)
        indptr = np.frombuffer(off_b, np.int64)
        perm = np.frombuffer(perm_b, np.int64)
    else:
        perm = np.argsort(shunted, kind="stable")
        indptr = np.zeros(n_keys + 2, np.int64)
        np.cumsum(np.bincount(shunted, minlength=n_keys + 1),
                  out=indptr[1:])
    perm_pad = np.zeros(capacity, np.int32)
    perm_pad[:len(perm)] = perm
    return DeviceCSR(
        torch.from_numpy(indptr[:n_keys + 1].astype(np.int32)).to(device),
        torch.from_numpy(perm_pad).to(device), n_keys)
