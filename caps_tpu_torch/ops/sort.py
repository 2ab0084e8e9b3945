"""Multi-plane bitonic sort permutation — the order_by / distinct /
group-by sort kernel.

The counterpart of ``caps_tpu/ops/sort.py``.  Multi-column keys arrive as
int32 PLANES (:func:`split_planes`): int64 keys split into (hi,
biased-lo) pairs — exact for the full 64-bit range — and float64 keys
bitcast through the monotone total-order mapping.  The comparator chains
the planes lexicographically with the original row index as the final
tiebreak, so the network is a strict total order and its permutation is
bit-identical to a stable sort.  Any algorithm that yields that
permutation computes the same function: ``csrc/bitonic_sort.cu`` runs a
merge sort by co-ranking on the card (design notes there; launch
geometry :func:`sort_geometry`); :func:`bitonic_sort_perm_plain` steps
the JAX package's bitonic network in plain PyTorch.

Capacities :func:`sort_cap_supported` rejects take the stable torch sort
in ``backends/cuda/kernels.sort_perm``.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from caps_tpu_torch import ops

LANES = 128
ROWS_MAX = 128          # cap <= 128 * 128 = 16384 elements
_I64_MIN = -(2 ** 63)

# Launch geometry of csrc/bitonic_sort.cu (its MAX_THREADS, PACKED and
# MAX_PTRS): a block sorts a chunk of rows, a row a thread; the chunk's
# planes, two buffers of packed rows (int4) and two per-plane words take
# at most SMEM_BUDGET bytes of the 232,448 a block may use.
SMEM_BUDGET = 204_800
MAX_THREADS = 1024
PACKED = 3
MAX_PTR_PLANES = 64     # above this the planes are stacked into one tensor
MIN_CHUNK = 32

_lib = None


def _library():
    global _lib
    if _lib is None:
        from caps_tpu_torch.ops.build import library
        lib = library("bitonic_sort")
        lib.bitonic_sort_perm.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.bitonic_sort_perm.restype = ctypes.c_int
        # the built library, loaded once a process: no run reads or
        # writes it after that, so a replay finds it as recorded
        _lib = lib  # capslint: disable=tracer-purity
    return _lib


def sort_cap_supported(cap: int) -> bool:
    """True for the capacities the kernel covers: R * 128 with R a power
    of two in [2, 128] (256 ... 16384) — the JAX kernel's set."""
    r = cap // LANES
    return (cap % LANES == 0 and 2 <= r <= ROWS_MAX
            and (r & (r - 1)) == 0)


def sort_smem_bytes(chunk: int, n_planes: int) -> int:
    """Dynamic shared memory of one chunk block: two buffers of packed
    rows, the staged planes, and the per-plane flag and offset words."""
    return 32 * chunk + 4 * (n_planes * chunk + n_planes
                             + max(n_planes, PACKED))


def sort_geometry(cap: int, n_planes: int) -> Tuple[int, int, int]:
    """(chunk, smem_bytes, merge_passes) of one sort: the chunk C is the
    largest power of two <= min(cap, MAX_THREADS) whose block fits
    SMEM_BUDGET; cap / C blocks of C threads sort a chunk each, then
    log2(cap / C) merge passes run over the whole card."""
    chunk = min(cap, MAX_THREADS)
    while chunk > MIN_CHUNK and sort_smem_bytes(chunk, n_planes) > SMEM_BUDGET:
        chunk //= 2
    if sort_smem_bytes(chunk, n_planes) > SMEM_BUDGET or cap % chunk:
        raise ValueError(f"sort_geometry: {n_planes} planes of capacity "
                         f"{cap} do not fit a block")
    passes = (cap // chunk).bit_length() - 1
    return chunk, sort_smem_bytes(chunk, n_planes), passes


def split_planes(keys: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Lexicographic key columns -> int32 comparison planes.  Ascending
    int32 order on the planes == ascending int64 / float64 total order
    on the originals (-NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN)."""
    out: List[torch.Tensor] = []
    for k in keys:
        if k.dtype == torch.float64:
            b = k.contiguous().view(torch.int64)
            k = torch.where(b >= 0, b, (~b) ^ _I64_MIN)
        if k.dtype == torch.int64:
            out.append((k >> 32).to(torch.int32))
            out.append(((k & 0xFFFFFFFF) - (1 << 31)).to(torch.int32))
        else:  # bool / int32 already compare correctly in int32
            out.append(k.to(torch.int32))
    return out


def bitonic_sort_perm(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable ascending-lexicographic sort permutation (int32, (cap,)) of
    int32 planes of length cap, ``sort_cap_supported(cap)``."""
    if planes[0].device.type == "cpu":
        return bitonic_sort_perm_plain(planes)
    return bitonic_sort_perm_cuda(planes)


def bitonic_sort_perm_cuda(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernel wrapper: checks its inputs, launches
    ``csrc/bitonic_sort.cu`` on the current stream, or raises."""
    cap = planes[0].shape[0]
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"bitonic_sort_perm_cuda: needs CUDA tensors, got "
                         f"{dev}")
    if not sort_cap_supported(cap):
        raise ValueError(f"bitonic_sort_perm_cuda: unsupported capacity "
                         f"{cap}")
    for p in planes:
        if p.dtype != torch.int32 or p.shape != (cap,) or p.device != dev:
            raise ValueError("bitonic_sort_perm_cuda: planes must be (cap,) "
                             "int32 tensors on one device")
    n_planes = len(planes)
    chunk, smem, passes = sort_geometry(cap, n_planes)
    planes = [p.contiguous() for p in planes]
    if n_planes <= MAX_PTR_PLANES:
        ptrs, stacked = (ctypes.c_void_p * n_planes)(
            *[p.data_ptr() for p in planes]), None
    else:
        ptrs, stacked = None, torch.stack(planes)
    perm = torch.empty(cap, dtype=torch.int32, device=dev)
    tmp = torch.empty(cap if passes else 0, dtype=torch.int32, device=dev)
    status = _library().bitonic_sort_perm(
        ptrs, None if stacked is None else stacked.data_ptr(), n_planes,
        cap, chunk, smem, perm.data_ptr(), tmp.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    ops.check_cuda(status, "bitonic_sort")
    ops.count_launch("bitonic_sort")
    return perm


def bitonic_sort_perm_plain(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """The same network stepped in plain PyTorch (the counterpart of the
    JAX package's ``_network``): every stage compares each element with
    its partner at XOR distance d and keeps the min or max of the pair,
    the row index riding along as the final tiebreak."""
    cap = planes[0].shape[0]
    dev = planes[0].device
    i = torch.arange(cap, device=dev, dtype=torch.int64)
    rows = torch.stack([p.to(torch.int64) for p in planes] + [i])
    for m in range(1, cap.bit_length()):
        descending = ((i >> m) & 1) == 1
        d = 1 << (m - 1)
        while d >= 1:
            partner = rows[:, i ^ d]
            gt = torch.zeros(cap, dtype=torch.bool, device=dev)
            eq = torch.ones(cap, dtype=torch.bool, device=dev)
            for a, b in zip(rows, partner):
                gt = gt | (eq & (a > b))
                eq = eq & (a == b)
            take_min = ((i & d) == 0) ^ descending
            take_partner = ~(gt ^ take_min)
            rows = torch.where(take_partner, partner, rows)
            d //= 2
    return rows[-1].to(torch.int32)


def sort_perm_cuda(keys: Sequence[torch.Tensor], cap: int) -> torch.Tensor:
    """Drop-in for ``kernels.sort_perm`` on supported capacities: same key
    contract (pre-transformed columns, nulls folded), same stable
    ascending permutation (int32).  Float keys are canonicalized first
    (-0.0 -> +0.0, every NaN -> +NaN) so the network orders them as the
    stable sort does, not by the raw total order."""
    canon = []
    for k in keys:
        if k.dtype == torch.float64:
            k = torch.where(k == 0, torch.zeros_like(k), k)
            k = torch.where(torch.isnan(k), torch.full_like(k, float("nan")),
                            k)
        canon.append(k)
    return bitonic_sort_perm(split_planes(canon))
