"""Dense-domain segment aggregation: the group-by histogram kernel.

The counterpart of ``caps_tpu/ops/segment.py``.  The string pool
dictionary-encodes group keys to dense int32 codes, so a group-by over a
string or bool key is a histogram over a small dense domain:

    out[s] = agg{ values[r] : codes[r] == s and ok[r] },  s in [0, S)

with the kinds of ``KINDS`` and the identities of ``_IDENT`` for empty
slots.  ``csrc/segment_agg.cu`` computes it on the card (design notes
there); :func:`dense_segment_agg_plain` is the same function in plain
PyTorch, used for CPU tensors and as the reference in tests.
"""
from __future__ import annotations

import ctypes

import torch

from caps_tpu_torch import ops

KINDS = ("count", "sum_f32", "sum_i32", "min_i32", "max_i32",
         "min_f32", "max_f32")
# the kernel's privatized histogram holds every slot in shared memory
MAX_SEGMENTS = 4096

_IDENT = {
    "min_i32": torch.iinfo(torch.int32).max,
    "max_i32": torch.iinfo(torch.int32).min,
    "min_f32": float("inf"),
    "max_f32": float("-inf"),
}

_lib = None


def _out_dtype(kind: str) -> torch.dtype:
    return torch.float32 if kind.endswith("f32") else torch.int32


def _library():
    global _lib
    if _lib is None:
        from caps_tpu_torch.ops.build import library
        lib = library("segment_agg")
        lib.segment_agg_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.segment_agg_blocks.restype = ctypes.c_int
        lib.segment_agg.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.segment_agg.restype = ctypes.c_int
        _lib = lib
    return _lib


def dense_segment_agg(codes: torch.Tensor, ok: torch.Tensor,
                      values: torch.Tensor, num_segments: int,
                      kind: str) -> torch.Tensor:
    """Aggregate ``values`` (or row counts) into ``num_segments`` dense
    slots indexed by ``codes``; rows with ``ok`` False, or a code outside
    ``[0, num_segments)``, are ignored.

    codes: (n,) int32; ok: (n,) bool; values: (n,) float32 for the
    ``*_f32`` kinds, int32 otherwise (ignored for ``count`` — pass codes).
    Returns (num_segments,) int32, or float32 for the ``*_f32`` kinds.
    """
    if codes.device.type == "cpu":
        return dense_segment_agg_plain(codes, ok, values, num_segments, kind)
    return dense_segment_agg_cuda(codes, ok, values, num_segments, kind)


def dense_segment_agg_cuda(codes: torch.Tensor, ok: torch.Tensor,
                           values: torch.Tensor, num_segments: int,
                           kind: str) -> torch.Tensor:
    """The kernel wrapper: checks its inputs, launches
    ``csrc/segment_agg.cu`` on the current stream, or raises."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if codes.device.type != "cuda":
        raise ValueError(f"dense_segment_agg_cuda: needs CUDA tensors, got "
                         f"{codes.device}")
    n = codes.shape[0]
    want = torch.float32 if kind.endswith("f32") else torch.int32
    if kind == "count":
        want = codes.dtype
    for name, t, dtype in (("codes", codes, torch.int32),
                           ("ok", ok, torch.bool), ("values", values, want)):
        if (t.device != codes.device or t.dtype != dtype or t.dim() != 1
                or t.shape[0] != n or not t.is_contiguous()):
            raise ValueError(
                f"dense_segment_agg_cuda: {name} must be a contiguous ({n},) "
                f"{dtype} tensor on {codes.device}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
    if not 1 <= num_segments <= MAX_SEGMENTS:
        raise ValueError(f"dense_segment_agg_cuda: num_segments {num_segments} "
                         f"outside [1, {MAX_SEGMENTS}]")
    lib = _library()
    kind_id = KINDS.index(kind)
    blocks = lib.segment_agg_blocks(n, kind_id)
    partials = torch.empty(
        blocks * num_segments, device=codes.device,
        dtype=torch.float64 if kind == "sum_f32" else torch.int32)
    out = torch.empty(num_segments, dtype=_out_dtype(kind),
                      device=codes.device)
    status = lib.segment_agg(
        codes.data_ptr(), ok.data_ptr(), values.data_ptr(), n, num_segments,
        kind_id, partials.data_ptr(), blocks, out.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream)
    ops.check_cuda(status, "segment_agg")
    ops.count_launch("segment_agg")
    return out


def dense_segment_agg_plain(codes: torch.Tensor, ok: torch.Tensor,
                            values: torch.Tensor, num_segments: int,
                            kind: str) -> torch.Tensor:
    """The same function in plain PyTorch (scatter into one extra slot
    that swallows masked and out-of-range rows)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    S = num_segments
    codes = codes.to(torch.int64)
    ok = ok.to(torch.bool) & (codes >= 0) & (codes < S)
    safe = torch.where(ok, codes, torch.full_like(codes, S))
    out_dtype = _out_dtype(kind)
    if kind == "count":
        out = torch.zeros(S + 1, dtype=out_dtype, device=codes.device)
        return out.index_add_(0, safe, ok.to(out_dtype))[:S]
    v = values.to(out_dtype)
    if kind.startswith("sum"):
        # float sums accumulate in double and round once, as the kernel
        acc = torch.float64 if kind == "sum_f32" else out_dtype
        out = torch.zeros(S + 1, dtype=acc, device=codes.device)
        v = torch.where(ok, v, torch.zeros_like(v)).to(acc)
        return out.index_add_(0, safe, v)[:S].to(out_dtype)
    out = torch.full((S + 1,), _IDENT[kind], dtype=out_dtype,
                     device=codes.device)
    reduce = "amin" if kind.startswith("min") else "amax"
    return out.scatter_reduce_(0, safe, v, reduce=reduce,
                               include_self=True)[:S]
