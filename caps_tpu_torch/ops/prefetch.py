"""Tile gather by a prefetched block index: the capability probe's
scalar-prefetch kernel.

The counterpart of the ``prefetch`` program of
``caps_tpu/ops/probe.py`` (``k2``): output tile ``i`` is source tile
``blk[i]`` of ``x``, doubled.  The JAX package runs it to learn whether a
scalar-prefetch grid — the shape of its expand kernel — compiles on the
TPU stack; the port runs it as part of the kernel self-test
(``probe.ensure_kernels("prefetch")``) before the first join.
``csrc/prefetch_gather.cu`` computes it on the card (design notes
there); :func:`prefetch_gather_plain` is the same function in plain
PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from caps_tpu_torch import ops

_lib = None


def _library():
    global _lib
    if _lib is None:
        from caps_tpu_torch.ops.build import library
        lib = library("prefetch_gather")
        lib.prefetch_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.prefetch_gather.restype = ctypes.c_int
        # the built library, loaded once a process: no run reads or
        # writes it after that, so a replay finds it as recorded
        _lib = lib  # capslint: disable=tracer-purity
    return _lib


def prefetch_gather_cuda(x: torch.Tensor, blk: torch.Tensor, tile: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel wrapper: checks its inputs, launches
    ``csrc/prefetch_gather.cu`` on the current stream, or raises.

    x: (tile * n_src,) int32; blk: (n_tiles,) int32 tile indices.
    Returns ``(out, bad)``: out (tile * n_tiles,) int32 with
    ``out[i*tile + j] = 2 * x[blk[i]*tile + j]``, and bad, a () int32
    device flag set to 1 when some ``blk[i]`` lies outside
    ``[0, n_src)`` (that output tile is then zeros)."""
    if x.device.type != "cuda":
        raise ValueError(f"prefetch_gather_cuda: needs CUDA tensors, got "
                         f"{x.device}")
    for name, t in (("x", x), ("blk", blk)):
        if (t.dtype != torch.int32 or t.dim() != 1 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(
                f"prefetch_gather_cuda: {name} must be a contiguous 1-D "
                f"int32 tensor on {x.device}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
    if tile <= 0 or x.shape[0] % tile:
        raise ValueError(f"prefetch_gather_cuda: x length {x.shape[0]} is "
                         f"not a multiple of tile {tile}")
    n_src = x.shape[0] // tile
    n_tiles = blk.shape[0]
    if tile * max(n_tiles, n_src) >= 2 ** 31:
        raise ValueError("prefetch_gather_cuda: sizes exceed int32")
    out = torch.empty(tile * n_tiles, dtype=torch.int32, device=x.device)
    bad = torch.zeros((), dtype=torch.int32, device=x.device)
    # launched on the tensors' card (a shard's, on a mesh)
    with torch.cuda.device(x.device):
        status = _library().prefetch_gather(
            x.data_ptr(), blk.data_ptr(), tile, n_tiles, n_src,
            out.data_ptr(), bad.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    ops.check_cuda(status, "prefetch_gather")
    ops.count_launch("prefetch_gather")
    return out, bad


def prefetch_gather_plain(x: torch.Tensor, blk: torch.Tensor, tile: int
                          ) -> torch.Tensor:
    """The same function in plain PyTorch (in-range ``blk`` only)."""
    return (2 * x.view(-1, tile)[blk.long()]).reshape(-1)
