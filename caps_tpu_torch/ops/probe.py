"""Kernel self-test: the counterpart of ``caps_tpu/ops/probe.py``.

The JAX package gates the first compiled use of each Pallas kernel
family with ``pallas_usable(feature)``: a probe that compiles one
representative kernel and, when it fails, selects the jnp twin.  The port
has no capability gate (ROADMAP rule 2) — a kernel that does not build,
launch or agree raises.  :func:`ensure_kernels` takes ``pallas_usable``'s
place at the same call sites and turns the probe into a self-test: on
the first request for a family in a process, on a CUDA device, it builds
and launches that family's kernels at the probe's own shapes and holds
each result against its plain PyTorch version.

    basic    — the segment-aggregation kernel (K1), at S = 130 (count) and
               S = 1500 (max_f32 and min_f32, with a few signed zeros and
               NaNs of both signs), n = 4096
    prefetch — the tile-gather kernel (K4) at tile 256 × 4 tiles, and the
               expand-positions kernel (K2) at two small shapes that
               between them reach every path of its merge-path design:
               int64 and int32 inputs, a run of zero-count rows longer
               than a tile, one row spanning several tiles, tiles that
               mix rows and padding, and pure padding tiles
    sort     — the sort kernel (K3) at capacity 256 (one chunk block) and
               at capacity 2048 (two chunk blocks, then one merge pass
               over the card)

It never returns a verdict and never selects a plain version: any
difference raises :class:`KernelSelfTestError`.  It keeps no verdicts on
disk (the kernel libraries are already cached by source hash) and does
nothing for a CPU device, as ``pallas_usable`` returns True off a TPU.
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Dict, Tuple

import numpy as np
import torch

FEATURES = ("basic", "prefetch", "sort")

_lock = threading.Lock()
# (feature, device) -> seconds its first self-test took in this process
_DONE: Dict[Tuple[str, str], float] = {}
# kernel name -> launches the self-tests made in this process
_LAUNCHED: Counter = Counter()


class KernelSelfTestError(RuntimeError):
    """A kernel family's self-test result differs from its plain
    version."""


def ensure_kernels(feature: str, device) -> None:
    """Self-test the kernel family ``feature`` on ``device`` once per
    process (see the module docstring).  A no-op on the CPU and on every
    later call."""
    if feature not in FEATURES:
        raise ValueError(f"unknown kernel family {feature!r}")
    device = torch.device(device)
    if device.type != "cuda":
        return
    key = (feature, str(device))
    if key in _DONE:
        return
    with _lock:
        if key in _DONE:
            return
        from caps_tpu_torch import ops
        before = Counter(ops.launches())
        t0 = time.perf_counter()
        _SELFTESTS[feature](device)
        torch.cuda.synchronize(device)
        _DONE[key] = time.perf_counter() - t0
        _LAUNCHED.update(Counter(ops.launches()) - before)


def selftest_seconds() -> Dict[str, float]:
    """Family -> seconds its first self-test took (building the kernel
    library included), for the families run in this process."""
    return {f: s for (f, _d), s in _DONE.items()}


def selftest_launches() -> Dict[str, int]:
    """Kernel name -> launches the self-tests made in this process, so
    a caller can tell them from the launches of the query that
    triggered them."""
    return dict(_LAUNCHED)


def _expect_equal(feature: str, what: str, got: torch.Tensor,
                  want: torch.Tensor) -> None:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise KernelSelfTestError(
            f"{feature}: {what} gave {tuple(got.shape)} {got.dtype}, the "
            f"plain version {tuple(want.shape)} {want.dtype}")
    if got.dtype.is_floating_point:
        # bit for bit: a NaN equals a NaN of the same bits, -0.0 != +0.0
        got = got.view(torch.int32 if got.element_size() == 4 else torch.int64)
        want = want.view(got.dtype)
    if not torch.equal(got, want):
        diff = (got.double() - want.double()).abs()
        diff = torch.where(torch.isnan(diff), torch.full_like(diff, 1.0),
                           diff)
        raise KernelSelfTestError(
            f"{feature}: {what} differs from its plain version at "
            f"{int((diff != 0).sum())} of {diff.numel()} elements (max abs "
            f"err {float(diff.max())})")


def _basic(device) -> None:
    from caps_tpu_torch.ops import segment as S
    rng = np.random.RandomState(0)
    n = 4096
    for segs, kind in ((130, "count"), (1500, "max_f32"), (1500, "min_f32")):
        codes = torch.from_numpy(
            rng.randint(0, segs, n).astype(np.int32)).to(device)
        ok = torch.from_numpy(rng.rand(n) < 0.9).to(device)
        v = rng.randn(n).astype(np.float32)
        # signed zeros and NaNs of both signs on a few rows
        v[rng.randint(0, n, 64)] = np.array([0.0, -0.0, np.nan, -np.nan],
                                            dtype=np.float32)[
            rng.randint(0, 4, 64)]
        vals = codes if kind == "count" else torch.from_numpy(v).to(device)
        _expect_equal("basic", f"segment_agg({kind}, S={segs})",
                      S.dense_segment_agg_cuda(codes, ok, vals, segs, kind),
                      S.dense_segment_agg_plain(codes, ok, vals, segs, kind))


def _prefetch(device) -> None:
    from caps_tpu_torch.ops import expand as X
    from caps_tpu_torch.ops import prefetch as P
    tile, n_tiles = 256, 4
    x = torch.arange(tile * n_tiles, dtype=torch.int32, device=device)
    blk = torch.tensor([2, 0, 3, 2], dtype=torch.int32, device=device)
    out, bad = P.prefetch_gather_cuda(x, blk, tile)
    if int(bad):
        raise KernelSelfTestError("prefetch: prefetch_gather flagged an "
                                  "in-range block index")
    _expect_equal("prefetch", "prefetch_gather(tile=256, n_tiles=4)", out,
                  P.prefetch_gather_plain(x, blk, tile))
    rng = np.random.RandomState(0)
    # int64, a few tiles: rows, row ends and padding share tiles
    counts = rng.randint(0, 5, 700)
    # int32: a zero run longer than a tile, one row over several tiles,
    # then pure padding tiles
    long_run = rng.randint(0, 5, 3 * X.NV)
    long_run[:X.NV + 100] = 0
    long_run[X.NV + 100] = 3 * X.NV
    for c, out_cap in ((counts, 4096),
                       (long_run.astype(np.int32), 16 * X.NV)):
        ct = torch.from_numpy(c).to(device)
        lo = torch.arange(len(c), device=device, dtype=ct.dtype)
        for g, w in zip(X.expand_positions_cuda(ct, lo, out_cap),
                        X.expand_positions_plain(ct, lo, out_cap)):
            _expect_equal("prefetch", f"expand_positions(cap_l={len(c)}, "
                          f"out_cap={out_cap}, {ct.dtype})", g, w)


def _sort(device) -> None:
    from caps_tpu_torch.ops import sort as S
    rng = np.random.RandomState(0)
    for cap in (256, 2048):    # one chunk; two chunks and a merge pass
        keys = [torch.from_numpy(rng.randint(0, 50, cap).astype(np.int64))
                .to(device)]
        planes = S.split_planes(keys)
        _expect_equal("sort", f"bitonic_sort(cap={cap}, "
                      f"{len(planes)} planes)",
                      S.bitonic_sort_perm_cuda(planes),
                      S.bitonic_sort_perm_plain(planes))


_SELFTESTS = {"basic": _basic, "prefetch": _prefetch, "sort": _sort}
