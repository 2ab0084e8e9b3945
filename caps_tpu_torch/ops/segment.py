"""Dense-domain segment aggregation: the group-by histogram kernel.

The counterpart of ``caps_tpu/ops/segment.py``.  The string pool
dictionary-encodes group keys to dense int32 codes, so a group-by over a
string or bool key is a histogram over a small dense domain:

    out[s] = agg{ values[r] : codes[r] == s and ok[r] },  s in [0, S)

with the kinds of ``KINDS`` and the identities of ``_IDENT`` for empty
slots, for any S >= 1.  Float min and max order -0.0 below +0.0, and a
NaN among a slot's rows makes the slot NaN, as the JAX kernel's
``jnp.min``/``jnp.max`` do.  ``csrc/segment_agg.cu`` computes it on the
card (design notes there; launch geometry :func:`segment_geometry`);
:func:`dense_segment_agg_plain` is the same function in plain PyTorch,
used for CPU tensors and as the reference in tests.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Sequence, Tuple

import torch

from caps_tpu_torch import ops

KINDS = ("count", "sum_f32", "sum_i32", "min_i32", "max_i32",
         "min_f32", "max_f32")

# Launch geometry of csrc/segment_agg.cu (its THREADS, HIST_CLUSTER,
# SUM_CLUSTER, UNROLL and SUM_TILE): a block of THREADS threads keeps a
# histogram of one window of slots in shared memory; the blocks of a
# cluster (cluster_size(kind)) fold theirs through distributed shared
# memory.  A window holds at most MAX_SEGMENTS slots
# (int32, 32 KB) or MAX_SEGMENTS_F64 (sum_f32's doubles, 32 KB); S above
# that takes one launch per window.
THREADS = 256
HIST_CLUSTER = 4
SUM_CLUSTER = 8
UNROLL = 4
SUM_TILE = 1024
BLOCKS_PER_SM = 4
MAX_SEGMENTS = 8192
MAX_SEGMENTS_F64 = 4096

_IDENT = {
    "min_i32": torch.iinfo(torch.int32).max,
    "max_i32": torch.iinfo(torch.int32).min,
    "min_f32": float("inf"),
    "max_f32": float("-inf"),
}

_lib = None
_sm_counts: Dict[int, int] = {}
# (device index, stream) -> the kernel's zeroed state: MAX_SEGMENTS
# accumulator words, then the ticket counter.  The last cluster of every
# launch sets both back to 0, so the state stays valid for the next
# launch on the stream and under a captured CUDA graph's replay.
_states: Dict[Tuple[int, int], torch.Tensor] = {}
_states_lock = threading.Lock()


def _out_dtype(kind: str) -> torch.dtype:
    return torch.float32 if kind.endswith("f32") else torch.int32


def _library():
    global _lib
    if _lib is None:
        from caps_tpu_torch.ops.build import library
        lib = library("segment_agg")
        lib.segment_agg_sm_count.argtypes = [ctypes.c_int]
        lib.segment_agg_sm_count.restype = ctypes.c_int
        lib.segment_agg.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.segment_agg.restype = ctypes.c_int
        # the built library, loaded once a process: no run reads or
        # writes it after that, so a replay finds it as recorded
        _lib = lib  # capslint: disable=tracer-purity
    return _lib


def segment_geometry(n: int, num_segments: int, kind: str, sm_count: int,
                     vector: bool = True) -> Tuple[int, List[Tuple[int, int]]]:
    """(blocks, windows) of one call.

    ``windows`` are the (first slot, width) of each launch: consecutive,
    covering ``[0, num_segments)``, each at most the window limit of the
    kind.  ``blocks`` is a multiple of the kind's cluster size
    (:func:`cluster_size`): enough for the rows (a
    block takes THREADS * 4 * UNROLL rows a step, or SUM_TILE for
    sum_f32), at least one cluster and at most BLOCKS_PER_SM blocks on
    each of ``sm_count`` SMs (rounded down to whole clusters).
    ``vector`` False (inputs the kernel cannot read 16 bytes at a time)
    sizes the grid for one row a thread a step."""
    if num_segments < 1:
        raise ValueError(f"num_segments must be >= 1, got {num_segments}")
    limit = MAX_SEGMENTS_F64 if kind == "sum_f32" else MAX_SEGMENTS
    windows = [(base, min(limit, num_segments - base))
               for base in range(0, num_segments, limit)]
    if kind == "sum_f32":
        per_block = SUM_TILE
    elif vector:
        per_block = THREADS * 4 * UNROLL
    else:
        per_block = THREADS * UNROLL
    c = cluster_size(kind)
    cap = max(c, sm_count * BLOCKS_PER_SM // c * c)
    want = -(-max(n, 1) // per_block)
    return min(cap, -(-want // c) * c), windows


def cluster_size(kind: str) -> int:
    """Blocks a cluster of the kind's launch."""
    return SUM_CLUSTER if kind == "sum_f32" else HIST_CLUSTER


def vector_head(codes_ptr: int, ok_ptr: int, values_ptr: int,
                n: int) -> Tuple[bool, int]:
    """(vector, head): the kernel reads rows ``[head, head + 4k)`` 16
    bytes of codes and values (4 bytes of ok) at a time when every
    pointer is aligned there; ``head`` (< 4) rows before them and the
    tail after take its scalar loop.  ``vector`` False sends every row
    through the scalar loop."""
    head = (-(codes_ptr // 4)) % 4 if codes_ptr % 4 == 0 else 0
    vector = (codes_ptr % 4 == 0 and (codes_ptr + 4 * head) % 16 == 0
              and (ok_ptr + head) % 4 == 0
              and (values_ptr + 4 * head) % 16 == 0 and n - head >= 4)
    return vector, head if vector else 0


def _sm_count(index: int) -> int:
    count = _sm_counts.get(index)
    if count is None:
        count = _library().segment_agg_sm_count(index)
        if count <= 0:
            raise RuntimeError(f"segment_agg: cannot read the SM count of "
                               f"cuda:{index} (CUDA error {-count})")
        _sm_counts[index] = count
    return count


def _state(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _states.get(key)
    if t is None:
        with _states_lock:
            t = _states.get(key)
            if t is None:
                t = torch.zeros(MAX_SEGMENTS + 1, dtype=torch.int32,
                                device=device)
                _states[key] = t
    return t


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
    ``csrc/segment_agg.cu`` once per window of slots on the current
    stream, or raises."""
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
    if n >= 2 ** 31 or num_segments >= 2 ** 31:
        raise ValueError(f"dense_segment_agg_cuda: {n} rows and "
                         f"{num_segments} slots must each be below 2**31")
    lib = _library()
    dev = codes.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    vector, head = vector_head(codes.data_ptr(), ok.data_ptr(),
                               values.data_ptr(), n)
    blocks, windows = segment_geometry(
        n, num_segments, kind, _sm_count(dev.index), vector)
    out = torch.empty(num_segments, dtype=_out_dtype(kind), device=dev)
    clusters = blocks // cluster_size(kind)
    # sum_f32's per-cluster partials, reused by every window (the windows
    # run in stream order); one cluster folds straight into out
    partials = torch.empty(
        clusters * windows[0][1] if kind == "sum_f32" and clusters > 1
        else 0, device=dev, dtype=torch.float64)
    state = _state(dev, stream)
    acc, ticket = state.data_ptr(), state.data_ptr() + 4 * MAX_SEGMENTS
    kind_id = KINDS.index(kind)
    for base, w in windows:
        # launched on the tensors' card (a shard's, on a mesh)
        with torch.cuda.device(dev):
            status = lib.segment_agg(
                codes.data_ptr(), ok.data_ptr(), values.data_ptr(), n, head,
                int(vector), base, w, kind_id, blocks, acc,
                partials.data_ptr(), ticket,
                out.data_ptr() + base * out.element_size(), stream)
        ops.check_cuda(status, "segment_agg")
        ops.count_launch("segment_agg")
    return out


def float_order_key(v: torch.Tensor, nan_key: int) -> torch.Tensor:
    """The kernel's order-preserving int32 image of float32 ``v``:
    a < b iff key(a) < key(b), -0.0 below +0.0, and every NaN maps to
    ``nan_key`` (the extreme key of a min or a max)."""
    bits = v.contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    return torch.where(torch.isnan(v), torch.full_like(key, nan_key), key)


def float_from_key(key: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`float_order_key` (an extreme key decodes
    to a NaN)."""
    return torch.where(key >= 0, key, key ^ 0x7FFFFFFF).view(torch.float32)


def dense_segment_agg_plain(codes: torch.Tensor, ok: torch.Tensor,
                            values: torch.Tensor, num_segments: int,
                            kind: str) -> torch.Tensor:
    """The same function in plain PyTorch (scatter into one extra slot
    that swallows masked and out-of-range rows; float min/max reduce
    the order-preserving int32 image)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if num_segments < 1:
        raise ValueError(f"num_segments must be >= 1, got {num_segments}")
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
    reduce = "amin" if kind.startswith("min") else "amax"
    if kind.endswith("f32"):
        i32 = torch.iinfo(torch.int32)
        nan_key = i32.min if reduce == "amin" else i32.max
        ident = float_order_key(
            torch.tensor([_IDENT[kind]], dtype=torch.float32), nan_key)
        out = torch.full((S + 1,), int(ident), dtype=torch.int32,
                         device=codes.device)
        out.scatter_reduce_(0, safe, float_order_key(v, nan_key),
                            reduce=reduce, include_self=True)
        return float_from_key(out[:S])
    out = torch.full((S + 1,), _IDENT[kind], dtype=out_dtype,
                     device=codes.device)
    return out.scatter_reduce_(0, safe, v, reduce=reduce,
                               include_self=True)[:S]


def dense_segment_agg_sharded(mesh, codes: Sequence[torch.Tensor],
                              ok: Sequence[torch.Tensor],
                              values: Sequence[torch.Tensor],
                              num_segments: int, kind: str) -> torch.Tensor:
    """Distributed histogram, the counterpart of the JAX package's
    ``dense_segment_agg_sharded`` (rows split over every mesh axis): the
    kernel runs once per shard on the shard's row block
    (:func:`dense_segment_agg`: the kernel on a card, its plain version
    on the CPU), then the partials combine on the lead device through
    the mesh's all-reduces (``global_sum`` for count and sum, ``pmin`` /
    ``pmax`` for min and max, which fold as the JAX package's do: a NaN
    partial never wins, ±0 keep the earlier shard's sign, and an empty
    slot keeps its identity).  Within a shard the kernel's own rules
    hold (module docstring).  ``codes``, ``ok`` and ``values`` are
    each shard's resident block: lists, one per shard, each on its
    shard's device."""
    from caps_tpu_torch.parallel.collectives import global_sum, pmax, pmin
    if kind == "count":
        values = codes
    if not len(codes) == len(ok) == len(values) == mesh.size:
        raise ValueError(f"{len(codes)} blocks for {mesh.size} shards")
    parts = [dense_segment_agg(c.contiguous(), o.contiguous(),
                               v.contiguous(), num_segments, kind)
             for c, o, v in zip(codes, ok, values)]
    reduce = (pmin if kind.startswith("min") else
              pmax if kind.startswith("max") else global_sum)
    return reduce(parts, [mesh.lead])[0]
