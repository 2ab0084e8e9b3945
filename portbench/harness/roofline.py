"""Peaks of the card and the work of each hand-written kernel's call.

A kernel's roofline share is the least time the card could take for
the calls (the larger of bytes over the memory rate and operations over
the arithmetic rate, each call's work counted from its logical shapes)
over the device time those calls took.  The work is that of the
algorithm: inputs read once, outputs written once, whatever implements
it.  The byte counts are copies of ``segment_bound`` and
``expand_timings`` in ``chip_smoke.py``'s kernel phase.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Tuple

# One NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet): the HBM3
# rate, and the float32 rate outside the tensor cores, used for 32-bit
# integer work too.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

# the kernels' names on the device timeline (csrc/*.cu of the port)
K1_KERNELS = r"(?:^|[\s*&])(hist_kernel|sum_kernel)\s*[<(]"
K2_KERNELS = r"(?:^|[\s*&])(scan_reduce|scan_partition|expand_tiles)\s*[<(]"


def bound_s(bytes_moved: int, ops: int) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / OPS_PER_S)


def k1_work(n: int, num_segments: int, kind: str) -> Tuple[int, int]:
    """(bytes, ops) of one dense segment aggregation of n rows into
    ``num_segments`` slots: codes (int32) and ok (bool) read once, the
    values (4 bytes) too unless the kind is count, the slots written
    once; one operation a row."""
    return 5 * n + (0 if kind == "count" else 4 * n) + 4 * num_segments, n


def k2_work(cap_l: int, counts_bytes: int, lo_bytes: int,
            out_cap: int) -> Tuple[int, int]:
    """(bytes, ops) of one expansion: counts and lo read once, the three
    outputs (int32 row, int32 position, bool valid) written once for
    every slot; one operation a slot and a row."""
    return cap_l * (counts_bytes + lo_bytes) + out_cap * 9, out_cap + cap_l


class CallRecorder:
    """Wraps a kernel wrapper of the port to note each call's work while
    a traced window runs (shapes only: nothing is copied or launched)."""

    def __init__(self, module, name: str, work: Callable[..., Tuple[int, int]]):
        self.module, self.name, self.work = module, name, work
        self.inner = getattr(module, name)
        self.calls: List[Tuple[int, int]] = []
        self._lock = threading.Lock()

    def __call__(self, *args):
        w = self.work(*args)
        with self._lock:
            self.calls.append(w)
        return self.inner(*args)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)

    def least_s(self) -> float:
        return sum(bound_s(b, o) for b, o in self.calls)


def k1_of_call(codes, ok, values, num_segments, kind):
    return k1_work(codes.shape[0], num_segments, kind)


def k2_of_call(counts, lo, out_cap):
    return k2_work(counts.shape[0], counts.element_size(),
                   lo.element_size(), out_cap)


def recorders():
    """The recorders of K1 and K2, by metric kernel name."""
    from caps_tpu_torch.ops import expand, segment
    return {"k1": CallRecorder(segment, "dense_segment_agg_cuda", k1_of_call),
            "k2": CallRecorder(expand, "expand_positions_cuda", k2_of_call)}
