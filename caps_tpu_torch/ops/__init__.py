"""Hand-written CUDA kernels for the hot relational operators.

The counterparts of ``caps_tpu/ops`` (Pallas kernels for the TPU): each
kernel is CUDA C++ for ``sm_90a`` under ``csrc/``, built by nvcc on first
use (``build.py``) and bound with ctypes.  Beside every kernel sits a
plain PyTorch version of the same function (``*_plain``).  The kernel
wrapper (``*_cuda``) checks its inputs and launches the kernel or raises;
the entry point the engine calls takes the plain version only for
tensors on the CPU — there is no fallback.

Every launch adds one to the kernel's count; :func:`launches` reads the
counts so a run can show its path went through the kernels.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

_LAUNCHES: Counter = Counter()


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launches() -> Dict[str, int]:
    """Kernel name -> number of launches since the last reset."""
    return dict(_LAUNCHES)


def reset_launches() -> None:
    _LAUNCHES.clear()


def check_cuda(status: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


from caps_tpu_torch.ops.prefetch import (  # noqa: E402
    prefetch_gather_cuda, prefetch_gather_plain,
)
from caps_tpu_torch.ops.probe import (  # noqa: E402
    KernelSelfTestError, ensure_kernels,
)
from caps_tpu_torch.ops.expand import (  # noqa: E402
    DeviceCSR, build_csr, expand_positions, expand_positions_cuda,
    expand_positions_plain, join_expand_via_positions,
)
from caps_tpu_torch.ops.segment import (  # noqa: E402
    dense_segment_agg, dense_segment_agg_cuda, dense_segment_agg_plain,
)
from caps_tpu_torch.ops.sort import (  # noqa: E402
    bitonic_sort_perm, bitonic_sort_perm_cuda, bitonic_sort_perm_plain,
    sort_cap_supported, sort_perm_cuda, split_planes,
)

__all__ = [
    "launches", "reset_launches",
    "dense_segment_agg", "dense_segment_agg_cuda", "dense_segment_agg_plain",
    "DeviceCSR", "build_csr", "expand_positions", "expand_positions_cuda",
    "expand_positions_plain", "join_expand_via_positions",
    "bitonic_sort_perm", "bitonic_sort_perm_cuda", "bitonic_sort_perm_plain",
    "sort_cap_supported", "sort_perm_cuda", "split_planes",
    "prefetch_gather_cuda", "prefetch_gather_plain",
    "KernelSelfTestError", "ensure_kernels",
]
