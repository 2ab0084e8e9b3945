"""Shape bucketing: a bounded lattice of operator-launch sizes.

The counterpart of ``caps_tpu/relational/shapes.py``.  Every device-side
operator pads its rows up to a capacity bucket
(``backends/cuda/table.py``), so capacities come from a small set and the
fused executor's recorded size streams stay reusable across parameter
values.  :class:`ShapeBucketLattice` holds the bucket boundaries (the
device backend's padding ladder) and can be seeded with observed sizes;
:func:`param_shape_signature` maps a parameter binding to a
value-independent bucketed shape token.

The lattice only ever grows (boundaries are added, never removed, and
never beyond ``max_buckets``): a seed changes which bucket new launches
pad to, but every recorded fused size stream stays valid — recorded
capacities are plain integers, and generic replay checks every served
size on the device wherever the boundaries sit.
"""
from __future__ import annotations

from typing import Any, Iterable, Mapping, Optional, Tuple

from caps_tpu_torch.obs.lockgraph import make_lock

#: the fixed ladder EngineConfig ships — the un-seeded default, so an
#: un-adapted lattice buckets exactly like ``EngineConfig.bucket_for``
DEFAULT_BUCKETS: Tuple[int, ...] = (256, 1024, 4096, 16384, 65536,
                                    262144, 1048576)


def _pow2_ceil(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


class ShapeBucketLattice:
    """A bounded, monotonically growing set of row-capacity boundaries.

    ``bucket(n)`` rounds ``n`` up to the smallest boundary >= n (beyond
    the largest boundary: repeated doubling, like
    ``EngineConfig.bucket_for``).  ``seed(sizes)`` inserts the
    power-of-two ceiling of each observed size as a new boundary, bounded
    by ``max_buckets``."""

    def __init__(self, buckets: Optional[Iterable[int]] = None,
                 max_buckets: int = 64, registry=None):
        base = tuple(buckets) if buckets else DEFAULT_BUCKETS
        self.max_buckets = max(len(base), int(max_buckets))
        self._buckets: Tuple[int, ...] = tuple(sorted(
            {max(1, int(b)) for b in base}))
        self._lock = make_lock("shapes.ShapeBucketLattice._lock")
        self._seeded_c = (registry.counter("bucket.seeded")
                          if registry is not None else None)
        if registry is not None:
            registry.gauge("bucket.boundaries",
                           fn=lambda: len(self._buckets))

    def bucket(self, n: int) -> int:
        n = int(n)
        buckets = self._buckets  # tuple read is atomic; no lock on reads
        for b in buckets:
            if n <= b:
                return b
        b = buckets[-1]
        while b < n:
            b *= 2
        return b

    def signature(self, n: int) -> str:
        """The bucket token of a size — stable across every value that
        pads to the same capacity."""
        return f"b{self.bucket(n)}"

    def boundaries(self) -> Tuple[int, ...]:
        return self._buckets

    def seed(self, sizes: Iterable[int]) -> int:
        """Insert the power-of-two ceiling of each observed size as a
        boundary (idempotent; bounded).  Returns how many boundaries
        were added."""
        wanted = sorted({_pow2_ceil(s) for s in sizes if int(s) > 0})
        added = 0
        with self._lock:
            have = set(self._buckets)
            for b in wanted:
                if b in have or len(have) >= self.max_buckets:
                    continue
                have.add(b)
                added += 1
            if added:
                self._buckets = tuple(sorted(have))
        if added and self._seeded_c is not None:
            self._seeded_c.inc(added)
        return added

    def seed_from_op_stats(self, op_stats) -> int:
        """Seed from the observed-statistics store (obs/telemetry.py):
        each (plan family, operator)'s actual max row count becomes a
        candidate boundary — the sizes real traffic launches at."""
        sizes = []
        for ops in op_stats.stats().values():
            for st in ops.values():
                sizes.append(int(st.get("rows_max") or 0))
        return self.seed(sizes)


# -- parameter shape signatures ----------------------------------------------

def param_shape_token(value: Any,
                      lattice: Optional[ShapeBucketLattice] = None) -> str:
    """A value-independent shape token for one parameter binding:
    scalars reduce to their coarse type, containers to type + length
    bucket, maps to their key set (pattern-property expansion plans per
    key — plan_cache.PlanParams.map_keys)."""
    lat = lattice if lattice is not None else ShapeBucketLattice()
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "bool"
    if isinstance(value, int):
        return "int"
    if isinstance(value, float):
        return "float"
    if isinstance(value, str):
        return "str"
    if isinstance(value, bytes):
        return "bytes"
    if isinstance(value, (list, tuple)):
        return f"list:{lat.signature(len(value))}"
    if isinstance(value, (set, frozenset)):
        return f"set:{lat.signature(len(value))}"
    if isinstance(value, Mapping):
        keys = ",".join(sorted(str(k) for k in value))
        return f"map[{keys}]"
    return f"?{type(value).__name__}"


def param_shape_signature(params: Mapping[str, Any],
                          lattice: Optional[ShapeBucketLattice] = None
                          ) -> Tuple[Tuple[str, str], ...]:
    """Sorted (name, shape token) tuple — hashable and stable across
    parameter values whose shapes land in the same buckets."""
    return tuple(sorted((k, param_shape_token(v, lattice))
                        for k, v in params.items()))


def signature_text(sig: Tuple[Tuple[str, str], ...]) -> str:
    """Compact string form of a signature."""
    return "{" + ",".join(f"{k}:{t}" for k, t in sig) + "}"
