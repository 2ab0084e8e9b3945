"""Engine configuration and debug flags.

The reference used a small homegrown flag registry backed by JVM system
properties (PrintTimings/PrintIr/PrintLogicalPlan/PrintRelationalPlan/...)
plus the SparkConf passed to the session builder (ref:
okapi-api/.../okapi/impl/configuration/ — reconstructed, mount empty;
SURVEY.md §5.6).  Here: one frozen dataclass with env-var overrides.
"""
from __future__ import annotations

import dataclasses
import os
from typing import ClassVar, Tuple


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None:
        return default
    return int(v)


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v is not None else default


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # Debug printing (the reference's PrintIr / PrintLogicalPlan / ... flags)
    print_timings: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_PRINT_TIMINGS", False))
    print_ir: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_PRINT_IR", False))
    print_logical_plan: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_PRINT_LOGICAL", False))
    print_relational_plan: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_PRINT_RELATIONAL", False))

    # Device backend tuning
    # Row-count buckets: device tables are padded up to the next bucket so
    # query programs compile once per (plan, bucket) key.
    bucket_sizes: Tuple[int, ...] = (256, 1024, 4096, 16384, 65536, 262144, 1048576)
    # Mesh shape for sharded execution (parallel/mesh.py); () = one
    # device.  (n,) is a 1-D mesh, (dcn, n) a two-level one.
    mesh_shape: Tuple[int, ...] = ()
    # Device-resident CSR adjacency as the relationship scan's physical
    # layout (ops/expand.py DeviceCSR); joins against it probe indptr
    # instead of sorting + binary-searching the edge table.
    use_csr: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_USE_CSR", True))
    # Aggregate pushdown (relational/count_pattern.py): lower count-only
    # pattern chains to SpMV over the adjacency instead of join+count.
    use_count_pushdown: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_COUNT_PUSHDOWN", True))
    # Matrix var-expand (relational/var_expand.py): an eligible
    # var-length pattern whose relationship list nothing reads runs as
    # SpMV hops over a per-seed count matrix (strategy "matrix") instead
    # of the join cascade; on a 1-D mesh the same matrix and uniform
    # pushdown chains ride the ring schedule (parallel/ring.py).
    use_ring: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_USE_RING", True))
    # Worst-case-optimal multiway joins (relational/wcoj.py): detected
    # cyclic MATCH segments (chain + closing edges) run as one
    # leapfrog-style intersection over sorted edge keys instead of the
    # binary join cascade.  Cost-selected when the model is on; off =
    # the cascade everywhere.
    use_wcoj: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_WCOJ", True))
    # Cost-based planning (relational/cost.py + relational/stats.py):
    # ingest-time cardinality/degree/skew sketches price plans, re-root
    # Expand chains at their cheaper end (logical/optimizer.py), choose
    # count pushdown vs cascade and WCOJ vs cascade, and stamp
    # per-operator row estimates.  Off = the fixed heuristics.
    use_cost_model: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_COST_MODEL", True))
    # Divergence-triggered re-planning: model-divergent executions per
    # plan family before its cached plan retires and re-plans with
    # calibrated statistics.  0 disables.
    replan_threshold: int = dataclasses.field(
        default_factory=lambda: _env_int("CAPS_TPU_REPLAN_THRESHOLD", 2))
    # Hand-scheduled distributed joins (parallel/dist_join.py, SURVEY.md
    # §5.8): on a mesh, large-large joins ride a radix exchange (each row
    # crosses between shards once) and small build sides a broadcast.
    use_dist_join: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_DIST_JOIN", True))
    # Build sides at or under this many rows broadcast instead of
    # exchanging (Spark's autoBroadcastJoinThreshold analog, in rows); a
    # model INPUT with the cost model on (relational/cost.py
    # choose_dist_strategy); <= 0 disables broadcasting either way.
    broadcast_join_threshold: int = dataclasses.field(
        default_factory=lambda: _env_int("CAPS_TPU_BROADCAST_ROWS", 4096))
    # Skew salting for the radix exchange (surgical: ONLY detected-hot
    # keys replicate).  join_salt > 1 forces that salt factor; 1 = pick
    # it from the probe-key sample (1 when no key exceeds
    # join_hot_factor x the per-shard fair share).
    join_salt: int = dataclasses.field(
        default_factory=lambda: _env_int("CAPS_TPU_JOIN_SALT", 1))
    join_hot_factor: float = dataclasses.field(
        default_factory=lambda: _env_float("CAPS_TPU_JOIN_HOT_FACTOR", 4.0))
    # At most this many hot keys ride the device-resident hot set.
    join_hot_capacity: int = dataclasses.field(
        default_factory=lambda: _env_int("CAPS_TPU_JOIN_HOT_CAP", 16))

    # Features of the JAX package this package has not ported (see
    # ROADMAP): none is left.  A flag listed here would make a session
    # built with it on raise NotImplementedError.
    UNPORTED_FLAGS: ClassVar[Tuple[str, ...]] = ()

    # Fused executor (backends/cuda/fused.py): record data-dependent sizes
    # on a query's first run, replay them sync-free on repeats.
    use_fused: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_USE_FUSED", True))
    # Cached count-pushdown closures (relational/count_pattern.py): the
    # seed→hops→masks→correction chain over per-graph static edge
    # arrays, built once per (graph, plan shape, parameter shapes).
    use_fused_count: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_FUSED_COUNT", True))
    # Capacity of the fused executor's memo of recorded size streams
    # (and of the cached count-pushdown closures).
    compile_cache_size: int = dataclasses.field(
        default_factory=lambda: _env_int("CAPS_TPU_COMPILE_CACHE", 512))
    # Prepared-statement plan cache (relational/plan_cache.py): repeated
    # parameterized queries skip parse/IR/logical/relational planning on a
    # hit.  Keys are value-independent (query text + graph + parameter
    # signature).
    use_plan_cache: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_PLAN_CACHE", True))
    # Max cached plans per session (LRU evicted beyond this).
    plan_cache_size: int = dataclasses.field(
        default_factory=lambda: _env_int("CAPS_TPU_PLAN_CACHE_SIZE", 256))
    # Debug assertion hook for the generic-replay __obj__ invariant
    # (backends/cuda/fused.py): an obj served under generic replay that
    # no downstream relation-checked consume guards raises at query end.
    debug_obj_guard: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_DEBUG_OBJ_GUARD", False))

    # Determinism check (SURVEY.md §5.2): run each query twice and compare
    # result digests; raises NondeterministicResultError on mismatch.
    determinism_check: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_DETERMINISM_CHECK", False))
    # Observability (obs/): ambient tracing for EVERY query.  Off by
    # default — the disabled tracer costs one attribute check per
    # instrumented site and adds no synchronizing call; PROFILE
    # force-enables it for its one query regardless of this flag.
    trace: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_TRACE", False))
    # PROFILE granularity: wait for the card after each operator
    # (torch.cuda.synchronize) so per-op spans carry device-inclusive
    # time.  Off, the dispatch stream stays async (what steady-state
    # fused replay runs) and the CUDA session reports device time as ONE
    # per-replay aggregate span — per-op numbers are then host dispatch
    # times and are labeled as such.
    profile_sync_each_op: bool = dataclasses.field(
        default_factory=lambda: _env_bool("CAPS_TPU_PROFILE_SYNC", True))

    def bucket_for(self, n: int) -> int:
        for b in self.bucket_sizes:
            if n <= b:
                return b
        # Beyond the largest bucket: round up to the next power of two.
        b = self.bucket_sizes[-1]
        while b < n:
            b *= 2
        return b


DEFAULT_CONFIG = EngineConfig()
