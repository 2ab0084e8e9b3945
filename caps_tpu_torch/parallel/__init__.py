"""Distributed execution: device mesh, collectives, sharded query steps.

The counterpart of ``caps_tpu/parallel``: tables shard over a
:class:`~caps_tpu_torch.parallel.mesh.Mesh`; repartitioning is an
all_to_all of per-shard bins, broadcast joins gather, ring schedules
rotate frontier blocks, global aggregates all-reduce
(``collectives.py``).  One controller drives every shard, as in the JAX
package: each ``shard_map`` body there is a sequence of per-shard stages
here, split at its collectives.  A table's rows reside on their shards'
devices (``backends/cuda/sharded.py``); each stage takes the per-shard
blocks.

``caps_tpu/parallel/compat.py`` bridges two JAX ``shard_map`` APIs and
has no counterpart here.
"""
