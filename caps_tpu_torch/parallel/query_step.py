"""Sharded query execution steps over a device mesh.

The counterpart of ``caps_tpu/parallel/query_step.py``: the graph's edge
table is sharded over the mesh; node-indexed frontier vectors combine
with ``global_sum``.  The flagship step is the 2-hop friend-of-friend
count in aggregate-pushdown form — per-hop path counts propagate as dense
node vectors:

    cnt1[v] = Σ_{edges (u,v)} seed(u)          (segment-sum, psum)
    paths   = Σ_{edges (b,c)} cnt1[b]          (gather, psum)

Each ``shard_map`` body of the JAX package is a sequence of per-shard
stages here, split at its collectives (``parallel/collectives.py``).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from caps_tpu_torch.parallel.collectives import (
    broadcast_concat, exchange_by_shard, global_sum, ring_shift, shard_blocks,
    shard_of,
)


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int
                 ) -> torch.Tensor:
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg.long(), vals)


def two_hop_count_kernel(name_codes, edge_src: Sequence[torch.Tensor],
                         edge_dst: Sequence[torch.Tensor],
                         edge_ok: Sequence[torch.Tensor], seed_code, *,
                         n_nodes: int, devices):
    """The per-shard stages: ``edge_*`` are the shards' edge blocks,
    ``name_codes`` the replicated node property vector (one copy per
    shard's device)."""
    n = len(edge_src)
    local_cnt1 = []
    for s in range(n):
        codes = name_codes[s]
        is_seed = edge_ok[s] & (codes[edge_src[s].long()] == seed_code)
        local_cnt1.append(_segment_sum(is_seed.to(torch.int32), edge_dst[s],
                                       n_nodes))
    cnt1 = global_sum(local_cnt1, devices)          # frontier vector
    local_cnt2 = []
    for s in range(n):
        hop2 = torch.where(edge_ok[s], cnt1[s][edge_src[s].long()],
                           torch.zeros((), dtype=cnt1[s].dtype,
                                       device=cnt1[s].device))
        local_cnt2.append(_segment_sum(hop2, edge_dst[s], n_nodes))
    cnt2 = global_sum(local_cnt2, devices)
    total = cnt2[0].sum()
    return total, cnt2[0]


def make_sharded_two_hop(mesh, n_nodes: int):
    """The sharded 2-hop step for a mesh: edges sharded over the mesh,
    node vector replicated, outputs on the lead device."""
    devices = mesh.shard_devices

    def step(name_codes, edge_src, edge_dst, edge_ok, seed_code):
        codes = [name_codes.to(d) for d in devices]
        return two_hop_count_kernel(
            codes, shard_blocks(edge_src, mesh), shard_blocks(edge_dst, mesh),
            shard_blocks(edge_ok, mesh), seed_code, n_nodes=n_nodes,
            devices=devices)
    return step


def collectives_smoke_kernel(xs: List[torch.Tensor], *, n_shards: int,
                             devices):
    """Exercises every collective the engine uses — all_to_all radix
    exchange, ppermute ring shift, all_gather broadcast, psum — in one
    staged body."""
    dests = [shard_of(x, n_shards) for x in xs]
    exchanged = exchange_by_shard(xs, dests, n_shards, xs[0].shape[0],
                                  devices)
    shifted = ring_shift([e.sum(dim=0) for e in exchanged], 1, devices)
    gathered = broadcast_concat([x[:4] for x in xs], devices)
    parts = [x.sum() + sh.sum() + g.sum()
             for x, sh, g in zip(xs, shifted, gathered)]
    return global_sum(parts, devices)[0]


def make_collectives_smoke(mesh):
    devices = mesh.shard_devices

    def step(x):
        return collectives_smoke_kernel(shard_blocks(x, mesh),
                                        n_shards=mesh.size, devices=devices)
    return step
