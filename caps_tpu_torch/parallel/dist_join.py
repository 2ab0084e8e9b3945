"""Hand-scheduled distributed joins over 1-D and 2-D device meshes.

The counterpart of ``caps_tpu/parallel/dist_join.py``: the two
strategies the reference inherits from Spark, scheduled by hand:

* **Radix-partition exchange join** (Spark's shuffle-hash/sort-merge
  join): both sides bucket rows by ``abs(key) mod n_shards`` and one
  all_to_all delivers bucket *i* to shard *i*; each shard then
  sort-merge joins only its hash partition.  Each row crosses between
  shards once.

  **Surgical skew salting**: a HOT-KEY set (detected by the caller from
  a host-side key sample) marks the keys whose frequency would overload
  one shard.  Probe rows of hot keys spread round-robin over ``salt``
  shards; ONLY hot build rows replicate into the extra ``salt-1``
  sub-buckets (exchanged at a smaller ``hot_bin_cap``).

* **Broadcast join** (Spark's auto-broadcast): a small build side is
  gathered to every shard; the probe side never moves.  Phase 1
  gathers the keys and sorts them once per shard; phase 2 reuses those
  probes and gathers the columns.

Both run as two phases, as in the JAX package: phase 1 exchanges rows
and returns per-shard match counts plus overflow counters — the caller
doubles the bin capacity and retries on overflow; phase 2 expands the
matches into output rows at a caller-chosen per-shard capacity through
the expand-positions kernel (``ops/expand.py
join_expand_via_positions``, the single-card join's expansion).  The
exchanged partitions and each shard's probe stay with their shards
between the phases (the JAX package's two programs probe twice).

Each JAX ``shard_map`` body is a sequence of per-shard stages here,
split at its collectives (``parallel/collectives.py``).  The inputs are
each shard's resident blocks (a row-resident table's, or a whole
table's rows split for the stage), one list entry per shard, and each
shard's output stays on its shard, as the JAX package places a join's
row indices row-sharded.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from caps_tpu_torch.parallel.collectives import (
    bin_index, bin_positions, broadcast_concat, exchange_binned, global_sum,
    pmax, salted_dest,
)

# Join-key sentinels (backends/cuda/kernels.py): nulls never match.
_L_NULL = -(2 ** 63) + 1
_R_NULL = -(2 ** 63) + 2


def _is_hot(key: torch.Tensor, hot_keys: torch.Tensor) -> torch.Tensor:
    """Membership of each key in the sorted hot-key set (padded with the
    int64 maximum, which the sentinels never equal)."""
    if hot_keys.shape[0] == 0:
        return torch.zeros(key.shape, dtype=torch.bool, device=key.device)
    pos = torch.searchsorted(hot_keys, key).clamp(0, hot_keys.shape[0] - 1)
    return hot_keys[pos] == key


def _off_home(dest: torch.Tensor, me: int, n_shards: int) -> torch.Tensor:
    """Count of rows bound for another shard (live, in range)."""
    return ((dest != me) & (dest < n_shards)).sum()


def _pack(arrs: Sequence[torch.Tensor]):
    """(packed, layout): the 1-D arrays of each dtype stacked into one
    (rows, k) matrix, so a shard bins and exchanges one tensor per dtype
    instead of one per column; arrays with trailing dims (list columns)
    stay alone.  ``layout`` maps each packed tensor back to the
    positions of its columns (an int for one left alone)."""
    groups: Dict[torch.dtype, List[int]] = {}
    alone: List[int] = []
    for i, a in enumerate(arrs):
        if a.dim() == 1:
            groups.setdefault(a.dtype, []).append(i)
        else:
            alone.append(i)
    packed = [torch.stack([arrs[i] for i in idx], dim=1)
              for idx in groups.values()]
    return packed + [arrs[i] for i in alone], \
        list(groups.values()) + alone


def _unpack(packed: Sequence[torch.Tensor], layout, n_cols: int
            ) -> List[torch.Tensor]:
    """The columns :func:`_pack` packed, in their order, contiguous."""
    out: List[torch.Tensor] = [None] * n_cols
    for p, lay in zip(packed, layout):
        if isinstance(lay, int):
            out[lay] = p
        else:
            for c, i in enumerate(lay):
                out[i] = p[:, c].contiguous()
    return out


def _where_key(ok: torch.Tensor, key: torch.Tensor, sentinel: int):
    return torch.where(ok, key, torch.full_like(key, sentinel))


@dataclasses.dataclass
class Phase1:
    """Phase 1's per-shard outputs (the received partitions, packed as
    :func:`_pack` lays out ``[key, ok] + arrays``, and their probe
    counts) and its mesh-wide scalars (device tensors)."""
    lok: List[torch.Tensor]
    counts: List[torch.Tensor]
    lo: List[torch.Tensor]
    perm: List[torch.Tensor]
    rok: List[torch.Tensor]
    l_recv: List[List[torch.Tensor]]
    r_recv: List[List[torch.Tensor]]
    l_layout: list
    r_layout: list
    n_l: int
    n_r: int
    max_total: torch.Tensor
    max_left: torch.Tensor
    dropped: torch.Tensor
    sent_l: torch.Tensor
    sent_r: torch.Tensor


def _probe_partition(rk, rok, lk, lok):
    """Local sort-merge count of one shard's received partitions (keys
    of dead rows fold to the never-matching sentinels)."""
    rk = _where_key(rok, rk, _R_NULL)
    rk_sorted, perm = torch.sort(rk, stable=True)
    lk = _where_key(lok, lk, _L_NULL)
    lo = torch.searchsorted(rk_sorted, lk, right=False)
    hi = torch.searchsorted(rk_sorted, lk, right=True)
    counts = torch.where(lok, hi - lo, torch.zeros_like(lo))
    return counts, lo, perm


def _exchange_packed(packed, flats, n, cap, devices):
    """Each shard's packed tensors binned and exchanged (``packed[s]``:
    shard ``s``'s, one layout on every shard): per shard, the received
    (n * cap, ...) rows of each."""
    out = [[] for _ in range(n)]
    for j in range(len(packed[0])):
        fill = False if packed[0][j].dtype == torch.bool else 0
        got = exchange_binned([p[j] for p in packed], flats, n, cap,
                              devices, fill)
        for s in range(n):
            out[s].append(got[s])
    return out


def radix_join_phase1(mesh, hot_keys: torch.Tensor, lk, lok, rk, rok,
                      l_arrs: Sequence[Sequence[torch.Tensor]],
                      r_arrs: Sequence[Sequence[torch.Tensor]],
                      bin_cap: int, salt: int, hot_bin_cap: int) -> Phase1:
    """Exchange both sides, sort each shard's received build partition,
    count matches per received probe row.  Every argument but
    ``hot_keys`` is a list with one entry per shard: the shard's keys,
    live masks and per-row tensors (its blocks).  ``hot_keys`` (sorted,
    padded) drives surgical salting; with ``salt == 1`` it is ignored.
    A row's key and validity ride its side's exchange with its columns
    (a dead slot's key is never read: the probe folds it to the
    sentinel)."""
    n = mesh.size
    devices = mesh.shard_devices
    hot = [hot_keys.to(d) for d in devices]

    # probe side: one exchange; ONLY hot keys round-robin over the salt
    # sub-buckets, everything else goes straight home
    flats, drops, sent_l = [], [], []
    for s in range(n):
        if salt > 1:
            sid = torch.where(
                _is_hot(lk[s], hot[s]),
                (torch.arange(lk[s].shape[0], device=devices[s])
                 % salt).to(torch.int32),
                torch.zeros((), dtype=torch.int32, device=devices[s]))
        else:
            sid = None
        dest = salted_dest(lk[s], n, salt, sid)
        dest, pos, drop = bin_positions(dest, lok[s], n, bin_cap)
        flats.append(bin_index(dest, pos, n, bin_cap))
        drops.append(drop)
        sent_l.append(_off_home(dest, s, n))
    l_packed = [_pack([lk[s], lok[s]] + list(l_arrs[s])) for s in range(n)]
    l_layout = l_packed[0][1]
    l_recv = [[t.reshape((-1,) + tuple(t.shape[2:])) for t in got]
              for got in _exchange_packed([p for p, _ in l_packed], flats,
                                          n, bin_cap, devices)]

    # build side: copy 0 carries every row; copies 1..salt-1 carry ONLY
    # hot rows (smaller bins — the surgical part)
    hot_r = [_is_hot(rk[s], hot[s]) for s in range(n)] if salt > 1 \
        else None
    r_parts = [[] for _ in range(n)]
    sent_r = []
    r_layout = None
    for c in range(max(salt, 1)):
        cap_c = bin_cap if c == 0 else hot_bin_cap
        okb = rok if c == 0 else [o & h for o, h in zip(rok, hot_r)]
        flats_r = []
        for s in range(n):
            sid = torch.full(rk[s].shape, c, dtype=torch.int32,
                             device=devices[s])
            dest = salted_dest(rk[s], n, salt, sid)
            dest, pos, drop = bin_positions(dest, okb[s], n, cap_c)
            drops.append(drop)
            sent_r.append(_off_home(dest, s, n))
            flats_r.append(bin_index(dest, pos, n, cap_c))
        r_packed = [_pack([rk[s], okb[s]] + list(r_arrs[s]))
                    for s in range(n)]
        r_layout = r_packed[0][1]
        got = _exchange_packed([p for p, _ in r_packed], flats_r, n, cap_c,
                               devices)
        for s in range(n):
            r_parts[s].append(got[s])
    r_recv = [[torch.cat([part[j] for part in r_parts[s]], dim=1).reshape(
        (-1,) + tuple(r_parts[s][0][j].shape[2:]))
        for j in range(len(r_parts[s][0]))] for s in range(n)]

    lok_out, counts_out, lo_out, perm_out, rok_out = [], [], [], [], []
    totals, lefts = [], []
    n_l, n_r = 2 + len(l_arrs[0]), 2 + len(r_arrs[0])
    for s in range(n):
        lk_s, lok_s = _unpack(l_recv[s], l_layout, n_l)[:2]
        rk_s, rok_s = _unpack(r_recv[s], r_layout, n_r)[:2]
        counts, lo, perm = _probe_partition(rk_s, rok_s, lk_s, lok_s)
        totals.append(counts.sum())
        lefts.append((counts + (lok_s & (counts == 0)).to(
            counts.dtype)).sum())
        lok_out.append(lok_s)
        counts_out.append(counts)
        lo_out.append(lo)
        perm_out.append(perm)
        rok_out.append(rok_s)
    lead = devices[:1]
    return Phase1(
        lok_out, counts_out, lo_out, perm_out, rok_out, l_recv, r_recv,
        l_layout, r_layout, n_l, n_r,
        max_total=pmax(totals, lead)[0], max_left=pmax(lefts, lead)[0],
        dropped=global_sum(drops, lead)[0],
        sent_l=global_sum(sent_l, lead)[0],
        sent_r=global_sum(sent_r, lead)[0])


def expand_matches(counts, lo, perm, lok, rok, out_cap_dev: int,
                   left_join: bool):
    """Segmented expansion of per-probe-row match counts into output row
    index pairs in plain PyTorch — the JAX package's ``_expand_matches``
    (the reference phase 2's :func:`_expand_shard` is held to it)."""
    matched = counts > 0
    eff = (torch.where(lok & ~matched, torch.ones_like(counts), counts)
           if left_join else counts)
    offsets = torch.cumsum(eff, 0)
    total = offsets[-1] if eff.shape[0] > 0 else torch.zeros(
        (), dtype=torch.int64, device=counts.device)
    t = torch.arange(out_cap_dev, device=counts.device)
    l_idx = torch.searchsorted(offsets, t, right=True).clamp(
        0, counts.shape[0] - 1)
    seg_start = torch.where(l_idx > 0, offsets[(l_idx - 1).clamp(min=0)],
                            torch.zeros_like(l_idx))
    r_pos = (lo[l_idx] + (t - seg_start)).clamp(0, perm.shape[0] - 1)
    r_idx = perm[r_pos]
    out_valid = t < total
    r_matched = out_valid & matched[l_idx]
    return l_idx, r_idx, out_valid & lok[l_idx], r_matched & rok[r_idx]


def _expand_shard(counts, lo, perm, lok, rok, out_cap_dev: int,
                  left_join: bool):
    """One shard's phase-2 expansion through the expand-positions kernel:
    (l_idx, r_idx, l_valid, r_valid), equal to :func:`expand_matches` on
    every valid row."""
    from caps_tpu_torch import ops as OPS
    l_idx, r_idx, out_valid, r_matched = OPS.join_expand_via_positions(
        counts, lo, perm, lok, out_cap_dev, left_join)
    l_idx = l_idx.long()
    r_idx = r_idx.long()
    return (l_idx, r_idx, out_valid & lok[l_idx],
            r_matched & rok[r_idx])


def radix_join_phase2(mesh, p1: Phase1, out_cap_dev: int, left_join: bool):
    """Expand each shard's matches into ``out_cap_dev`` output rows;
    returns per shard (l_valid, r_valid, left columns, right columns),
    each on its shard."""
    lv, rv, l_out, r_out = [], [], [], []
    for s in range(mesh.size):
        l_idx, r_idx, l_valid, r_valid = _expand_shard(
            p1.counts[s], p1.lo[s], p1.perm[s], p1.lok[s], p1.rok[s],
            out_cap_dev, left_join)
        lv.append(l_valid)
        rv.append(r_valid)
        l_out.append([a[l_idx] for a in p1.l_recv[s]])
        r_out.append([a[r_idx] for a in p1.r_recv[s]])
    return _per_shard(lv, rv, l_out, r_out, p1.l_layout, p1.r_layout,
                      p1.n_l, p1.n_r)


def _per_shard(lv, rv, l_out, r_out, l_layout, r_layout, n_l, n_r):
    """Each shard's (l_valid, r_valid, left columns, right columns), the
    packed columns unpacked (the key and validity columns dropped)."""
    return [(lv[s], rv[s], _unpack(l_out[s], l_layout, n_l)[2:],
             _unpack(r_out[s], r_layout, n_r)[2:]) for s in range(len(lv))]


@dataclasses.dataclass
class BroadcastPhase1:
    """The broadcast join's phase-1 state: each shard's probe of the
    gathered build side (match counts, first matches, the build sort
    permutation, the gathered build validity) and the mesh-wide scalars
    (device tensors): the largest per-shard output size and the live
    build-row count."""
    counts: List[torch.Tensor]
    lo: List[torch.Tensor]
    perm: List[torch.Tensor]
    rok_all: List[torch.Tensor]
    max_total: torch.Tensor
    live_r: torch.Tensor


def broadcast_join_phase1(mesh, lk, lok, rk, rok,
                          left_join: bool) -> BroadcastPhase1:
    """Gather the (small) build side's keys to every shard once, sort
    them and count each local probe row's matches (every argument but
    ``left_join`` one entry per shard)."""
    n = mesh.size
    devices = mesh.shard_devices
    rk_all = broadcast_concat([_where_key(o, k, _R_NULL)
                               for o, k in zip(rok, rk)], devices)
    rok_all = broadcast_concat(rok, devices)
    counts_out, lo_out, perm_out, effs = [], [], [], []
    for s in range(n):
        counts, lo, perm = _probe_partition(rk_all[s], rok_all[s], lk[s],
                                            lok[s])
        eff = (torch.where(lok[s] & (counts == 0), torch.ones_like(counts),
                           counts) if left_join else counts)
        counts_out.append(counts)
        lo_out.append(lo)
        perm_out.append(perm)
        effs.append(eff.sum())
    lead = devices[:1]
    return BroadcastPhase1(
        counts_out, lo_out, perm_out, rok_all,
        max_total=pmax(effs, lead)[0],
        live_r=global_sum([o.sum() for o in rok], lead)[0])


def broadcast_join_phase2(mesh, p1: BroadcastPhase1, lk, lok, rk, rok,
                          l_arrs: Sequence[Sequence[torch.Tensor]],
                          r_arrs: Sequence[Sequence[torch.Tensor]],
                          out_cap_dev: int, left_join: bool):
    """Gather the build side's columns and expand each shard's matches
    (phase 1's probes) into ``out_cap_dev`` output rows; returns per
    shard (l_valid, r_valid, left columns, right columns), each on its
    shard.  The probe side never moves."""
    n = mesh.size
    devices = mesh.shard_devices
    l_packed = [_pack([lk[s], lok[s]] + list(l_arrs[s])) for s in range(n)]
    r_packed = [_pack([rk[s], rok[s]] + list(r_arrs[s])) for s in range(n)]
    l_layout, r_layout = l_packed[0][1], r_packed[0][1]
    r_all = [broadcast_concat([p[j] for p, _ in r_packed], devices)
             for j in range(len(r_packed[0][0]))]
    lv, rv, l_out, r_out = [], [], [], []
    for s in range(n):
        l_idx, r_idx, l_valid, r_valid = _expand_shard(
            p1.counts[s], p1.lo[s], p1.perm[s], lok[s], p1.rok_all[s],
            out_cap_dev, left_join)
        lv.append(l_valid)
        rv.append(r_valid)
        l_out.append([a[l_idx] for a in l_packed[s][0]])
        r_out.append([a[s][r_idx] for a in r_all])
    return _per_shard(lv, rv, l_out, r_out, l_layout, r_layout,
                      2 + len(l_arrs[0]), 2 + len(r_arrs[0]))
