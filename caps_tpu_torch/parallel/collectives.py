"""Collective primitives for sharded query execution.

The counterpart of ``caps_tpu/parallel/collectives.py``, the engine's
"shuffle service" (SURVEY.md §5.8).  The JAX package calls ``jax.lax``
collectives inside ``shard_map`` bodies; here a body is split at its
collectives into stages that run once per shard, and these functions map
the list of per-shard tensors one stage produced to the list the next
stage reads, copying across cards where two shards' devices differ:

    exchange_binned     all_to_all of (n, bin_cap, ...) bins — the radix
                        repartition before joins
    ring_shift          ppermute rotation — the ring schedule for k-hop
                        frontier expansion against resident shards
    broadcast_concat    all_gather of a small build side — broadcast join
    global_sum / pmax / pmin    all-reduces — global aggregates

The per-shard helpers (``shard_of``, ``salted_dest``, ``bin_positions``)
compute one shard's destinations.  A stage reads each shard's resident
block of a row-resident table (``backends/cuda/sharded.py``): a list of
per-shard tensors.  A whole table is placed or split once where a stage
begins, not inside it; ``shard_blocks`` cuts a whole node vector (a
frontier, a mask) into the shards' node blocks.

``note_collective`` counts every call when it RUNS (the JAX package's
wrappers run once per trace, so it counts per compile): the counters
``collectives.<op>.calls`` / ``.traced_bytes`` keep their names.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from caps_tpu_torch.obs import active_tracer, global_registry


def note_collective(op: str, *arrays, scale: int = 1, **attrs) -> None:
    """Observability hook for one collective run: ``arrays`` are the
    tensors (or lists of per-shard tensors) it moves; ``scale``
    multiplies the byte count where one call stands for several
    rotations."""
    nbytes = 0
    for a in arrays:
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            nbytes += int(t.numel()) * t.element_size()
    nbytes *= scale
    reg = global_registry()
    reg.counter(f"collectives.{op}.calls").inc()
    reg.counter(f"collectives.{op}.traced_bytes").inc(nbytes)
    tr = active_tracer()
    if tr.enabled:
        tr.event(f"collective.{op}", kind="collective", bytes=nbytes,
                 when="run", **attrs)


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def shard_of(key: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Destination shard for a join/group key (dense ids: range
    partition by modulo — floor modulo, as ``jnp``'s ``%``)."""
    return (key % n_shards).to(torch.int32)


def salted_dest(key: torch.Tensor, n_shards: int, salt: int,
                salt_id) -> torch.Tensor:
    """Destination shard of a key: ``abs(key) % n`` (``abs`` of the
    smallest int64 stays negative and the floor modulo folds it, as in
    ``jnp``).  With salting, sub-bucket ``s`` of a key lands
    ``s * (n // salt)`` shards away, so the ``salt`` sub-buckets of one
    key hit ``salt`` distinct shards."""
    base = (torch.abs(key) % n_shards).to(torch.int32)
    if salt > 1 and salt_id is not None:
        stride = max(1, n_shards // salt)
        base = (base + salt_id.to(torch.int32) * stride) % n_shards
    return base


def bin_positions(dest: torch.Tensor, ok: torch.Tensor, n_shards: int,
                  bin_cap: int):
    """Within-bin position per row for a binned exchange; rows past
    ``bin_cap`` in their bin are counted in ``dropped`` and get the
    out-of-range destination ``n_shards`` (callers retry with a bigger
    ``bin_cap`` while ``dropped > 0``).  Returns (dest, row_pos,
    dropped) with ``dropped`` a device scalar.

    One 1-D running count per destination (the JAX package takes a
    cumsum down an (rows, n_shards) one-hot; on the card a scan down
    the outer dimension of a 2-D tensor runs one thread per column)."""
    dest = torch.where(ok, dest, torch.full_like(dest, n_shards))
    row_pos = torch.zeros(dest.shape, dtype=torch.int32, device=dest.device)
    for d in range(n_shards):
        hit = dest == d
        run = torch.cumsum(hit.to(torch.int32), 0, dtype=torch.int32) - 1
        row_pos = torch.where(hit, run, row_pos)
    sent = ok & (row_pos < bin_cap)
    dropped = (ok & ~sent).sum()
    dest = torch.where(sent, dest, torch.full_like(dest, n_shards))
    return dest, row_pos, dropped


_SPARE = 1024


def bin_index(dest: torch.Tensor, row_pos: torch.Tensor, n_shards: int,
              bin_cap: int) -> torch.Tensor:
    """Each row's slot in a shard's flattened (n_shards * bin_cap) bins
    (:func:`bin_positions`' outputs); a row with an out-of-range
    destination gets one of ``_SPARE`` spare slots past the bins, cut
    off after the scatter (no host read; spread, so the dropped rows of
    a padded table do not all store to one address).  One index serves
    every array the shard exchanges."""
    slots = n_shards * bin_cap
    flat = dest.long() * bin_cap + row_pos.long().clamp(0, bin_cap - 1)
    spare = slots + torch.arange(flat.shape[0], device=flat.device) % _SPARE
    return torch.where(dest < n_shards, flat, spare)


def bin_rows(arr: torch.Tensor, flat: torch.Tensor, n_shards: int,
             bin_cap: int, fill) -> torch.Tensor:
    """One shard's rows scattered by :func:`bin_index` into
    (n_shards, bin_cap, *trailing) bins, the rest ``fill``."""
    slots = n_shards * bin_cap
    binned = torch.full((slots + _SPARE,) + tuple(arr.shape[1:]), fill,
                        dtype=arr.dtype, device=arr.device)
    binned.index_copy_(0, flat, arr)
    return binned[:slots].reshape((n_shards, bin_cap) + tuple(arr.shape[1:]))


def all_to_all(binned: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Shard ``i`` receives bin ``i`` of every shard, stacked in shard
    order: (n_shards, bin_cap, *trailing) per shard."""
    n = len(binned)
    return [torch.stack([_to(binned[j][i], devices[i]) for j in range(n)])
            for i in range(n)]


def exchange_binned(arrs: Sequence[torch.Tensor],
                    flats: Sequence[torch.Tensor], n_shards: int,
                    bin_cap: int, devices: Sequence[torch.device],
                    fill) -> List[torch.Tensor]:
    """Scatter each shard's rows into its bins (``flats``: each shard's
    :func:`bin_index`) and all_to_all them: shard ``i`` receives every
    shard's bin ``i`` → (n_shards, bin_cap, *trailing).  Trailing dims
    carry matrix payloads (list columns, packed columns)."""
    binned = [bin_rows(a, f, n_shards, bin_cap, fill)
              for a, f in zip(arrs, flats)]
    note_collective("all_to_all", binned)
    return all_to_all(binned, devices)


def exchange_by_shard(data: Sequence[torch.Tensor],
                      dests: Sequence[torch.Tensor], n_shards: int,
                      capacity: int,
                      devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """All-to-all exchange with fixed-capacity bins: returns each shard's
    received (n_shards, capacity) buckets; slots beyond a bin's fill hold
    zeros."""
    flats = []
    for x, d in zip(data, dests):
        ok = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        d2, p, _ = bin_positions(d, ok, n_shards, capacity)
        flats.append(bin_index(d2, p, n_shards, capacity))
    return exchange_binned(data, flats, n_shards, capacity, devices, 0)


def ring_shift(xs: Sequence[torch.Tensor], offset: int = 1,
               devices: Sequence[torch.device] = None) -> List[torch.Tensor]:
    """Rotate blocks ``offset`` steps around the ring (ppermute): shard
    ``(i + offset) % n`` receives shard ``i``'s block."""
    n = len(xs)
    devices = devices or [x.device for x in xs]
    note_collective("ppermute", list(xs))
    return [_to(xs[(i - offset) % n], devices[i]) for i in range(n)]


def broadcast_concat(xs: Sequence[torch.Tensor],
                     devices: Sequence[torch.device] = None
                     ) -> List[torch.Tensor]:
    """all_gather (tiled): every shard receives the concatenation of all
    shards' blocks (broadcast-hash join analog of Spark's
    TorrentBroadcast)."""
    devices = devices or [x.device for x in xs]
    note_collective("all_gather", list(xs))
    out = []
    for d in devices:
        out.append(torch.cat([_to(x, d) for x in xs]))
    return out


def _identity(like: torch.Tensor, op: str) -> torch.Tensor:
    """The fold's start for ``min`` / ``max``: the dtype's top (bottom)
    value, ±inf for floats."""
    if like.dtype.is_floating_point:
        v = float("inf") if op == "min" else float("-inf")
    elif like.dtype == torch.bool:
        v = op == "min"
    else:
        info = torch.iinfo(like.dtype)
        v = info.max if op == "min" else info.min
    return torch.full_like(like, v)


def _reduce(xs: Sequence[torch.Tensor], op: str, name: str,
            devices) -> List[torch.Tensor]:
    """Fold the shards' tensors in shard order, as XLA's all-reduces do
    on its CPU devices: sums add from shard 0 (int32 wraps); min and max
    start from the identity and take a shard's value only where it
    compares strictly below (above) the running one.  So a NaN never
    wins (a slot that is NaN on every shard gives the identity), and of
    -0.0 and +0.0 the earlier shard's sign stays."""
    devices = devices or [x.device for x in xs]
    note_collective(name, list(xs))
    if op == "sum":
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + _to(x, acc.device)
    else:
        acc = _identity(xs[0], op)
        for x in xs:
            x = _to(x, acc.device)
            acc = torch.where(x < acc if op == "min" else x > acc, x, acc)
    return [_to(acc, d) for d in devices]


def global_sum(xs: Sequence[torch.Tensor],
               devices: Sequence[torch.device] = None) -> List[torch.Tensor]:
    """psum: every shard receives the elementwise sum over shards."""
    return _reduce(xs, "sum", "psum", devices)


def pmax(xs: Sequence[torch.Tensor],
         devices: Sequence[torch.device] = None) -> List[torch.Tensor]:
    return _reduce(xs, "max", "pmax", devices)


def pmin(xs: Sequence[torch.Tensor],
         devices: Sequence[torch.device] = None) -> List[torch.Tensor]:
    return _reduce(xs, "min", "pmin", devices)


def shard_blocks(t: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Each shard's block of ``t``'s rows (the row count must divide
    over the shards): a view where the shard's device is ``t``'s, a copy
    otherwise."""
    n = mesh.size
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not divide over {n} shards")
    b = t.shape[0] // n
    return [_to(t[i * b:(i + 1) * b], d)
            for i, d in enumerate(mesh.shard_devices)]
