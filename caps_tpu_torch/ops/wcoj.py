"""Worst-case-optimal multiway-join primitives over sorted edge keys.

The counterpart of ``caps_tpu/ops/wcoj.py``: the kernel layer of the
multiway join (``relational/wcoj.py`` builds the operator on top) and of
the cyclic count (``relational/count_pattern.py`` ``CountCycleOp``).
Everything rides one physical structure:

    key(e) = frm(e) * n + to(e)          (int64; n = node-id domain)

sorted ascending — one sort per (edge scan, orientation), through the
caller's gated sort (``DeviceTable._sort_perm``: the sort kernel up to
its largest capacity, the stable torch sort above).  The sorted order
gives both leapfrog views at once:

* **adjacency**: the neighbours of ``u`` occupy the contiguous key range
  ``[u*n, (u+1)*n)``, sorted by neighbour id (``probe_adj`` is two
  binary searches, no per-row scan);
* **membership / multiplicity**: the parallel edges between a bound
  pair ``(u, v)`` occupy ``[u*n+v, u*n+v]`` — ``probe_pair`` returns
  their exact multiplicity and start offset, so a closing edge both
  semi-filters candidates (count > 0) and later enumerates each
  parallel edge as its own binding.

The binary searches are ``torch.searchsorted`` (the reference's are
``jnp.searchsorted``, outside any Pallas kernel).  Enumeration inverts
``cumsum(counts)`` through ``ops/expand.py expand_positions``: the
hand-written kernel (K2) for tensors on the card, its plain version for
tensors on the CPU.  Output capacities are size-bucketed by the caller
and validity is an exact live-row prefix.  Dead rows fold their key to
:data:`PAD_KEY` (sorts last, matches no probe).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from caps_tpu_torch.ops.expand import expand_positions

#: key sentinel for masked-out edges and ids: sorts after every real key
#: (real keys are < n^2 <= 2^52 under the domain guards) and can never
#: equal a probe key.
PAD_KEY = 2 ** 62


def edge_keys(frm: torch.Tensor, to: torch.Tensor, ok: torch.Tensor,
              n: int) -> torch.Tensor:
    """Composite sort keys ``frm*n + to`` (int64), dead or out-of-domain
    rows folded to :data:`PAD_KEY`."""
    k = frm.to(torch.int64) * n + to.to(torch.int64)
    good = ok & (frm >= 0) & (to >= 0) & (frm < n) & (to < n)
    return torch.where(good, k, torch.full_like(k, PAD_KEY))


def sorted_edges(frm: torch.Tensor, to: torch.Tensor, ok: torch.Tensor,
                 n: int,
                 sort_perm: Callable[[List[torch.Tensor]], torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys_sorted, perm): the one sorted structure both probes read.
    ``sort_perm`` is the caller's gated sort."""
    keys = edge_keys(frm, to, ok, int(n))
    perm = sort_perm([keys])
    return keys[perm], perm


def sorted_ids(ids: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Masked int64 id keys for a node scan (PAD-folded); the caller
    sorts them through its gated sort like :func:`sorted_edges`."""
    good = ok & (ids >= 0)
    k = ids.to(torch.int64)
    return torch.where(good, k, torch.full_like(k, PAD_KEY))


def probe_adj(keys_sorted: torch.Tensor, u: torch.Tensor, ok: torch.Tensor,
              n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-probe-row (counts, lo) of u's neighbour segment
    ``[u*n, (u+1)*n)`` — two binary searches against the sorted keys."""
    in_dom = ok & (u >= 0) & (u < n)
    base = torch.where(in_dom, u.to(torch.int64),
                       torch.zeros_like(u, dtype=torch.int64)) * n
    lo = torch.searchsorted(keys_sorted, base)
    hi = torch.searchsorted(keys_sorted, base + n)
    counts = torch.where(in_dom, hi - lo, torch.zeros_like(lo))
    return counts, lo


def probe_pair(keys_sorted: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               ok: torch.Tensor, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (multiplicity, lo) of the exact pair key ``u*n + v``:
    multiplicity 0 semi-filters a candidate, multiplicity k enumerates k
    parallel-edge bindings."""
    in_dom = ok & (u >= 0) & (u < n) & (v >= 0) & (v < n)
    q = u.to(torch.int64) * n + v.to(torch.int64)
    q = torch.where(in_dom, q, torch.full_like(q, PAD_KEY - 1))
    lo = torch.searchsorted(keys_sorted, q)
    hi = torch.searchsorted(keys_sorted, q, right=True)
    counts = torch.where(in_dom, hi - lo, torch.zeros_like(lo))
    return counts, lo


def multiplicity(keys_sorted: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Multiplicity (int64) of raw composite keys ``q`` in the sorted
    table — the probe CountCycleOp's batched 2-path counting uses."""
    lo = torch.searchsorted(keys_sorted, q)
    hi = torch.searchsorted(keys_sorted, q, right=True)
    return (hi - lo).to(torch.int64)


def probe_id(ids_sorted: torch.Tensor, cand: torch.Tensor, ok: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-candidate (count, lo) against a sorted node-id table — the
    node-scan membership check (labels and predicates pre-filtered by
    the caller) that doubles as the id -> scan-row lookup through the
    sort permutation."""
    c = cand.to(torch.int64)
    safe = torch.where(ok & (cand >= 0), c, torch.full_like(c, PAD_KEY - 1))
    lo = torch.searchsorted(ids_sorted, safe)
    hi = torch.searchsorted(ids_sorted, safe, right=True)
    counts = torch.where(ok, hi - lo, torch.zeros_like(lo))
    return counts, lo


def _positions(counts: torch.Tensor, lo: torch.Tensor, out_cap: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: (frontier row, position in the sorted keys, validity) of each
    output slot."""
    return expand_positions(counts, lo, out_cap)


def _extend_gather(keys_sorted: torch.Tensor, perm: torch.Tensor,
                   pos: torch.Tensor, ok: torch.Tensor, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate neighbour id + original edge row for expanded slots."""
    pos = pos.long().clamp(0, keys_sorted.shape[0] - 1)
    key = keys_sorted[pos]
    cand = torch.where(ok & (key < PAD_KEY), key % n,
                       torch.zeros_like(key))
    return cand, perm[pos]


def extend(keys_sorted: torch.Tensor, perm: torch.Tensor, u: torch.Tensor,
           valid: torch.Tensor, n: int, out_cap: int, *,
           counts: Optional[torch.Tensor] = None,
           lo: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leapfrog extension: enumerate every (frontier row, incident
    edge) pair along the anchor adjacency.

    Returns ``(l_idx, cand, edge_row, ok)`` — the frontier row each
    output slot came from, the new vertex candidate (the neighbour id,
    read from the sorted key segment), the anchor edge's scan row (the
    relationship binding), and the exact live-prefix validity mask.
    ``counts``/``lo`` take the :func:`probe_adj` results the caller
    already computed to size ``out_cap``."""
    n = int(n)
    if counts is None or lo is None:
        counts, lo = probe_adj(keys_sorted, u, valid, n)
    l_idx, pos, ok = _positions(counts, lo, out_cap)
    cand, edge_row = _extend_gather(keys_sorted, perm, pos, ok, n)
    return l_idx, cand, edge_row, ok


def close(keys_sorted: torch.Tensor, perm: torch.Tensor, u: torch.Tensor,
          v: torch.Tensor, valid: torch.Tensor, n: int, out_cap: int, *,
          counts: Optional[torch.Tensor] = None,
          lo: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Close one edge between two bound vertices: expand each frontier
    row by the pair's parallel-edge multiplicity, binding each edge's
    scan row.  Returns ``(l_idx, edge_row, ok)``; ``counts``/``lo``
    reuse the caller's sizing :func:`probe_pair` like :func:`extend`."""
    n = int(n)
    if counts is None or lo is None:
        counts, lo = probe_pair(keys_sorted, u, v, valid, n)
    l_idx, pos, ok = _positions(counts, lo, out_cap)
    pos = pos.long().clamp(0, perm.shape[0] - 1)
    return l_idx, perm[pos], ok


def adj_total(counts: torch.Tensor) -> torch.Tensor:
    """Total expansion size of one step (the device scalar the caller
    routes through ``backend.consume_rows`` before bucketing)."""
    return counts.sum()
