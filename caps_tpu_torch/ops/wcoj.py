"""Sorted edge-key primitives of the worst-case-optimal join path.

The counterpart of the part of ``caps_tpu/ops/wcoj.py`` that the
cyclic count (``relational/count_pattern.py`` ``CountCycleOp``) reads.
Everything rides one physical structure:

    key(e) = frm(e) * n + to(e)          (int64; n = node-id domain)

sorted ascending: the parallel edges between a bound pair ``(u, v)``
occupy the key range ``[u*n+v, u*n+v]``, so two binary searches give
their exact multiplicity.  Dead rows fold their key to :data:`PAD_KEY`
(sorts last, matches no probe).

The leapfrog views (``sorted_edges``, ``probe_adj``, ``probe_pair``,
``probe_id``) and the multiway join over them wait for the WCOJ slice
(ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import torch

#: key sentinel for masked-out edges: sorts after every real key (real
#: keys are < n^2 <= 2^52 under the count path's domain guard) and can
#: never equal a probe key.
PAD_KEY = 2 ** 62


def edge_keys(frm: torch.Tensor, to: torch.Tensor, ok: torch.Tensor,
              n: int) -> torch.Tensor:
    """Composite sort keys ``frm*n + to`` (int64), dead or out-of-domain
    rows folded to :data:`PAD_KEY`."""
    k = frm.to(torch.int64) * n + to.to(torch.int64)
    good = ok & (frm >= 0) & (to >= 0) & (frm < n) & (to < n)
    return torch.where(good, k, torch.full_like(k, PAD_KEY))


def multiplicity(keys_sorted: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Multiplicity (int64) of raw composite keys ``q`` in the sorted
    table — the probe CountCycleOp's batched 2-path counting uses."""
    lo = torch.searchsorted(keys_sorted, q)
    hi = torch.searchsorted(keys_sorted, q, right=True)
    return (hi - lo).to(torch.int64)
