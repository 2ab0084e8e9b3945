"""graph500-s20: the generator and the plain reference.

The edge list is ``rmat_edges`` and ``canonical_edges`` of
``caps_tpu_torch/datasets/graph500.py``, copied and drawn on the card
with a ``torch.Generator`` (numpy's draws took about 5 s of every run's
set-up): the Graph500 RMAT recursion with (A, B, C) = (0.57, 0.19,
0.19) and the vertex permutation, then self-loops dropped, undirected
duplicates removed and each edge oriented from its lower id to its
higher.  The graph comes from the configuration's ``graph_seed``; the
run's seed orders its edges.  The same arrays go to the program and to
the reference.

The reference counts triangles exactly in plain PyTorch: each edge
oriented from the endpoint of lower (degree, id) rank to the higher,
and for every edge (u, v) and every w with u -> w, the edge v -> w
looked up among the sorted edge keys; each triangle is found once.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

A, B, C = 0.57, 0.19, 0.19

# pairs (edge, out-neighbour) looked up at a time
CHUNK = 1 << 25


def rmat_edges(scale: int, edgefactor: int, seed: int, device: str):
    """The Graph500 RMAT recursion, drawn on ``device`` in a few large
    calls: each of the ``scale`` bits of (src, dst) from the 2x2 RMAT
    distribution, then the vertex permutation."""
    n_edges = edgefactor << scale
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    src = torch.zeros(n_edges, dtype=torch.int64, device=device)
    dst = torch.zeros(n_edges, dtype=torch.int64, device=device)
    ab = A + B
    c_norm = C / (1.0 - ab)
    a_norm = A / ab
    for level in range(scale):
        ii = torch.rand(n_edges, generator=g, device=device) > ab
        jj = torch.rand(n_edges, generator=g, device=device) > torch.where(
            ii, c_norm, a_norm)
        src |= ii.to(torch.int64) << level
        dst |= jj.to(torch.int64) << level
    perm = torch.randperm(1 << scale, generator=g, device=device)
    return perm[src], perm[dst]


def canonical_edges(scale: int, edgefactor: int, seed: int, device: str):
    """Self-loops dropped, undirected duplicates removed, each edge
    oriented from its lower id to its higher, sorted by (lo, hi)."""
    src, dst = rmat_edges(scale, edgefactor, seed, device)
    lo, hi = torch.minimum(src, dst), torch.maximum(src, dst)
    key = torch.unique(((lo << scale) | hi)[lo != hi])
    return ((key >> scale).cpu().numpy(),
            (key & ((1 << scale) - 1)).cpu().numpy())


def make(seed: int, cfg: Dict[str, Any], device: str) -> Dict[str, Any]:
    """One graph for every seed (drawn from the configuration's
    ``graph_seed``), its edges handed over in an order drawn from
    ``seed``: every run counts the same triangles, so runs differ by the
    order of their input and not by their work."""
    scale, ef = int(cfg["scale"]), int(cfg["edgefactor"])
    lo, hi = canonical_edges(scale, ef, int(cfg["graph_seed"]), device)
    g = torch.Generator(device="cpu").manual_seed(seed % (1 << 63))
    order = torch.randperm(lo.shape[0], generator=g).numpy()
    lo, hi = lo[order], hi[order]
    n = 1 << scale
    nodes = {"V": {"_id": np.arange(n, dtype=np.int64)}}
    rels = {"E": {"_id": np.arange(n, n + lo.shape[0], dtype=np.int64),
                  "_src": lo, "_tgt": hi}}
    return {"nodes": nodes, "rels": rels,
            "info": {"vertices": n, "edges": int(lo.shape[0])}}


def triangles(lo: torch.Tensor, hi: torch.Tensor, n: int,
              keep: torch.Tensor = None) -> torch.Tensor:
    """Triangles of the undirected simple graph with edges (lo, hi),
    over the edges ``keep`` marks (all by default)."""
    if keep is not None:
        lo, hi = lo[keep], hi[keep]
    dev = lo.device
    total = torch.zeros((), dtype=torch.int64, device=dev)
    if lo.numel() == 0:
        return total
    ids = torch.arange(n, device=dev)
    deg = torch.bincount(lo, minlength=n) + torch.bincount(hi, minlength=n)
    rank = torch.empty_like(ids)
    rank[torch.argsort(deg * n + ids)] = ids
    a, b = rank[lo], rank[hi]
    key, _ = torch.sort(torch.minimum(a, b) * n + torch.maximum(a, b))
    u, v = key // n, key % n
    out_deg = torch.bincount(u, minlength=n)
    starts = torch.cumsum(out_deg, 0) - out_deg
    reps = out_deg[u]
    cum = torch.cumsum(reps, 0)
    m = key.numel()
    e0 = 0
    while e0 < m:
        base = int(cum[e0 - 1]) if e0 else 0
        e1 = max(e0 + 1, int(torch.searchsorted(
            cum, torch.tensor(base + CHUNK, device=dev), right=True)))
        r = reps[e0:e1]
        edge = torch.repeat_interleave(torch.arange(e0, e1, device=dev), r)
        first = torch.cumsum(r, 0) - r
        within = (torch.arange(edge.numel(), device=dev)
                  - torch.repeat_interleave(first, r))
        w = v[starts[u[edge]] + within]
        q = v[edge] * n + w
        pos = torch.searchsorted(key, q).clamp_(max=m - 1)
        total += (key[pos] == q).sum()
        e0 = e1
    return total


class Reference:
    """``triangles``: the count of the whole graph's triangles."""

    def __init__(self, data: Dict[str, Any], cfg: Dict[str, Any],
                 device: str):
        e = data["rels"]["E"]
        dev = torch.device(device)
        self.lo = torch.as_tensor(e["_src"], device=dev)
        self.hi = torch.as_tensor(e["_tgt"], device=dev)
        self.n = int(data["info"]["vertices"])
        self.seed = int(cfg.get("control_seed", 0))
        self._count = self._estimate = None

    def answer(self, family: Dict[str, Any], params: Dict[str, Any]
               ) -> List[Dict[str, Any]]:
        if family["answer"] != "triangles":
            raise ValueError(f"unknown answer {family['answer']!r}")
        if self._count is None:
            self._count = int(triangles(self.lo, self.hi, self.n))
        return [{"triangles": self._count}]

    def control(self, family: Dict[str, Any], params: Dict[str, Any],
                recorded: Dict[str, Any]) -> List[Dict[str, Any]]:
        """The reference with the guarantee of an exact count broken: an
        estimate from half the edges (each kept with probability 1/2,
        the count of what is left times 8), as approximate counting
        does."""
        if self._estimate is None:
            g = torch.Generator(device="cpu").manual_seed(self.seed)
            keep = (torch.rand(self.lo.numel(), generator=g) < 0.5).to(
                self.lo.device)
            self._estimate = int(triangles(self.lo, self.hi, self.n,
                                           keep)) * 8
        return [{"triangles": self._estimate}]
