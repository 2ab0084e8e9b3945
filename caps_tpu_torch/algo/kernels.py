"""Host NumPy kernels: the oracle and the planned ``host`` strategy.

The counterpart of ``caps_tpu/algo/kernels.py``.  Each procedure has one
NumPy implementation operating on the compacted index space (nodes
``0..n-1``, edge endpoint index arrays).  These functions serve two
roles:

* the **oracle** the differential tests and ``chip_smoke.py`` compare
  every device execution against, and
* the planned **host** strategy, when the cost model prices the device
  fixpoint out (tiny graphs) or the graph is empty.  A device fault is
  never answered from here (``algo/op.py``).

They share no code with the torch fixpoint (``algo/fixpoint.py``).
Reductions are sequential scatter-adds in edge order, and the one
float-valued accumulation (PageRank) is quantized to
:data:`SCORE_DECIMALS` on both paths, so cross-path digests compare
equal instead of drifting in the last ulp.

Every kernel returns ``(per-node output array, iterations, converged)``
— the convergence metrics ride the operator's ``op_stats`` entry.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

#: emitted float scores are rounded to this many decimals on both the
#: device and host paths — the cross-backend reproducibility quantum
#: (digests hash the rounded values)
SCORE_DECIMALS = 9

#: distance value for unreachable nodes inside the fixpoint (emitted
#: rows filter these out — BFS/SSSP yield reachable nodes only)
UNREACHED = np.iinfo(np.int64).max


def degree(n: int, src: np.ndarray, tgt: np.ndarray,
           direction: str) -> Tuple[np.ndarray, int, bool]:
    out = np.zeros(n, dtype=np.int64)
    if direction in ("out", "both"):
        np.add.at(out, src, 1)
    if direction in ("in", "both"):
        np.add.at(out, tgt, 1)
    return out, 1, True


def pagerank(n: int, src: np.ndarray, tgt: np.ndarray, damping: float,
             max_iterations: int, tolerance: float
             ) -> Tuple[np.ndarray, int, bool]:
    if n == 0:
        return np.zeros(0, dtype=np.float64), 0, True
    out_deg = np.zeros(n, dtype=np.float64)
    np.add.at(out_deg, src, 1.0)
    r = np.full(n, 1.0 / n, dtype=np.float64)
    base = (1.0 - damping) / n
    it, delta = 0, np.inf
    while it < max_iterations and delta > tolerance:
        contrib = np.where(out_deg > 0, r / np.maximum(out_deg, 1.0), 0.0)
        nxt = np.zeros(n, dtype=np.float64)
        np.add.at(nxt, tgt, contrib[src])
        dangling = float((r * (out_deg == 0)).sum())
        nxt = base + damping * (nxt + dangling / n)
        delta = float(np.abs(nxt - r).sum())
        r = nxt
        it += 1
    return np.round(r, SCORE_DECIMALS), it, delta <= tolerance


def wcc(n: int, src: np.ndarray, tgt: np.ndarray,
        max_iterations: int) -> Tuple[np.ndarray, int, bool]:
    """Min-label propagation over the symmetrized edge list; labels are
    node *indices*, so the caller maps them back to the minimum node id
    of each component."""
    label = np.arange(n, dtype=np.int64)
    it, changed = 0, n > 0 and src.shape[0] > 0
    while it < max_iterations and changed:
        nxt = label.copy()
        np.minimum.at(nxt, tgt, label[src])
        np.minimum.at(nxt, src, label[tgt])
        # pointer jumping: chase one level of indirection per round so
        # long chains converge in O(log n) rounds, not O(n)
        nxt = nxt[nxt]
        changed = bool((nxt != label).any())
        label = nxt
        it += 1
    return label, it, not changed


def bfs(n: int, src: np.ndarray, tgt: np.ndarray, source: int,
        max_depth: int) -> Tuple[np.ndarray, int, bool]:
    """Hop distance from ``source`` along OUTGOING edges; unreached
    nodes hold :data:`UNREACHED`."""
    dist = np.full(n, UNREACHED, dtype=np.int64)
    if not 0 <= source < n:
        return dist, 0, True
    dist[source] = 0
    depth, frontier = 0, True
    while frontier and (max_depth < 0 or depth < max_depth):
        reach = dist[src] != UNREACHED
        # the sentinel is int64 max: select BEFORE the +1 so the dead
        # lanes never compute an overflowing candidate
        cand = np.where(reach, np.where(reach, dist[src], 0) + 1,
                        UNREACHED)
        nxt = dist.copy()
        np.minimum.at(nxt, tgt, cand)
        frontier = bool((nxt != dist).any())
        dist = nxt
        depth += 1
    return dist, depth, not frontier


def sssp(n: int, src: np.ndarray, tgt: np.ndarray, weights: np.ndarray,
         source: int, max_iterations: int
         ) -> Tuple[np.ndarray, int, bool]:
    """Bellman-Ford edge relaxation along outgoing edges; unreached
    nodes hold ``+inf``.  Negative weights are clamped to 0 (shortest
    paths over non-negative weights only)."""
    dist = np.full(n, np.inf, dtype=np.float64)
    if not 0 <= source < n:
        return dist, 0, True
    w = np.maximum(weights.astype(np.float64), 0.0)
    dist[source] = 0.0
    cap = max_iterations if max_iterations >= 0 else max(1, n)
    it, changed = 0, True
    while changed and it < cap:
        cand = dist[src] + w
        nxt = dist.copy()
        np.minimum.at(nxt, tgt, cand)
        changed = bool((nxt != dist).any())
        dist = nxt
        it += 1
    return np.round(dist, SCORE_DECIMALS), it, not changed


def run_host(name: str, n: int, src: np.ndarray, tgt: np.ndarray,
             weights: np.ndarray, bound) -> Tuple[np.ndarray, int, bool]:
    """Dispatch one bound procedure call onto its host kernel."""
    if name == "algo.degree":
        return degree(n, src, tgt, bound["direction"])
    if name == "algo.pagerank":
        return pagerank(n, src, tgt, bound["damping"],
                        bound["max_iterations"], bound["tolerance"])
    if name == "algo.wcc":
        return wcc(n, src, tgt, bound["max_iterations"])
    if name == "algo.bfs":
        return bfs(n, src, tgt, bound["source_index"], bound["max_depth"])
    if name == "algo.sssp":
        return sssp(n, src, tgt, weights, bound["source_index"],
                    bound["max_iterations"])
    raise ValueError(f"no host kernel for procedure {name!r}")
