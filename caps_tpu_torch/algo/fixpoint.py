"""The shared iterative-fixpoint executor: the device programs in torch.

The counterpart of ``caps_tpu/algo/fixpoint.py``.  Every procedure has
one program per ``(procedure, node capacity, edge capacity)``: the node
and edge arrays are padded to shape-lattice buckets
(``relational/shapes.py``), dead lanes are masked (padded nodes carry
zero rank / identity labels / unreached distances, padded edges a zero
mask), and every step keeps the masked lanes at their fixpoint so they
never leak into live lanes.

The reference runs its whole ``lax.while_loop`` as one device program.
Eagerly, a loop that reads its ``done`` flag after every step makes one
synchronizing call per iteration, so :func:`_loop` instead

* **freezes the state on the device** once done: each step computes
  ``nxt``, then ``state = where(active, nxt, state)``, ``it += active``
  and ``done |= active & step_done`` with ``active = ~done & (it <
  cap)`` — extra steps after convergence change nothing, so iteration
  counts, ``converged`` and outputs equal the reference's exactly,
  ``max_iterations`` cut-offs included;
* **reads convergence once every** :data:`CHECK_EVERY` steps, or not at
  all when the caller already knows how many steps the loop takes (a
  fused replay serves the recorded count, ``algo/op.py``).

PageRank's float64 scatter-add goes through ``index_put_(...,
accumulate=True)``: on the card it sorts the indices (a stable radix
sort) and sums each target's contributions in one thread, in edge order
for a target with fewer than 32 in-edges, so two runs give the same
bits (``index_add_`` adds with atomics, in whatever order they land).
On the CPU it adds serially in edge order, as ``np.add.at`` does.
Divisions by a scalar divide by a 0-d tensor on the program's device:
PyTorch's CUDA ``div`` by a Python number multiplies by its reciprocal,
which can drift an ulp from numpy.  Float outputs are not quantized
here — the operator quantizes on the host with ``np.round``, the
oracle's own function, after the transfer.

``build_program`` returns ``fn(node_mask, src, tgt, edge_mask, weights,
*scalars, steps=None, reads=None, n_edges=None) -> (out, iterations,
done)`` with ``iterations`` and ``done`` as 0-d device tensors;
``reads`` (a one-element list) counts the convergence reads, and
``n_edges`` (the live edge count, when the caller compacted the edges
live-first) leaves the dead tail out of every edge pass.  No caching here: the
operator owns the per-backend program cache and charges the ``algo``
compile-ledger kind once per first-seen shape.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from caps_tpu_torch.algo.kernels import UNREACHED

#: steps between two reads of the loop's ``done`` flag
CHECK_EVERY = 4

_I64 = torch.int64
_F64 = torch.float64


def _loop(body: Callable, state0: Tuple[torch.Tensor, ...], cap: int,
          steps: Optional[int], reads: Optional[List[int]]):
    """Run ``body`` (state -> (state, step_done)) with the reference's
    ``(iteration < cap) & ~done`` guard evaluated on the device.
    ``steps`` None: read ``done`` every :data:`CHECK_EVERY` steps and
    stop when it is set; else run ``min(steps, cap)`` steps and read
    nothing.  Returns ``(state, iterations, done)``; ``iterations``
    counts one more step when the loop stopped while still active,
    which only a too small ``steps`` can do (a generic replay's check,
    ``DeviceBackend.consume_fixpoint``)."""
    dev = state0[0].device
    it = torch.zeros((), dtype=_I64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    state = state0
    cap = max(0, int(cap))
    todo = cap if steps is None else min(cap, max(0, int(steps)))
    ran = 0
    while ran < todo:
        active = ~done & (it < cap)
        nxt, step_done = body(state)
        state = tuple(torch.where(active, n, s) for n, s in zip(nxt, state))
        it = it + active.to(_I64)
        done = done | (active & step_done)
        ran += 1
        if steps is None and ran % CHECK_EVERY == 0 and ran < todo:
            if reads is not None:
                reads[0] += 1
            if bool(done):
                break
    return state, it + (~done & (it < cap)).to(_I64), done


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float64 0-d tensor on ``like``'s device (see the module note on
    division by a Python number)."""
    return torch.full((), float(value), dtype=_F64, device=like.device)


def _scatter_add_ordered(n: int, index: torch.Tensor, values: torch.Tensor
                         ) -> torch.Tensor:
    """``zeros(n).at[index].add(values)`` summed per target in edge order
    (the module note)."""
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.index_put_((index,), values, accumulate=True)


def _degree(node_mask, src, tgt, edge_mask, weights, sc, steps, reads):
    one = edge_mask.to(_I64)
    n_pad = node_mask.shape[0]
    mode = sc["direction_code"]  # 0=out 1=in 2=both
    deg = torch.zeros(n_pad, dtype=_I64, device=src.device)
    if mode != 1:
        deg = deg.index_add(0, src, one)
    if mode != 0:
        deg = deg.index_add(0, tgt, one)
    return (deg, torch.ones((), dtype=_I64, device=src.device),
            torch.ones((), dtype=torch.bool, device=src.device))


def _pagerank(node_mask, src, tgt, edge_mask, weights, sc, steps, reads):
    n_pad = node_mask.shape[0]
    live = node_mask.to(_F64)
    n_live = max(float(sc["n_live"]), 1.0)
    n_live_t = _scalar(n_live, live)
    d = float(sc["damping"])
    tol = float(sc["tolerance"])
    e_live = edge_mask.to(_F64)
    # whole numbers: any order of the adds gives the same bits
    out_deg = torch.zeros(n_pad, dtype=_F64, device=src.device).index_add_(
        0, src, e_live)
    r0 = live / n_live_t
    base = (1.0 - d) / n_live
    one = _scalar(1.0, live)
    dangling_lane = live * (out_deg == 0).to(_F64)

    def body(state):
        r, _delta = state
        contrib = torch.where(out_deg > 0, r / torch.maximum(out_deg, one),
                              torch.zeros_like(r))
        nxt = _scatter_add_ordered(n_pad, tgt, contrib[src] * e_live)
        dangling = torch.sum(r * dangling_lane)
        nxt = live * (base + d * (nxt + dangling / n_live_t))
        delta = (nxt - r).abs().sum()
        return (nxt, delta), delta <= tol

    inf = torch.full((), float("inf"), dtype=_F64, device=live.device)
    (r, _), it, done = _loop(body, (r0, inf), sc["max_iterations"], steps,
                             reads)
    return r, it, done


def _wcc(node_mask, src, tgt, edge_mask, weights, sc, steps, reads):
    n_pad = node_mask.shape[0]
    idx = torch.arange(n_pad, dtype=_I64, device=src.device)
    # dead edges carry the largest label, which lowers nothing
    big = torch.full((), torch.iinfo(_I64).max, dtype=_I64,
                     device=src.device)

    def body(state):
        (label,) = state
        ls = torch.where(edge_mask, label[src], big)
        lt = torch.where(edge_mask, label[tgt], big)
        nxt = label.scatter_reduce(0, tgt, ls, "amin", include_self=True)
        nxt = nxt.scatter_reduce(0, src, lt, "amin", include_self=True)
        nxt = nxt[nxt]  # pointer jumping (matches the host twin)
        return (nxt,), torch.all(nxt == label)

    (label,), it, done = _loop(body, (idx,), sc["max_iterations"], steps,
                               reads)
    return label, it, done


def _source_lane(n_pad: int, sc, device) -> torch.Tensor:
    """Bool lanes: True at the source's compacted index, when it is in
    range.  ``source_index`` may be a 0-d device tensor (no read)."""
    source = torch.as_tensor(sc["source_index"], dtype=_I64, device=device)
    in_range = (source >= 0) & (source < int(sc["n_live"]))
    return (torch.arange(n_pad, device=device) == source) & in_range


def _bfs(node_mask, src, tgt, edge_mask, weights, sc, steps, reads):
    n_pad = node_mask.shape[0]
    unreached = torch.full((), UNREACHED, dtype=_I64, device=src.device)
    at_source = _source_lane(n_pad, sc, src.device)
    dist0 = torch.where(at_source, torch.zeros_like(unreached), unreached)
    max_depth = int(sc["max_depth"])
    cap = max_depth if max_depth >= 0 else n_pad

    def body(state):
        (dist,) = state
        ds = dist[src]
        reach = (ds != unreached) & edge_mask
        # the sentinel is int64 max: select BEFORE the +1
        cand = torch.where(reach, torch.where(reach, ds, 0) + 1, unreached)
        nxt = dist.scatter_reduce(0, tgt, cand, "amin", include_self=True)
        return (nxt,), torch.all(nxt == dist)

    (dist,), it, done = _loop(body, (dist0,), cap, steps, reads)
    return dist, it, done


def _sssp(node_mask, src, tgt, edge_mask, weights, sc, steps, reads):
    n_pad = node_mask.shape[0]
    inf = torch.full((), float("inf"), dtype=_F64, device=src.device)
    w = torch.where(edge_mask, torch.clamp(weights, min=0.0), inf)
    at_source = _source_lane(n_pad, sc, src.device)
    dist0 = torch.where(at_source, torch.zeros_like(inf), inf)
    cap = int(sc["max_iterations"])
    cap = cap if cap >= 0 else n_pad

    def body(state):
        (dist,) = state
        cand = dist[src] + w
        nxt = dist.scatter_reduce(0, tgt, cand, "amin", include_self=True)
        return (nxt,), torch.all(nxt == dist)

    (dist,), it, done = _loop(body, (dist0,), cap, steps, reads)
    return dist, it, done  # quantized host-side, like _pagerank


_DEVICE_KERNELS = {
    "algo.degree": _degree,
    "algo.pagerank": _pagerank,
    "algo.wcc": _wcc,
    "algo.bfs": _bfs,
    "algo.sssp": _sssp,
}

#: scalar operand names per procedure, in a fixed order (the program's
#: positional tail — names keyed out of the bound-args dict)
SCALAR_OPERANDS: Dict[str, Tuple[str, ...]] = {
    "algo.degree": ("direction_code",),
    "algo.pagerank": ("n_live", "damping", "max_iterations", "tolerance"),
    "algo.wcc": ("max_iterations",),
    "algo.bfs": ("n_live", "source_index", "max_depth"),
    "algo.sssp": ("n_live", "source_index", "max_iterations"),
}


def scalar_values(name: str, bound: Dict[str, Any], n_live: int) -> tuple:
    """The scalar operands for one bound call, in operand order: host
    numbers, except ``source_index``, which may be a 0-d device tensor."""
    pool = dict(bound)
    pool["n_live"] = n_live
    if name == "algo.degree":
        pool["direction_code"] = {"out": 0, "in": 1,
                                  "both": 2}[pool["direction"]]
    return tuple(pool[key] for key in SCALAR_OPERANDS[name])


def build_program(name: str, n_pad: int, e_pad: int):
    """The program for one procedure at one (node, edge) capacity pair.
    The caller caches it and owns the compile-ledger charge."""
    kernel = _DEVICE_KERNELS[name]
    operand_names = SCALAR_OPERANDS[name]

    def program(node_mask, src, tgt, edge_mask, weights, *scalars,
                steps: Optional[int] = None,
                reads: Optional[List[int]] = None,
                n_edges: Optional[int] = None):
        if node_mask.shape[0] != n_pad or src.shape[0] != e_pad:
            raise ValueError(f"{name} program for n_pad={n_pad}, "
                             f"e_pad={e_pad} called with "
                             f"{node_mask.shape[0]}, {src.shape[0]}")
        if n_edges is not None:
            # the caller's promise: lanes from n_edges on are dead
            # (compacted live-first), so they are left out — dead lanes
            # add nothing, but their shared index 0 would serialize
            # index_put_'s per-target sum on one thread
            src, tgt, edge_mask, weights = (
                a[:n_edges] for a in (src, tgt, edge_mask, weights))
        sdict = dict(zip(operand_names, scalars))
        return kernel(node_mask, src, tgt, edge_mask, weights, sdict,
                      steps, reads)

    return program


# -- dense family: SpMV as matrix product over the full capacity tile ------
#
# When the edge list approaches the full n x n tile, the operator
# densifies the (bucketed) adjacency once per call on the device and
# iterates with contiguous matrix products / masked reductions — no
# scatter in the loop.  Chosen when ``e >= n_pad^2 / DENSE_EDGE_DIVISOR``
# and the node capacity fits ``DENSE_MAX_NODES`` (the tile memory
# guard), as in the reference.

#: largest node capacity the dense family will tile (n_pad^2 doubles)
DENSE_MAX_NODES = 2048
#: density gate: dense when e >= n_pad*n_pad / this divisor
DENSE_EDGE_DIVISOR = 8

_BIG = torch.iinfo(_I64).max


def dense_eligible(n_pad: int, n_edges: int) -> bool:
    return (n_pad <= DENSE_MAX_NODES
            and n_edges * DENSE_EDGE_DIVISOR >= n_pad * n_pad)


def densify(n_pad: int, src: torch.Tensor, tgt: torch.Tensor,
            edge_mask: torch.Tensor, weights: torch.Tensor,
            with_weights: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, W): float64 [n_pad, n_pad] edge multiplicity, and the min
    non-negative weight per (s, t) with +inf off-edge (``W`` is ``A``
    when ``with_weights`` is False: only sssp reads it).  Dead edges
    add nothing.  ``index_add_`` rather than ``bincount``, which reads
    the largest index back to size its output."""
    flat = src * n_pad + tgt
    A = torch.zeros(n_pad * n_pad, dtype=_F64, device=src.device)
    A.index_add_(0, flat, edge_mask.to(_F64))
    A = A.view(n_pad, n_pad)
    if not with_weights:
        return A, A
    inf = torch.full((), float("inf"), dtype=_F64, device=src.device)
    w = torch.where(edge_mask, torch.clamp(weights, min=0.0), inf)
    W = torch.full((n_pad * n_pad,), float("inf"), dtype=_F64,
                   device=src.device)
    W.scatter_reduce_(0, flat, w, "amin", include_self=True)
    return A, W.view(n_pad, n_pad)


def _degree_dense(node_mask, A, W, sc, steps, reads):
    mode = sc["direction_code"]  # 0=out 1=in 2=both
    deg = torch.zeros(A.shape[0], dtype=_I64, device=A.device)
    if mode != 1:
        deg = deg + A.sum(dim=1).to(_I64)
    if mode != 0:
        deg = deg + A.sum(dim=0).to(_I64)
    return (deg, torch.ones((), dtype=_I64, device=A.device),
            torch.ones((), dtype=torch.bool, device=A.device))


def _pagerank_dense(node_mask, A, W, sc, steps, reads):
    live = node_mask.to(_F64)
    n_live = max(float(sc["n_live"]), 1.0)
    n_live_t = _scalar(n_live, live)
    d = float(sc["damping"])
    tol = float(sc["tolerance"])
    out_deg = A.sum(dim=1)
    r0 = live / n_live_t
    base = (1.0 - d) / n_live
    one = _scalar(1.0, live)
    dangling_lane = live * (out_deg == 0).to(_F64)

    def body(state):
        r, _delta = state
        contrib = torch.where(out_deg > 0, r / torch.maximum(out_deg, one),
                              torch.zeros_like(r))
        nxt = contrib @ A  # the SpMV, as one dense float64 product
        dangling = torch.sum(r * dangling_lane)
        nxt = live * (base + d * (nxt + dangling / n_live_t))
        delta = (nxt - r).abs().sum()
        return (nxt, delta), delta <= tol

    inf = torch.full((), float("inf"), dtype=_F64, device=A.device)
    (r, _), it, done = _loop(body, (r0, inf), sc["max_iterations"], steps,
                             reads)
    return r, it, done  # quantized host-side, like the sparse twin


def _wcc_dense(node_mask, A, W, sc, steps, reads):
    n_pad = node_mask.shape[0]
    B = (A > 0) | (A.T > 0)  # symmetrized reachability mask
    idx = torch.arange(n_pad, dtype=_I64, device=A.device)
    big = torch.full((), _BIG, dtype=_I64, device=A.device)

    def body(state):
        (label,) = state
        cand = torch.where(B, label[:, None], big)  # [s, t] -> label[s]
        nxt = torch.minimum(label, cand.min(dim=0).values)
        nxt = nxt[nxt]  # pointer jumping (matches both twins)
        return (nxt,), torch.all(nxt == label)

    (label,), it, done = _loop(body, (idx,), sc["max_iterations"], steps,
                               reads)
    return label, it, done


def _bfs_dense(node_mask, A, W, sc, steps, reads):
    n_pad = node_mask.shape[0]
    D = A > 0
    big = torch.full((), _BIG, dtype=_I64, device=A.device)
    at_source = _source_lane(n_pad, sc, A.device)
    dist0 = torch.where(at_source, torch.zeros_like(big), big)
    max_depth = int(sc["max_depth"])
    cap = max_depth if max_depth >= 0 else n_pad

    def body(state):
        (dist,) = state
        cand = torch.where(D, dist[:, None], big).min(dim=0).values
        nxt = torch.minimum(dist, torch.where(cand != big, cand + 1, big))
        return (nxt,), torch.all(nxt == dist)

    (dist,), it, done = _loop(body, (dist0,), cap, steps, reads)
    return dist, it, done


def _sssp_dense(node_mask, A, W, sc, steps, reads):
    n_pad = node_mask.shape[0]
    inf = torch.full((), float("inf"), dtype=_F64, device=A.device)
    at_source = _source_lane(n_pad, sc, A.device)
    dist0 = torch.where(at_source, torch.zeros_like(inf), inf)
    cap = int(sc["max_iterations"])
    cap = cap if cap >= 0 else n_pad

    def body(state):
        (dist,) = state
        # W holds min weight per (s, t), +inf off-edge: the min over
        # parallel edges relaxes to the same fixpoint as the edge list
        nxt = torch.minimum(dist, (dist[:, None] + W).min(dim=0).values)
        return (nxt,), torch.all(nxt == dist)

    (dist,), it, done = _loop(body, (dist0,), cap, steps, reads)
    return dist, it, done  # quantized host-side


_DENSE_KERNELS = {
    "algo.degree": _degree_dense,
    "algo.pagerank": _pagerank_dense,
    "algo.wcc": _wcc_dense,
    "algo.bfs": _bfs_dense,
    "algo.sssp": _sssp_dense,
}


def build_dense_program(name: str, n_pad: int):
    """Dense-family twin of :func:`build_program`: the program takes the
    densified adjacency ``A`` and min-weight matrix ``W``
    (:func:`densify`) instead of edge lists.  Same scalar operand tail;
    the caller caches and owns the ledger charge."""
    kernel = _DENSE_KERNELS[name]
    operand_names = SCALAR_OPERANDS[name]

    def program(node_mask, A, W, *scalars, steps: Optional[int] = None,
                reads: Optional[List[int]] = None):
        if A.shape != (n_pad, n_pad):
            raise ValueError(f"{name} dense program for n_pad={n_pad} "
                             f"called with {tuple(A.shape)}")
        sdict = dict(zip(operand_names, scalars))
        return kernel(node_mask, A, W, sdict, steps, reads)

    return program
