"""Single-device matrix var-expand: SpMV hops over a per-seed count matrix.

The counterpart of the single-device functions of
``caps_tpu/parallel/ring.py``.  ``relational/var_expand.py`` runs a
var-length pattern whose relationship list nothing reads as a per-seed
path-count MATRIX ``F[s, v]`` (seeds × node domain) pushed over the
edge list hop by hop:

    F1 = H(F0),  F2 = H(F1) − F0 ⊙ r2,  ...    H(F)[s, v] = Σ_{e: u→v} F[s, u]

with relationship isomorphism restored per length by closed-form
corrections (see :func:`ring_varexpand3_reference`).  On a TPU mesh the
JAX package rotates frontier blocks around a ``ppermute`` ring; the
ring schedule (``make_ring_*``, ``*_cached``, ``ring_khop_*``) needs a
device mesh and waits for the multi-GPU slice (ROADMAP Queue 1 item 12).

Each hop's scatter is ``index_add_`` into the destination axis: a
native atomic add on the card, exact for the int64 counts.
"""
from __future__ import annotations

import numpy as np
import torch


def _hop(f: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
         ok: torch.Tensor, w=None) -> torch.Tensor:
    """One SpMV hop of the count matrix: each live edge u→v adds
    ``F[:, u]`` (times its weight) into column v."""
    per_edge = torch.where(ok[None, :], f[:, src.long()],
                           torch.zeros((), dtype=f.dtype, device=f.device))
    if w is not None:
        per_edge = per_edge * w[None, :]
    out = torch.zeros_like(f)
    return out.index_add_(1, dst.long(), per_edge)


def r2_vector(edge_src, edge_dst, edge_ok, n_nodes: int, dtype,
               correction: str) -> torch.Tensor:
    """Per-node reuse-pair count: self-loops (uniform direction) or the
    symmetrized degree (undirected) — the length-2 isomorphism
    correction vector, also the A12/A23 factor of the 3-hop one."""
    if correction == "loops":
        bad = edge_ok & (edge_src == edge_dst)
    else:
        bad = edge_ok
    out = torch.zeros(n_nodes, dtype=dtype, device=edge_src.device)
    return out.index_add_(0, edge_src.long(), bad.to(dtype))


def ring_varexpand_reference(f0, edge_src, edge_dst, edge_ok, tmask,
                             lengths: tuple, correction: str = "loops",
                             r2=None):
    """Per-seed multiplicity matrix of the paths of ``lengths`` (each
    ≤ 2) ending in ``tmask``, relationship isomorphism enforced.  ``r2``
    is :func:`r2_vector` of the edges, computed here when None (a caller
    running many seed chunks over one graph passes it in)."""
    n_nodes = f0.shape[1]
    out = torch.zeros_like(f0)
    if 0 in lengths:
        out = out + f0 * tmask[None, :]
    f = f0
    for length in range(1, (max(lengths) if lengths else 0) + 1):
        f = _hop(f, edge_src, edge_dst, edge_ok)
        if length == 2:
            if r2 is None:
                r2 = r2_vector(edge_src, edge_dst, edge_ok, n_nodes,
                               f.dtype, correction)
            f = f - f0 * r2[None, :]
        if length in lengths:
            out = out + f * tmask[None, :]
    return out


def ring_varexpand3_reference(f0, edge_src, edge_dst, edge_ok, tmask,
                              lengths: tuple, s13, st,
                              correction: str = "loops", r2=None):
    """The same for lengths up to 3 (``s13``/``st`` are (src, dst, w)
    tensor triples from :func:`build_iso3_sparse`).  Walk counts are
    SpMV hops; isomorphism is restored per length:

        P2 = W2 − F0·r2                                (reuse at start)
        P3 = W3 − A12 − A23 − A13 + 2T   (inclusion–exclusion over the
                                          pairs (1,2), (2,3), (1,3);
                                          every pairwise intersection is
                                          the all-equal triple T)
        A12 = H(F0 ⊙ r2)        — same-rel pair first, any third hop
        A23 = H(F0) ⊙ r2        — any first hop, same-rel pair after
        A13 = H_sp13(F0)        — first rel reused as third; the free
                                  middle hop's count is folded into a
                                  host-built weighted sparse hop
        T   = H_spT(F0)         — all three the same rel

    ``r2`` as in :func:`ring_varexpand_reference`."""
    if (max(lengths) if lengths else 0) != 3:
        raise ValueError("use ring_varexpand_reference for lengths <= 2")
    n_nodes = f0.shape[1]
    if r2 is None:
        r2 = r2_vector(edge_src, edge_dst, edge_ok, n_nodes, f0.dtype,
                       correction)
    out = torch.zeros_like(f0)
    if 0 in lengths:
        out = out + f0 * tmask[None, :]
    f1 = _hop(f0, edge_src, edge_dst, edge_ok)
    if 1 in lengths:
        out = out + f1 * tmask[None, :]
    f2 = _hop(f1, edge_src, edge_dst, edge_ok)
    if 2 in lengths:
        out = out + (f2 - f0 * r2[None, :]) * tmask[None, :]
    f3 = _hop(f2, edge_src, edge_dst, edge_ok)
    a12 = _hop(f0 * r2[None, :], edge_src, edge_dst, edge_ok)
    a23 = f1 * r2[None, :]
    a13 = _hop(f0, s13[0], s13[1], s13[2] > 0, w=s13[2])
    t3 = _hop(f0, st[0], st[1], st[2] > 0, w=st[2])
    return out + (f3 - a12 - a23 - a13 + 2 * t3) * tmask[None, :]


def build_iso3_sparse(frm, to, rid, n_nodes: int):
    """Host-side weighted sparse edge lists for the 3-hop correction.

    ``frm``/``to``/``rid`` describe the ENTRY list the hops traverse
    (symmetrized for undirected patterns; each entry carries its
    underlying relationship id).  Returns (sp13, spT) as (src, dst, w)
    numpy triples:

      * sp13: for each ordered orientation pair (o1, o3) of one
        relationship, an edge from(o1) -> to(o3) weighted by the number
        of entries that can serve as the free middle hop
        to(o1) -> from(o3);
      * spT: for each orientation chain o1 -> o2 -> o3 of one
        relationship, an edge from(o1) -> to(o3) with weight 1.
    """
    frm = np.asarray(frm, dtype=np.int64)
    to = np.asarray(to, dtype=np.int64)
    rid = np.asarray(rid, dtype=np.int64)

    # entry-count lookup between ordered node pairs
    keys = np.sort(frm * n_nodes + to)

    def cnt(x, y):
        q = x * n_nodes + y
        return (np.searchsorted(keys, q, side="right")
                - np.searchsorted(keys, q, side="left"))

    # group entries by relationship id: 1 orientation (directed or a
    # loop) or 2 (undirected non-loop)
    order = np.argsort(rid, kind="stable")
    r_sorted = rid[order]
    first = np.ones(len(rid), dtype=bool)
    first[1:] = r_sorted[1:] != r_sorted[:-1]
    starts = np.nonzero(first)[0]
    counts = np.diff(np.append(starts, len(rid)))

    s13_s, s13_d, s13_w = [], [], []
    st_s, st_d, st_w = [], [], []
    if counts.size and int(counts.max()) > 2:
        # a rel id appearing 3+ times means a malformed entry list
        # (e.g. double symmetrization); an omitted correction would be a
        # silent wrong answer, so fail loudly
        raise ValueError("entry list has a relationship id with more "
                         "than two orientations")
    one = starts[counts == 1]
    u1, v1 = frm[order[one]], to[order[one]]
    # single-orientation rels: (o1, o3) = (e, e); chain o1->o2->o3 needs
    # o2 = e too, which chains only for loops
    s13_s.append(u1)
    s13_d.append(v1)
    s13_w.append(cnt(v1, u1))
    lo = u1 == v1
    st_s.append(u1[lo])
    st_d.append(v1[lo])
    st_w.append(np.ones(int(lo.sum()), dtype=np.int64))
    two = starts[counts == 2]
    if len(two):
        ua, va = frm[order[two]], to[order[two]]        # orientation uv
        s13_s.append(np.concatenate([ua, ua, va, va]))
        s13_d.append(np.concatenate([va, ua, va, ua]))
        s13_w.append(np.concatenate([cnt(va, ua), cnt(va, va),
                                     cnt(ua, ua), cnt(ua, va)]))
        # chains: u -e- v -e- u -e- v and the reverse
        st_s.append(np.concatenate([ua, va]))
        st_d.append(np.concatenate([va, ua]))
        st_w.append(np.ones(2 * len(two), dtype=np.int64))

    def pack(ss, dd, ww):
        s = np.concatenate(ss) if ss else np.zeros(0, np.int64)
        d = np.concatenate(dd) if dd else np.zeros(0, np.int64)
        w = np.concatenate(ww) if ww else np.zeros(0, np.int64)
        keep = w > 0
        return (s[keep].astype(np.int32), d[keep].astype(np.int32),
                w[keep])

    return pack(s13_s, s13_d, s13_w), pack(st_s, st_d, st_w)
