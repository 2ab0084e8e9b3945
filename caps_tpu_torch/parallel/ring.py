"""Matrix var-expand and k-hop counts: SpMV hops over the node domain,
on one device and ring-scheduled over a mesh.

The counterpart of ``caps_tpu/parallel/ring.py``.  ``relational/var_expand.py`` runs a
var-length pattern whose relationship list nothing reads as a per-seed
path-count MATRIX ``F[s, v]`` (seeds × node domain) pushed over the
edge list hop by hop:

    F1 = H(F0),  F2 = H(F1) − F0 ⊙ r2,  ...    H(F)[s, v] = Σ_{e: u→v} F[s, u]

with relationship isomorphism restored per length by closed-form
corrections (see :func:`ring_varexpand3_reference`).

On a mesh (``make_ring_*``, ``*_cached``) the frontier is node-block
partitioned, adjacency shards stay resident, and blocks rotate around
the ring (``collectives.ring_shift``) — ring attention's communication
schedule with (gather ⋈ segment-sum) in place of (QKᵀ · softmax):

    step t: shard s holds frontier block (s - t) mod S
            local edges whose src falls in that block pick up cnt[src]
    after S steps every local edge has its source count; one segment-sum
    by dst, summed over shards and scattered back to node blocks, gives
    the next frontier.

The JAX package's ``fori_loop`` over ``ppermute`` is a Python loop of S
steps here: a local hop per shard, then the rotation.

Each hop's scatter is ``index_add_`` into the destination axis: a
native atomic add on the card, exact for the int64 counts.
"""
from __future__ import annotations

import functools

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


# ---------------------------------------------------------------------------
# Ring schedules over a mesh
# ---------------------------------------------------------------------------


def _psum_scatter(parts, n_shards: int, devices, dim: int = 0):
    """Sum the shards' full-length partials and give shard ``s`` block
    ``s`` of the sum along ``dim`` (``lax.psum_scatter`` tiled)."""
    from caps_tpu_torch.parallel.collectives import global_sum
    total = global_sum(parts, devices[:1])[0]
    nb = total.shape[dim] // n_shards
    return [total.narrow(dim, s * nb, nb).to(devices[s])
            for s in range(n_shards)]


def _ring_hop_matrix(f_blocks, edge_src, edge_dst, edge_ok, *,
                     n_nodes: int, n_shards: int, devices, edge_w=None):
    """One hop of the MATRIX frontier: ``f_blocks[s]`` is shard ``s``'s
    (seeds, node-block) slice of the per-seed path-count matrix F[s, v];
    ``edge_*[s]`` its resident edges.  Blocks rotate around the ring; the
    seed axis stays local.  ``edge_w`` weights each edge's contribution
    (the 3-hop isomorphism correction's weighted sparse hops)."""
    from caps_tpu_torch.parallel.collectives import note_collective, \
        ring_shift
    nb = n_nodes // n_shards
    note_collective("ring.ppermute", list(f_blocks), scale=n_shards,
                    rotations=n_shards)
    blk = list(f_blocks)
    acc = [torch.zeros((f_blocks[s].shape[0], edge_src[s].shape[0]),
                       dtype=f_blocks[s].dtype, device=devices[s])
           for s in range(n_shards)]
    for t in range(n_shards):
        for s in range(n_shards):
            lo = ((s - t) % n_shards) * nb
            src = edge_src[s].long()
            m = edge_ok[s] & (src >= lo) & (src < lo + nb)
            contrib = blk[s][:, (src - lo).clamp(0, nb - 1)]
            if edge_w is not None:
                contrib = contrib * edge_w[s][None, :]
            acc[s] = acc[s] + torch.where(m[None, :], contrib,
                                          torch.zeros_like(contrib))
        blk = ring_shift(blk, 1, devices)
    parts = []
    for s in range(n_shards):
        out = torch.zeros((acc[s].shape[0], n_nodes), dtype=acc[s].dtype,
                          device=devices[s])
        parts.append(out.index_add_(1, edge_dst[s].long(), acc[s]))
    note_collective("ring.psum_scatter", parts)
    return _psum_scatter(parts, n_shards, devices, dim=1)


def _ring_hop(cnt_blocks, edge_src, edge_dst, edge_ok, *, n_nodes: int,
              n_shards: int, devices):
    """One hop: node-block-sharded counts -> next counts, block-sharded
    (the seeds == 1 case of :func:`_ring_hop_matrix`)."""
    out = _ring_hop_matrix([b[None, :] for b in cnt_blocks], edge_src,
                           edge_dst, edge_ok, n_nodes=n_nodes,
                           n_shards=n_shards, devices=devices)
    return [o[0] for o in out]


def edge_blocks(mesh, **arrays):
    """Each edge array's per-shard resident blocks (lists, one block
    per shard), checked."""
    out = []
    for name, blocks in arrays.items():
        if len(blocks) != mesh.size:
            raise ValueError(f"{name}: {len(blocks)} blocks for "
                             f"{mesh.size} shards")
        out.append(list(blocks))
    return out


def make_ring_khop(mesh, n_nodes: int, n_hops: int, masked: bool = False):
    """The ring-scheduled k-hop expansion: seed counts (node blocks)
    come in whole and are split over the mesh; the edges are each
    shard's resident blocks (lists).  The result is the total path count and the final frontier.
    With ``masked``, a node mask multiplies the frontier after every hop
    (the planner's per-hop node-existence/label mask)."""
    from caps_tpu_torch.parallel.collectives import global_sum, \
        shard_blocks
    n_shards = mesh.size
    if n_nodes % n_shards:
        raise ValueError(f"n_nodes {n_nodes} must divide over {n_shards}")
    devices = mesh.shard_devices

    def call(seed, edge_src, edge_dst, edge_ok, mask=None):
        es, ed, eo = edge_blocks(mesh, edge_src=edge_src,
                                  edge_dst=edge_dst, edge_ok=edge_ok)
        if seed.shape[0] != n_nodes:
            raise ValueError(f"seed length {seed.shape[0]} != n_nodes "
                             f"{n_nodes}")
        if masked != (mask is not None):
            raise ValueError("mask must be passed iff masked=True")
        blk = shard_blocks(seed, mesh)
        mblk = shard_blocks(mask, mesh) if masked else None
        for _ in range(n_hops):
            blk = _ring_hop(blk, es, ed, eo, n_nodes=n_nodes,
                            n_shards=n_shards, devices=devices)
            if masked:
                blk = [b * m for b, m in zip(blk, mblk)]
        total = global_sum([b.sum() for b in blk], devices[:1])[0]
        return total, torch.cat([b.to(devices[0]) for b in blk])

    return call


def ring_khop_reference(seed_counts, edge_src, edge_dst, edge_ok,
                        n_hops: int, n_nodes: int):
    """Single-device twin of :func:`make_ring_khop` for differential
    tests."""
    cnt = seed_counts
    for _ in range(n_hops):
        per_edge = torch.where(edge_ok, cnt[edge_src.long()],
                               torch.zeros_like(cnt[edge_src.long()]))
        cnt = torch.zeros(n_nodes, dtype=cnt.dtype,
                          device=cnt.device).index_add_(
            0, edge_dst.long(), per_edge)
    return cnt.sum(), cnt


def _ring_r2(es, ed, eo, n_nodes, dtype, correction, n_shards, devices):
    parts = [r2_vector(es[s], ed[s], eo[s], n_nodes, dtype, correction)
             for s in range(n_shards)]
    return _psum_scatter(parts, n_shards, devices)


def _split_matrix(f, mesh):
    """(seeds, n_nodes) → each shard's (seeds, node-block) slice."""
    n = mesh.size
    nb = f.shape[1] // n
    return [f[:, s * nb:(s + 1) * nb].to(d)
            for s, d in enumerate(mesh.shard_devices)]


def make_ring_varexpand(mesh, n_nodes: int, lengths: tuple,
                        correction: str = "loops"):
    """Ring-scheduled var-length expand: the per-seed PATH-count matrix
    over the union of ``lengths`` (each in 0..2), with the
    relationship-isomorphism correction at length 2 (``correction`` as
    in :func:`ring_varexpand_reference`).  F0 (seeds, n_nodes) splits on
    its node axis and the target mask into node blocks; the edges are
    resident blocks (lists, one per shard).
    Returns the whole (seeds, n_nodes) multiplicity matrix on the lead
    device."""
    from caps_tpu_torch.parallel.collectives import shard_blocks
    n_shards = mesh.size
    if n_nodes % n_shards:
        raise ValueError(f"n_nodes {n_nodes} must divide over {n_shards}")
    if correction not in ("loops", "degree"):
        raise ValueError(correction)
    max_len = max(lengths) if lengths else 0
    if max_len > 2:
        raise ValueError("ring var-expand supports lengths <= 2")
    devices = mesh.shard_devices

    def call(f0, edge_src, edge_dst, edge_ok, tmask):
        es, ed, eo = edge_blocks(mesh, edge_src=edge_src,
                                  edge_dst=edge_dst, edge_ok=edge_ok)
        f0b = _split_matrix(f0, mesh)
        tm = shard_blocks(tmask, mesh)
        out = [torch.zeros_like(b) for b in f0b]
        if 0 in lengths:
            out = [o + b * m[None, :] for o, b, m in zip(out, f0b, tm)]
        f = f0b
        for length in range(1, max_len + 1):
            f = _ring_hop_matrix(f, es, ed, eo, n_nodes=n_nodes,
                                 n_shards=n_shards, devices=devices)
            if length == 2:
                corr = _ring_r2(es, ed, eo, n_nodes, f[0].dtype, correction,
                                n_shards, devices)
                f = [x - b * c[None, :] for x, b, c in zip(f, f0b, corr)]
            if length in lengths:
                out = [o + x * m[None, :] for o, x, m in zip(out, f, tm)]
        return torch.cat([o.to(devices[0]) for o in out], dim=1)

    return call


def make_ring_varexpand3(mesh, n_nodes: int, lengths: tuple,
                         correction: str = "loops"):
    """Ring-scheduled var-expand for lengths up to 3 (the terms of
    :func:`ring_varexpand3_reference`).  Extra inputs beyond
    :func:`make_ring_varexpand`'s: the two weighted sparse edge lists
    (sp13 / spT as (src, dst, w) triples of per-shard blocks)."""
    from caps_tpu_torch.parallel.collectives import shard_blocks
    n_shards = mesh.size
    if n_nodes % n_shards:
        raise ValueError(f"n_nodes {n_nodes} must divide over {n_shards}")
    if correction not in ("loops", "degree"):
        raise ValueError(correction)
    if (max(lengths) if lengths else 0) != 3:
        raise ValueError("use make_ring_varexpand for lengths <= 2")
    devices = mesh.shard_devices

    def call(f0, e_src, e_dst, e_ok, tmask, s13_src, s13_dst, s13_w,
             st_src, st_dst, st_w):
        es, ed, eo = edge_blocks(mesh, edge_src=e_src, edge_dst=e_dst,
                                  edge_ok=e_ok)
        s13s, s13d, s13w = edge_blocks(mesh, s13=s13_src, s13_dst=s13_dst,
                                        s13_w=s13_w)
        sts, std_, stw = edge_blocks(mesh, st=st_src, st_dst=st_dst,
                                      st_w=st_w)
        f0b = _split_matrix(f0, mesh)
        tm = shard_blocks(tmask, mesh)

        def hop(fb, s, d, o, w=None):
            return _ring_hop_matrix(fb, s, d, o, n_nodes=n_nodes,
                                    n_shards=n_shards, devices=devices,
                                    edge_w=w)

        def lin(*terms):
            """Σ coef · block, shard by shard."""
            return [sum(c * t[s] for c, t in terms)
                    for s in range(n_shards)]

        r2 = _ring_r2(es, ed, eo, n_nodes, f0.dtype, correction, n_shards,
                      devices)

        def masked(x):
            return [b * m[None, :] for b, m in zip(x, tm)]

        f0r2 = [b * r[None, :] for b, r in zip(f0b, r2)]
        out = [torch.zeros_like(b) for b in f0b]
        if 0 in lengths:
            out = lin((1, out), (1, masked(f0b)))
        f1 = hop(f0b, es, ed, eo)
        if 1 in lengths:
            out = lin((1, out), (1, masked(f1)))
        f2 = hop(f1, es, ed, eo)
        if 2 in lengths:
            out = lin((1, out), (1, masked(lin((1, f2), (-1, f0r2)))))
        f3 = hop(f2, es, ed, eo)
        a12 = hop(f0r2, es, ed, eo)
        a23 = [b * r[None, :] for b, r in zip(f1, r2)]
        a13 = hop(f0b, s13s, s13d, [w > 0 for w in s13w], s13w)
        t3 = hop(f0b, sts, std_, [w > 0 for w in stw], stw)
        p3 = lin((1, f3), (-1, a12), (-1, a23), (-1, a13), (2, t3))
        res = lin((1, out), (1, masked(p3)))
        return torch.cat([r.to(devices[0]) for r in res], dim=1)

    return call


@functools.lru_cache(maxsize=128)
def ring_varexpand_cached(mesh, n_nodes: int, lengths: tuple,
                          correction: str = "loops"):
    """Memoized :func:`make_ring_varexpand` (one closure per shape)."""
    return make_ring_varexpand(mesh, n_nodes, lengths, correction)


@functools.lru_cache(maxsize=128)
def ring_varexpand3_cached(mesh, n_nodes: int, lengths: tuple,
                           correction: str = "loops"):
    return make_ring_varexpand3(mesh, n_nodes, lengths, correction)


@functools.lru_cache(maxsize=128)
def ring_khop_cached(mesh, n_nodes: int, n_hops: int, masked: bool = False):
    """Memoized :func:`make_ring_khop`."""
    return make_ring_khop(mesh, n_nodes, n_hops, masked)
