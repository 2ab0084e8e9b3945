"""Graph500-style RMAT edge-list generator + triangle-count queries.

The counterpart of ``caps_tpu/datasets/graph500.py``.  Benchmark config
4 (BASELINE.md): the triangle / 3-cycle motif count on a Graph500
scale-N Kronecker (RMAT) edge list, exercising the cyclic join path and
reporting edges joined per second.

The generator is the standard RMAT recursion with the Graph500 reference
parameters (A, B, C, D) = (0.57, 0.19, 0.19, 0.05), vectorized over
numpy: the same (scale, edgefactor, seed) gives the reference's arrays
bit for bit.  Scale s means 2**s vertices and ``edgefactor * 2**s``
directed edges.  :func:`triangle_graph` builds the graph from numpy
columns (the bulk ingest path), where the reference builds lists of
Python ints, so scale 20 ingests in seconds.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from caps_tpu_torch.okapi.types import CTInteger
from caps_tpu_torch.relational.entity_tables import (
    NodeMapping, NodeTable, RelationshipMapping, RelationshipTable,
)

# Graph500 reference RMAT partition probabilities.
A, B, C = 0.57, 0.19, 0.19


def rmat_edges(scale: int, edgefactor: int = 16, seed: int = 1,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Generate a directed RMAT edge list: (src, dst) int64 arrays of
    length edgefactor * 2**scale over 2**scale vertices.

    Vectorized Graph500 kernel-1 recursion: each of the ``scale`` bits of
    (src, dst) is drawn independently per edge from the 2x2 RMAT
    distribution, with the Graph500 noise convention applied per level.
    Self-loops and duplicates are kept (Graph500 kernels dedup later;
    triangle counting below dedups explicitly).
    """
    n_edges = edgefactor << scale
    rng = np.random.RandomState(seed)
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    ab = A + B
    c_norm = C / (1.0 - ab)
    a_norm = A / ab
    for level in range(scale):
        ii_bit = rng.rand(n_edges) > ab
        jj_bit = rng.rand(n_edges) > np.where(ii_bit, c_norm, a_norm)
        src |= ii_bit.astype(np.int64) << level
        dst |= jj_bit.astype(np.int64) << level
    # Graph500 permutes vertex labels so degree isn't correlated with id.
    perm = rng.permutation(1 << scale)
    return perm[src], perm[dst]


def canonical_edges(scale: int, edgefactor: int = 8, seed: int = 1
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`rmat_edges` canonicalized for triangle counting, as the
    reference's ``triangle_graph`` does: self-loops dropped, edges
    undirected-deduped and oriented lo < hi so each undirected edge
    appears exactly once, sorted by (lo, hi)."""
    src, dst = rmat_edges(scale, edgefactor, seed)
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    keep = lo != hi
    lo, hi = lo[keep], hi[keep]
    key = (lo << scale) | hi
    _, idx = np.unique(key, return_index=True)
    return lo[idx], hi[idx]


def triangle_graph(session, scale: int, edgefactor: int = 8, seed: int = 1):
    """Build a PropertyGraph of (:V)-[:E]->(:V) from the canonical RMAT
    edge list (:func:`canonical_edges`): node ids 0 .. 2**scale - 1,
    relationship ids from 2**scale up in edge order, as the reference's.

    Returns (graph, src, dst) with the canonical arrays for computing
    expected counts host-side.
    """
    lo, hi = canonical_edges(scale, edgefactor, seed)
    n_nodes = 1 << scale
    f = session.table_factory
    nt = NodeTable(
        NodeMapping.on("_id").with_implied_labels("V"),
        f.from_columns({"_id": np.arange(n_nodes, dtype=np.int64)},
                       {"_id": CTInteger}))
    rt = RelationshipTable(
        RelationshipMapping.on("E"),
        f.from_columns(
            {"_id": np.arange(n_nodes, n_nodes + len(lo), dtype=np.int64),
             "_src": lo.astype(np.int64), "_tgt": hi.astype(np.int64)},
            {"_id": CTInteger, "_src": CTInteger, "_tgt": CTInteger}))
    return session.create_graph([nt], [rt]), lo, hi


# With edges oriented lo->hi, every undirected triangle {x<y<z} appears as
# exactly one ordered match of this acyclic-DAG pattern — the standard
# oriented-triangle trick, so the query needs no post-division by 6.
TRIANGLE_QUERY = ("MATCH (a)-[:E]->(b)-[:E]->(c), (a)-[:E]->(c) "
                  "RETURN count(*) AS triangles")


def count_triangles_reference(lo: np.ndarray, hi: np.ndarray) -> int:
    """Host-side oracle: count triangles in the oriented edge list via a
    CSR adjacency (the native runtime's counting sort,
    native/csrc/host_runtime.cpp ``csr_build``; numpy's stable argsort
    only under ``CAPS_TPU_NO_NATIVE=1``) + a per-edge sorted neighbour
    intersection.  A failed native build raises ``NativeBuildError``."""
    from caps_tpu_torch import native
    if len(lo) == 0:
        return 0
    n = int(max(lo.max(), hi.max())) + 1
    lo64, hi64 = lo.astype(np.int64), hi.astype(np.int64)
    lib = native.runtime()
    if lib is not None:
        off_b, perm_b = lib.csr_build(np.ascontiguousarray(lo64),
                                      len(lo64), n)
        starts = np.frombuffer(off_b, np.int64)
        perm = np.frombuffer(perm_b, np.int64)
    else:
        starts = np.concatenate(
            [[0], np.cumsum(np.bincount(lo64, minlength=n))])
        perm = np.argsort(lo64, kind="stable")
    # rows grouped by source via perm; intersect1d sorts internally so
    # within-row neighbour order doesn't matter
    lo_s, hi_s = lo64[perm], hi64[perm]
    total = 0
    for u, v in zip(lo_s, hi_s):
        au = hi_s[starts[u]:starts[u + 1]]
        av = hi_s[starts[v]:starts[v + 1]]
        total += len(np.intersect1d(au, av, assume_unique=True))
    return total
