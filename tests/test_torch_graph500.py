"""The port's Graph500 dataset (``caps_tpu_torch/datasets/graph500.py``)
against the JAX package's.

``rmat_edges`` gives the reference's arrays bit for bit, and the
triangle count of BASELINE config 4 is the same in five places at scales
8 and 10: the port's CUDA backend on the CPU, the port's local backend,
the JAX ``LocalCypherSession``, ``count_triangles_reference`` (native
CSR build and, under ``CAPS_TPU_NO_NATIVE=1``, numpy) and the scipy
oracle of ``chip_smoke.py``'s ``graph500`` phase.
"""
from __future__ import annotations

import numpy as np
import pytest

import caps_tpu_torch
import chip_smoke
from caps_tpu.backends.local.session import LocalCypherSession
from caps_tpu.datasets import graph500 as jax_g500
from caps_tpu_torch.datasets import graph500 as g500


@pytest.mark.parametrize("scale", [4, 8, 12])
@pytest.mark.parametrize("edgefactor,seed", [(16, 1), (8, 3)])
def test_rmat_edges_are_the_reference_arrays(scale, edgefactor, seed):
    got = g500.rmat_edges(scale, edgefactor, seed)
    want = jax_g500.rmat_edges(scale, edgefactor, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_triangle_graph_holds_the_reference_edges():
    session = caps_tpu_torch.local_session(backend="local")
    graph, lo, hi = g500.triangle_graph(session, 8, edgefactor=8, seed=2)
    _, jlo, jhi = jax_g500.triangle_graph(LocalCypherSession(), 8,
                                          edgefactor=8, seed=2)
    assert np.array_equal(lo, jlo) and np.array_equal(hi, jhi)
    rels = graph.rel_lookup()
    assert len(rels) == len(lo)
    assert rels[256] == (int(lo[0]), int(hi[0]), "E", {})
    assert len(graph.node_lookup()) == 256


def _count(graph):
    rows = graph.cypher(g500.TRIANGLE_QUERY).records.to_maps()
    assert len(rows) == 1
    return rows[0]["triangles"]


@pytest.mark.parametrize("scale", [8, 10])
def test_the_triangle_count_agrees_in_five_places(scale, monkeypatch):
    cuda = caps_tpu_torch.local_session(device="cpu")
    graph, lo, hi = g500.triangle_graph(cuda, scale)
    local, _, _ = g500.triangle_graph(
        caps_tpu_torch.local_session(backend="local"), scale)
    ref, jlo, jhi = jax_g500.triangle_graph(LocalCypherSession(), scale)
    want = jax_g500.count_triangles_reference(jlo, jhi)
    assert want > 0
    res = graph.cypher(g500.TRIANGLE_QUERY)
    assert res.records.to_maps() == [{"triangles": want}]
    strategies = {m.get("strategy") for m in res.metrics["operators"]}
    assert "cycle-probe" in strategies
    assert _count(local) == want
    assert _count(ref) == want
    assert g500.count_triangles_reference(lo, hi) == want
    assert chip_smoke.triangle_oracle(np, lo, hi, 1 << scale,
                                      chunk=100) == want
    monkeypatch.setenv("CAPS_TPU_NO_NATIVE", "1")
    assert g500.count_triangles_reference(lo, hi) == want


def test_the_oracle_on_small_graphs():
    # K4 has 4 triangles; a path has none; an empty list none
    lo = np.array([0, 0, 0, 1, 1, 2])
    hi = np.array([1, 2, 3, 2, 3, 3])
    assert chip_smoke.triangle_oracle(np, lo, hi, 4) == 4
    assert g500.count_triangles_reference(lo, hi) == 4
    assert chip_smoke.triangle_oracle(np, lo[:1], hi[:1], 4) == 0
    assert chip_smoke.triangle_oracle(np, lo[:0], hi[:0], 4) == 0
    assert g500.count_triangles_reference(lo[:0], hi[:0]) == 0
