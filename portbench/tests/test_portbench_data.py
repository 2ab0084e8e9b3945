"""The generators repeat for a seed, and the plain references agree with
the port on the CPU at tiny sizes (the test calls the port; the
references import nothing of it)."""
import itertools
import os

import numpy as np
import pytest
import torch

from portbench.harness import spec, traffic

G500 = spec.load_cell("g500-triangles")
BIG_SEED = 2 ** 31 + 12345

# the served test cells' configuration and mixes (``served/``)
SERVED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "served")
SOCIAL_CONFIG = spec.load_json(os.path.join(SERVED, "configs",
                                            "social-tiny.json"))
SOCIAL = spec.load_module(os.path.join(SERVED, "configs", "social-tiny.py"),
                          "portbench_test_social_tiny")
MIXES = [spec.load_json(os.path.join(SERVED, "traffic", m + ".json"))
         for m in ("cohort-c4", "mixed-c8")]


def arrays_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(arrays_equal(a[k], b[k])
                                            for k in a)
    return np.array_equal(a, b)


@pytest.mark.parametrize("gen,config", [(SOCIAL, SOCIAL_CONFIG),
                                        (G500.generator, G500.config)],
                         ids=["social", "g500"])
@pytest.mark.parametrize("seed", [0, 7, BIG_SEED])
def test_generator_repeats_for_a_seed(gen, config, seed, small):
    cfg = dict(config, **small(config))
    a, b = gen.make(seed, cfg, "cpu"), gen.make(seed, cfg, "cpu")
    assert arrays_equal(a["nodes"], b["nodes"])
    assert arrays_equal(a["rels"], b["rels"])
    c = gen.make(seed + 1, cfg, "cpu")
    assert not arrays_equal(a["rels"], c["rels"])


def test_g500_canonical_form(small):
    cfg = dict(G500.config, **small(G500.config))
    d = G500.generator.make(1, cfg, "cpu")
    lo, hi = d["rels"]["E"]["_src"], d["rels"]["E"]["_tgt"]
    assert (lo < hi).all()
    key = lo * d["info"]["vertices"] + hi
    assert np.unique(key).size == key.size


def test_g500_draws_the_rmat_distribution():
    """The copy keeps the generator's shape: the edge list of the port's
    generator at the same scale has about as many canonical edges, and
    about as high a top degree."""
    from caps_tpu_torch.datasets import graph500
    lo, hi = graph500.canonical_edges(12, 16, 3)
    d = G500.generator.make(3, dict(G500.config, scale=12), "cpu")
    mine = d["rels"]["E"]
    assert abs(len(mine["_src"]) / len(lo) - 1) < 0.02
    top = np.bincount(np.concatenate([lo, hi])).max()
    my_top = np.bincount(np.concatenate([mine["_src"],
                                         mine["_tgt"]])).max()
    assert 0.7 < my_top / top < 1.4


def brute_triangles(lo, hi, n):
    adj = np.zeros((n, n), dtype=np.int64)
    adj[lo, hi] = adj[hi, lo] = 1
    return int(np.trace(adj @ adj @ adj)) // 6


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_triangle_reference_is_exact(seed):
    d = G500.generator.make(seed, dict(G500.config, scale=7), "cpu")
    lo, hi = d["rels"]["E"]["_src"], d["rels"]["E"]["_tgt"]
    got = G500.generator.triangles(torch.as_tensor(lo), torch.as_tensor(hi),
                                   128)
    assert int(got) == brute_triangles(lo, hi, 128)


def test_triangle_reference_in_chunks(monkeypatch):
    d = G500.generator.make(4, dict(G500.config, scale=8), "cpu")
    lo, hi = (torch.as_tensor(d["rels"]["E"][k]) for k in ("_src", "_tgt"))
    whole = int(G500.generator.triangles(lo, hi, 256))
    monkeypatch.setattr(G500.generator, "CHUNK", 97)
    assert int(G500.generator.triangles(lo, hi, 256)) == whole


def port_rows(session_graph, query, params):
    return session_graph.cypher(query, params).records.to_maps()


@pytest.fixture(scope="module")
def social_port():
    import caps_tpu_torch
    from caps_tpu_torch.interop import graph_from_numpy
    cfg = dict(SOCIAL_CONFIG, persons=3000, knows=30000)
    data = SOCIAL.make(11, cfg, "cpu")
    # a few self-loops, so relationship uniqueness is exercised
    k = data["rels"]["KNOWS"]
    k["_tgt"][:25] = k["_src"][:25]
    session = caps_tpu_torch.local_session(device="cpu")
    graph = graph_from_numpy(session, data["nodes"], data["rels"])
    return graph, SOCIAL.Reference(data, cfg, "cpu")


@pytest.mark.parametrize("fam", [f for m in MIXES for f in m["families"]],
                         ids=lambda f: f["name"])
def test_social_reference_agrees_with_the_port(social_port, fam):
    graph, ref = social_port
    space = traffic.param_space(fam)
    for params in space[:: max(1, len(space) // 6)]:
        assert port_rows(graph, fam["query"], params) == \
            ref.answer(fam, params), params


def test_triangle_reference_agrees_with_the_port():
    import caps_tpu_torch
    from caps_tpu_torch.interop import graph_from_numpy
    cfg = dict(G500.config, scale=9)
    data = G500.generator.make(5, cfg, "cpu")
    graph = graph_from_numpy(caps_tpu_torch.local_session(device="cpu"),
                             data["nodes"], data["rels"])
    fam = G500.mix["families"][0]
    assert port_rows(graph, fam["query"], {}) == \
        G500.generator.Reference(data, cfg, "cpu").answer(fam, {})


def test_streams_deal_the_same_work_to_every_seed():
    """Each client's stream is a deck: any seed gives the same set of
    parameters over a whole round, in another order."""
    mix = MIXES[1]
    rounds = 5 * 72
    for seed in (1, BIG_SEED):
        got = list(itertools.islice(traffic.client_stream(mix, seed, 0),
                                    rounds))
        fams = [i for i, _p in got]
        assert fams.count(0) == 4 * 72 and fams.count(1) == 72
    a = list(itertools.islice(traffic.client_stream(mix, 1, 0), 50))
    b = list(itertools.islice(traffic.client_stream(mix, 1, 0), 50))
    c = list(itertools.islice(traffic.client_stream(mix, 2, 0), 50))
    assert a == b and a != c


def test_cohort_params():
    fam = MIXES[0]["families"][0]
    space = traffic.param_space(fam)
    assert len(space) == 68
    assert all(p["hi"] == p["lo"] + 5 for p in space)
    assert {p["lo"] for p in space} == set(range(18, 86))
