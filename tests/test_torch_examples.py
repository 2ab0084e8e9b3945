"""The port's examples stay runnable: each ``examples/torch_*.py`` beside
its reference script returns its result rows, asserted as
``tests/test_examples.py`` asserts the reference's, on the port's
``local`` oracle and on its ``cuda`` backend run on the CPU
(``device="cpu"``: the same torch code as on the card)."""
import os
import sys

import pytest

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES_DIR)

BACKENDS = [("local", None), ("cuda", "cpu")]
IDS = ["local", "cuda"]


@pytest.mark.parametrize("backend,device", BACKENDS, ids=IDS)
def test_social_network(backend, device):
    import torch_social_network
    rows, foaf = torch_social_network.main(backend, device)
    assert rows == [{"a": "Alice", "b": "Bob"}, {"a": "Alice", "b": "Carol"}]
    assert foaf == [{"foaf": "Carol"}]


@pytest.mark.parametrize("backend,device", BACKENDS, ids=IDS)
def test_columnar_input(backend, device):
    import torch_columnar_input
    rows = torch_columnar_input.main(backend, device)
    assert rows == [{"customer": "Nia", "total": 298.0},
                    {"customer": "Omar", "total": 19.0}]


@pytest.mark.parametrize("backend,device", BACKENDS, ids=IDS)
def test_multiple_graph(backend, device):
    import torch_multiple_graph
    people, edges = torch_multiple_graph.main(backend, device)
    assert [r["n"] for r in people] == ["Alice", "Bob"]
    assert edges == [{"x": "Alice", "y": "Bob"}]


@pytest.mark.parametrize("backend,device", BACKENDS, ids=IDS)
def test_recommendation(backend, device):
    import torch_recommendation
    rows = torch_recommendation.main(backend, device)
    assert rows == [{"recommend": "monitor", "score": 2},
                    {"recommend": "headset", "score": 1}]


@pytest.mark.parametrize("backend,device", BACKENDS, ids=IDS)
def test_fs_datasource(backend, device):
    import torch_fs_datasource
    rows = torch_fs_datasource.main(backend, device)
    assert rows == [{"n": "Kyoto"}]


@pytest.mark.parametrize("backend,device", BACKENDS, ids=IDS)
def test_parameterized_reads(backend, device):
    import torch_parameterized_reads
    out = torch_parameterized_reads.main(backend, device)
    # (min_age, row count, size_syncs) per rotation of the prepared query
    assert [(m, n) for m, n, _ in out] == [
        (30, 4), (40, 2), (25, 5), (50, 1), (30, 4)]


@pytest.mark.parametrize("backend,device", BACKENDS, ids=IDS)
def test_serve_concurrent(backend, device):
    import torch_serve_concurrent
    ok, batch_max = torch_serve_concurrent.main(backend, device)
    assert ok == (torch_serve_concurrent.N_CLIENTS
                  * torch_serve_concurrent.PER_CLIENT)
    assert batch_max > 1  # the micro-batcher demonstrably coalesced


@pytest.mark.parametrize("backend,device", BACKENDS, ids=IDS)
def test_profile_query(backend, device):
    import torch_profile_query
    rows, explained, profiled, n_events = torch_profile_query.main(
        backend, device)
    assert rows == [{"person": "Ana", "knows": "Bo"},
                    {"person": "Ana", "knows": "Cleo"},
                    {"person": "Bo", "knows": "Cleo"}]
    assert explained.records is None
    assert profiled.profile["rows"] == len(rows)
    assert "rows=" in profiled.plans["profile"]
    assert n_events > 0
