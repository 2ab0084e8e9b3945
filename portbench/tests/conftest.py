"""Tests of the benchmark.  Run from the checkout's root:

    python -m pytest portbench/tests -q

Tests marked ``card`` need an NVIDIA card and skip elsewhere; the
``card`` fixture decides, never an import."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card")
    # tiny runs: one intra-op thread each, so parallel workers do not
    # oversubscribe the cores
    import torch
    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's cells run on the card")
    return torch.cuda.get_device_name(0)


def small_sizes(config):
    """Tiny sizes of a configuration for runs on the CPU."""
    return {"scale": 9} if "scale" in config else {}


@pytest.fixture
def small():
    return small_sizes


@pytest.fixture(scope="session")
def tree(tmp_path_factory):
    """The benchmark's cells and the served test cells (``served/``:
    a configuration, two mixes and their entries), in a copy of the
    benchmark's folder: ``(bench, base)`` for ``cell.run``."""
    import json
    import shutil
    from portbench.harness import spec
    here = os.path.dirname(os.path.abspath(__file__))
    base = tmp_path_factory.mktemp("tree") / "portbench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__", "tests"))
    for kind in ("configs", "traffic"):
        for f in os.listdir(os.path.join(here, "served", kind)):
            shutil.copy(os.path.join(here, "served", kind, f), base / kind)
    bench = spec.benchmark()
    with open(os.path.join(here, "served", "bench.json")) as f:
        extra = json.load(f)
    for key, entries in extra.items():
        bench[key] = bench[key] + entries
    return bench, str(base)
