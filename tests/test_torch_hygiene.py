"""Package rules of the PyTorch/CUDA port: it imports neither JAX nor the
JAX package, its entry point defaults to the card and refuses to run on
a missing one, its kernel wrappers refuse CPU tensors, and features not
ported yet raise NotImplementedError naming ROADMAP."""
import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch

import caps_tpu_torch
from caps_tpu_torch import ops
from caps_tpu_torch.backends.cuda.session import CUDACypherSession
from caps_tpu_torch.interop import graph_from_numpy

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "caps_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "chip_compare.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "caps_tpu"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_local_session_defaults_to_the_card():
    assert inspect.signature(caps_tpu_torch.local_session) \
        .parameters["device"].default == "cuda"
    assert inspect.signature(CUDACypherSession) \
        .parameters["device"].default == "cuda"


def test_cuda_session_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the session would start")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        caps_tpu_torch.local_session(device="cuda")
    with pytest.raises(RuntimeError):
        caps_tpu_torch.local_session()


def test_cpu_session_runs_on_cpu():
    s = caps_tpu_torch.local_session(device="cpu")
    assert s.device.type == "cpu"


@pytest.mark.parametrize("launch", [
    lambda: ops.dense_segment_agg_cuda(
        torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
        torch.zeros(4, dtype=torch.int32), 2, "count"),
    lambda: ops.expand_positions_cuda(
        torch.ones(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64),
        256),
    lambda: ops.bitonic_sort_perm_cuda(
        [torch.zeros(256, dtype=torch.int32)]),
    lambda: ops.prefetch_gather_cuda(
        torch.zeros(1024, dtype=torch.int32),
        torch.arange(4, dtype=torch.int32), 256),
], ids=["segment_agg", "expand_positions", "bitonic_sort", "prefetch_gather"])
def test_kernel_wrappers_raise_on_cpu_tensors(launch):
    before = ops.launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        launch()
    assert ops.launches() == before


@pytest.mark.parametrize("counts,lo", [
    (torch.ones(4, dtype=torch.float32), torch.zeros(4, dtype=torch.int64)),
    (torch.ones(4, dtype=torch.bool), torch.zeros(4, dtype=torch.int64)),
    (torch.ones(4, dtype=torch.int64), torch.zeros(4, dtype=torch.float64)),
], ids=["float_counts", "bool_counts", "float_lo"])
def test_expand_wrapper_rejects_non_integer_inputs(counts, lo):
    before = ops.launches()
    with pytest.raises(ValueError, match="must be int32 or int64"):
        ops.expand_positions_cuda(counts, lo, 256)
    assert ops.launches() == before


@pytest.mark.parametrize("query", [
    # var-length patterns run; a graph built from their matches does not
    "MATCH (a:Person)-[:KNOWS*1..2]->(b) CONSTRUCT NEW (b) RETURN GRAPH",
    "CALL algo.pagerank() YIELD node, score RETURN node",
    "CREATE (:Person {age: 1})",
], ids=["construct_after_var_length", "procedure", "update"])
def test_unported_features_raise(query):
    s = caps_tpu_torch.local_session(device="cpu")
    g = graph_from_numpy(
        s, {"Person": {"_id": np.arange(3, dtype=np.int64),
                       "age": np.arange(3, dtype=np.int64)}},
        {"KNOWS": {"_id": np.arange(3, 5, dtype=np.int64),
                   "_src": np.array([0, 1], dtype=np.int64),
                   "_tgt": np.array([1, 2], dtype=np.int64)}})
    with pytest.raises(NotImplementedError, match="see ROADMAP"):
        g.cypher(query)


def test_unported_config_flags_raise():
    from caps_tpu_torch.okapi.config import EngineConfig
    for flag in EngineConfig.UNPORTED_FLAGS:
        with pytest.raises(NotImplementedError, match=flag):
            caps_tpu_torch.local_session(
                device="cpu", config=EngineConfig(**{flag: True}))


HARNESS_MODULES = (
    "caps_tpu_torch/tck/__init__.py", "caps_tpu_torch/tck/runner.py",
    "caps_tpu_torch/tck/values.py", "caps_tpu_torch/testing/__init__.py",
    "caps_tpu_torch/testing/bag.py", "caps_tpu_torch/testing/factory.py",
    "caps_tpu_torch/datasets/__init__.py", "caps_tpu_torch/datasets/ldbc.py",
)


@pytest.mark.parametrize("module", HARNESS_MODULES)
def test_import_scan_covers_the_harness_modules(module):
    assert ROOT / module in PORT_FILES


def test_tck_corpus_and_list_are_the_ports_own_files():
    from caps_tpu_torch.tck.runner import BLACKLIST, FEATURES_DIR
    own = ROOT / "caps_tpu_torch" / "tck"
    features = sorted(pathlib.Path(FEATURES_DIR).glob("*.feature"))
    assert len(features) == 29
    for path in features + [pathlib.Path(BLACKLIST)]:
        assert not path.is_symlink()
        assert path.resolve().parent.parent == own.resolve()
