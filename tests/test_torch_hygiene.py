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


EXAMPLE_FILES = sorted((ROOT / "examples").glob("torch_*.py"))


def test_every_reference_example_has_a_port():
    reference = sorted(p.name for p in (ROOT / "examples").glob("*.py")
                       if not p.name.startswith("torch_"))
    assert [p.name for p in EXAMPLE_FILES] == [f"torch_{n}"
                                               for n in reference]


@pytest.mark.parametrize("path", EXAMPLE_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_examples_import_no_jax_and_no_jax_package(path):
    test_port_imports_no_jax_and_no_jax_package(path)
    assert "caps_tpu_torch" in set(_imported_modules(path))


def test_local_session_defaults_to_the_card():
    assert inspect.signature(caps_tpu_torch.local_session) \
        .parameters["device"].default == "cuda"
    assert inspect.signature(CUDACypherSession) \
        .parameters["device"].default == "cuda"


def test_the_local_backend_takes_no_device():
    """``backend="local"`` is the pure-Python oracle: it runs on the host
    and refuses a device, named or not; with no arguments the entry
    point still means the card."""
    from caps_tpu_torch.backends.local.session import LocalCypherSession
    for device in ("cuda", "cpu", torch.device("cpu")):
        for backend in ("local", "oracle"):
            with pytest.raises(ValueError, match="takes no device"):
                caps_tpu_torch.local_session(backend=backend, device=device)
    assert isinstance(caps_tpu_torch.local_session(backend="local"),
                      LocalCypherSession)
    if torch.cuda.is_available():
        assert caps_tpu_torch.local_session().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            caps_tpu_torch.local_session()


def test_the_cuda_backend_never_reaches_the_local_one():
    """No module of the device backend, the planner or the operators
    imports ``backends/local``: the CUDA backend has no host fallback.
    The modules that may are the local backend's own, its entry points
    and the test harness."""
    allowed = {"caps_tpu_torch/__init__.py",
               "caps_tpu_torch/testing/sessions.py"}
    for path in PORT_FILES:
        rel = str(path.relative_to(ROOT))
        if rel.startswith("caps_tpu_torch/backends/local/") or rel in allowed:
            continue
        for mod in _imported_modules(path):
            assert not mod.startswith("caps_tpu_torch.backends.local"), \
                f"{rel} imports {mod}"


def _imports_in_functions_only(path, top):
    """Line numbers of imports of ``top`` outside every function (an
    import inside a function is allowed)."""
    bad = []

    def visit(node, in_function):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Import, ast.ImportFrom)) \
                    and not in_function:
                names = [a.name for a in child.names] \
                    if isinstance(child, ast.Import) else [child.module or ""]
                if any(n.split(".")[0] == top for n in names):
                    bad.append(child.lineno)
            visit(child, in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))

    visit(ast.parse(path.read_text(), filename=str(path)), False)
    return bad


def test_pyarrow_only_in_io_fs_and_only_inside_functions():
    """The one exception to the package's torch / numpy / standard
    library rule (ROADMAP): ``pyarrow``, imported lazily by
    ``io/fs.py`` alone.  ``scipy`` is imported by ``chip_smoke.py``'s
    oracle only, inside a function."""
    fs = ROOT / "caps_tpu_torch" / "io" / "fs.py"
    for path in PORT_FILES:
        mods = {m.split(".")[0] for m in _imported_modules(path)}
        if path == fs:
            assert "pyarrow" in mods
        else:
            assert "pyarrow" not in mods, path.relative_to(ROOT)
        if path.name != "chip_smoke.py":
            assert "scipy" not in mods, path.relative_to(ROOT)
    assert _imports_in_functions_only(fs, "pyarrow") == []
    assert _imports_in_functions_only(ROOT / "chip_smoke.py", "scipy") == []


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


def _small_graph():
    s = caps_tpu_torch.local_session(device="cpu")
    return graph_from_numpy(
        s, {"Person": {"_id": np.arange(3, dtype=np.int64),
                       "age": np.arange(3, dtype=np.int64)}},
        {"KNOWS": {"_id": np.arange(3, 5, dtype=np.int64),
                   "_src": np.array([0, 1], dtype=np.int64),
                   "_tgt": np.array([1, 2], dtype=np.int64)}})


_SMALL_CREATE = ("CREATE (a:Person {age: 0})-[:KNOWS]->(b:Person {age: 1}), "
                 "(b)-[:KNOWS]->(c:Person {age: 2})")


def _graph_bags(graph):
    """(nodes, relationships) of a graph as sorted plain tuples."""
    nodes = sorted((i, tuple(sorted(lbls)), tuple(sorted(p.items())))
                   for i, (lbls, p) in graph.node_lookup().items())
    rels = sorted((i, s, t, typ, tuple(sorted(p.items())))
                  for i, (s, t, typ, p) in graph.rel_lookup().items())
    return nodes, rels


@pytest.mark.parametrize("query,ported", [
    # var-length patterns run, and (since CONSTRUCT is ported) so does a
    # graph built from their matches: it equals the JAX package's
    ("MATCH (a:Person)-[:KNOWS*1..2]->(b) CONSTRUCT NEW (b) RETURN GRAPH",
     True),
    # CALL procedures are ported too: the rows equal the JAX package's
    ("CALL algo.pagerank() YIELD node, score RETURN node, score "
     "ORDER BY node", True),
], ids=["construct_after_var_length", "procedure"])
def test_unported_features_raise(query, ported):
    if not ported:
        with pytest.raises(NotImplementedError, match="see ROADMAP"):
            _small_graph().cypher(query)
        return
    from caps_tpu.backends.tpu.session import TPUCypherSession
    from caps_tpu.testing.factory import create_graph as jax_create
    from caps_tpu_torch.testing.factory import create_graph
    port = create_graph(caps_tpu_torch.local_session(device="cpu"),
                        _SMALL_CREATE).cypher(query)
    ref = jax_create(TPUCypherSession(), _SMALL_CREATE).cypher(query)
    if query.startswith("CALL"):
        rows = port.records.to_maps()
        assert rows == ref.records.to_maps() and len(rows) == 3
        return
    assert _graph_bags(port.graph) == _graph_bags(ref.graph)
    assert len(_graph_bags(port.graph)[0]) == 2  # each matched b, once


def test_update_on_a_plain_graph_raises_update_error():
    """Updates are ported: on a plain (not versioned) graph a write is
    refused as in the JAX package, and nothing is created."""
    from caps_tpu_torch.relational.updates import UpdateError
    g = _small_graph()
    with pytest.raises(UpdateError, match="versioned graph"):
        g.cypher("CREATE (:Person {age: 1})")
    assert g.cypher("MATCH (p:Person) RETURN count(*) AS c") \
        .records.to_maps() == [{"c": 3}]


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


SLICE_MODULES = (
    "caps_tpu_torch/obs/__init__.py", "caps_tpu_torch/obs/telemetry.py",
    "caps_tpu_torch/relational/stats.py", "caps_tpu_torch/relational/cost.py",
    "caps_tpu_torch/relational/wcoj.py", "caps_tpu_torch/ops/wcoj.py",
    "caps_tpu_torch/datasets/patterns.py",
)


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_import_scan_covers_the_cost_model_and_wcoj_modules(module):
    assert ROOT / module in PORT_FILES


ALGO_NATIVE_MODULES = (
    "caps_tpu_torch/algo/__init__.py", "caps_tpu_torch/algo/registry.py",
    "caps_tpu_torch/algo/kernels.py", "caps_tpu_torch/algo/fixpoint.py",
    "caps_tpu_torch/algo/op.py", "caps_tpu_torch/native/__init__.py",
)


@pytest.mark.parametrize("module", ALGO_NATIVE_MODULES)
def test_import_scan_covers_the_algo_and_native_modules(module):
    assert ROOT / module in PORT_FILES


TOOLING_MODULES = (
    "caps_tpu_torch/backends/local/__init__.py",
    "caps_tpu_torch/backends/local/table.py",
    "caps_tpu_torch/backends/local/expr.py",
    "caps_tpu_torch/backends/local/session.py",
    "caps_tpu_torch/io/__init__.py", "caps_tpu_torch/io/fs.py",
    "caps_tpu_torch/datasets/graph500.py",
    "caps_tpu_torch/testing/sessions.py", "caps_tpu_torch/testing/suites.py",
    "caps_tpu_torch/analysis/__init__.py",
    "caps_tpu_torch/analysis/__main__.py",
    "caps_tpu_torch/analysis/core.py", "caps_tpu_torch/analysis/locks.py",
    "caps_tpu_torch/analysis/purity.py",
    "caps_tpu_torch/analysis/taxonomy.py",
    "caps_tpu_torch/analysis/clocks.py",
    "caps_tpu_torch/analysis/metric_names.py",
    "caps_tpu_torch/analysis/structlog.py",
)


@pytest.mark.parametrize("module", TOOLING_MODULES)
def test_import_scan_covers_the_oracle_io_and_tooling_modules(module):
    assert ROOT / module in PORT_FILES


def test_native_source_is_the_ports_own_copy():
    """The C++ host runtime the port builds lives under the port's tree
    (not a link to the JAX package's), builds its own module name, and
    builds into the port's gitignored ``_build``."""
    from caps_tpu_torch import native
    src = pathlib.Path(native._SRC)
    own = ROOT / "caps_tpu_torch" / "native" / "csrc" / "host_runtime.cpp"
    assert src == own and not src.is_symlink()
    assert src.resolve().parent.parent == (ROOT / "caps_tpu_torch" /
                                           "native").resolve()
    text = src.read_text()
    assert "PyInit__caps_torch_host" in text
    assert "caps_tpu/backends" not in text
    assert pathlib.Path(native.so_path()).parent == \
        ROOT / "caps_tpu_torch" / "native" / "_build"
    assert "caps_tpu_torch/native/_build/" in \
        (ROOT / ".gitignore").read_text().split()


def test_cost_model_wcoj_and_replan_are_on_by_default():
    """The port plans as the JAX package does by default: the cost
    model, WCOJ, re-planning and the distributed join on; no flag is
    refused."""
    from caps_tpu_torch.okapi.config import EngineConfig
    cfg = EngineConfig()
    assert cfg.use_cost_model and cfg.use_wcoj and cfg.use_dist_join
    assert cfg.replan_threshold == 2
    assert EngineConfig.UNPORTED_FLAGS == ()
    s = caps_tpu_torch.local_session(device="cpu")
    assert s.supports_wcoj


# -- named locks --------------------------------------------------------------

_LOCKGRAPH_CALLS = ("make_lock", "make_rlock", "make_condition")
_PLAIN_LOCKS = ("Lock", "RLock", "Condition")


def _reference_names_its_locks(port_path) -> bool:
    ref = ROOT / "caps_tpu" / port_path.relative_to(ROOT / "caps_tpu_torch")
    if not ref.exists():
        return False
    tree = ast.parse(ref.read_text(), filename=str(ref))
    return any(isinstance(n, ast.Call) and (
        getattr(n.func, "id", None) in _LOCKGRAPH_CALLS
        or getattr(n.func, "attr", None) in _LOCKGRAPH_CALLS)
        for n in ast.walk(tree))


LOCKED_MODULES = [p for p in sorted((ROOT / "caps_tpu_torch").rglob("*.py"))
                  if _reference_names_its_locks(p)]


def test_lock_scan_covers_the_modules_with_locks():
    names = {str(p.relative_to(ROOT)) for p in LOCKED_MODULES}
    for module in ("okapi/catalog.py", "relational/plan_cache.py",
                   "relational/shapes.py", "relational/updates.py",
                   "obs/telemetry.py", "obs/metrics.py", "obs/tracer.py",
                   "obs/compile.py", "obs/ledger.py", "testing/faults.py",
                   "obs/log.py", "relational/result_cache.py",
                   "relational/session.py", *SERVE_LOCKED):
        assert f"caps_tpu_torch/{module}" in names


@pytest.mark.parametrize("path", LOCKED_MODULES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_names_its_locks_where_the_reference_does(path):
    """A module whose reference counterpart takes its locks from
    ``obs/lockgraph.py`` creates no plain ``threading`` lock: every lock
    there has the reference's name, so the lock-order graph sees it."""
    def is_plain(node):
        return (isinstance(node, ast.Attribute) and node.attr in _PLAIN_LOCKS
                and isinstance(node.value, ast.Name)
                and node.value.id == "threading")

    tree = ast.parse(path.read_text(), filename=str(path))
    # a call, or a factory handed on (``default_factory=threading.Lock``);
    # an annotation creates nothing
    plain = [n.lineno for n in ast.walk(tree)
             if (isinstance(n, ast.Call) and is_plain(n.func))
             or (isinstance(n, ast.keyword) and is_plain(n.value))]
    assert not plain, f"{path.relative_to(ROOT)}: plain locks at {plain}"


# -- the serving tier ---------------------------------------------------------

SERVE_MODULES = (
    "__init__.py", "admission.py", "batcher.py", "breaker.py",
    "compaction.py", "deadline.py", "devices.py", "errors.py", "failure.py",
    "request.py", "retry.py", "server.py", "warmup.py",
    "wire.py", "fleet.py", "router.py", "ha.py",
)
#: the serve modules whose reference takes locks from obs/lockgraph.py
SERVE_LOCKED = ("serve/admission.py", "serve/breaker.py",
                "serve/devices.py", "serve/server.py", "serve/warmup.py")
SERVE_RELATIONAL = ("relational/construct.py", "relational/result_cache.py",
                    "relational/plan_store.py", "obs/log.py",
                    "durability/__init__.py", "durability/wal.py",
                    "durability/lease.py", "testing/chaos.py")


@pytest.mark.parametrize("module", [f"caps_tpu_torch/serve/{m}"
                                    for m in SERVE_MODULES]
                         + [f"caps_tpu_torch/{m}" for m in SERVE_RELATIONAL])
def test_import_scan_covers_the_serving_modules(module):
    assert ROOT / module in PORT_FILES


_TIMERS = {("time", "perf_counter"), ("time", "time"), ("time", "sleep"),
           ("time", "monotonic")}
TIMED_DIRS = ("serve", "obs", "relational", "algo", "durability")
TIMED_FILES = [p for d in TIMED_DIRS
               for p in sorted((ROOT / "caps_tpu_torch" / d).rglob("*.py"))
               if p.name != "clock.py" or d != "obs"]


@pytest.mark.parametrize("path", TIMED_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_naked_timers_outside_the_clock(path):
    """As ``scripts/check_no_naked_timers.py`` requires of the JAX
    package: under ``serve/``, ``obs/`` and ``relational/`` time is read,
    and waited for, only through ``obs/clock.py`` — so tests can drive
    backoff, cooldown and window expiry on a fake clock."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and isinstance(node.value,
                                                          ast.Name) \
                and (node.value.id, node.attr) in _TIMERS:
            bad.append(node.lineno)
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            bad.extend(node.lineno for a in node.names
                       if ("time", a.name) in _TIMERS)
    assert not bad, f"{path.relative_to(ROOT)}: naked timers at {bad}"


def test_timer_scan_covers_the_serving_tier():
    names = {str(p.relative_to(ROOT)) for p in TIMED_FILES}
    assert {"caps_tpu_torch/serve/server.py", "caps_tpu_torch/serve/retry.py",
            "caps_tpu_torch/obs/telemetry.py",
            "caps_tpu_torch/relational/result_cache.py",
            "caps_tpu_torch/serve/fleet.py",
            "caps_tpu_torch/durability/lease.py"} <= names
    assert "caps_tpu_torch/obs/clock.py" not in names
