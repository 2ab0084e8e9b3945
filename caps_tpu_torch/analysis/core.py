"""capslint core: one shared AST parse of the package, a pass registry,
findings, and inline suppressions.

The framework industrializes the repo's one-off lint scripts
(``scripts/check_serve_errors.py``, ``scripts/check_no_naked_timers.py``)
into a single multi-pass analyzer:

* :func:`load_project` walks ``caps_tpu_torch/`` under a repo root and parses
  every ``.py`` file **once**; all passes share the resulting
  :class:`Source` trees (one parse per run, however many passes run).
* Passes are plain functions ``fn(project) -> list[Finding]`` registered
  with :func:`analysis_pass`; :func:`run_passes` runs them in
  registration order and filters findings through inline suppressions.
* A finding on a line carrying ``# capslint: disable=<pass>`` (or
  ``disable=all``; comma-separate several pass names) is suppressed.

Everything is pure-AST — the analyzer never imports the code it checks,
so it runs before any heavy dependency (torch, numpy) is installed.

The port's copy of ``caps_tpu/analysis``: the same passes, with
:class:`AnalysisConfig` defaulting to this package's directories.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple

_SUPPRESS_RE = re.compile(r"#\s*capslint:\s*disable=([A-Za-z0-9_\-, ]+)")

#: the ``time``-module reads that must route through caps_tpu_torch.obs.clock
#: — ONE set shared by clock-discipline (everywhere) and tracer-purity
#: (inside traced code), so the two passes cannot drift apart
BANNED_TIME_READS = frozenset({
    "perf_counter", "perf_counter_ns", "time", "time_ns", "monotonic",
    "monotonic_ns", "process_time", "process_time_ns", "sleep"})

#: serve/ modules the error-taxonomy pass MUST see — a rename/move that
#: silently drops a module from the walk would turn the check vacuous
#: for it, so a missing expected file is a finding, not a skip (carried
#: over from scripts/check_serve_errors.py).
DEFAULT_SERVE_MODULES = frozenset({
    "__init__.py", "admission.py", "batcher.py", "breaker.py",
    "compaction.py", "deadline.py", "devices.py", "errors.py",
    "failure.py", "fleet.py", "ha.py", "request.py", "retry.py",
    "router.py", "server.py", "shards.py", "warmup.py", "wire.py",
})


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation: repo-relative path, 1-based line, the pass that
    produced it, and a human message."""

    path: str
    line: int
    pass_name: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_name}] {self.message}"

    def as_dict(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line,
                "pass": self.pass_name, "message": self.message}


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """Repo-shape knobs.  The defaults describe THIS repo; the fixture
    tests (tests/test_analysis.py) override them to point passes at
    synthetic trees."""

    #: package directory (relative to the project root) that gets parsed
    package_dir: str = "caps_tpu_torch"
    #: where locks live: the lock-order pass builds its graph from these
    lock_dirs: Tuple[str, ...] = (
        "caps_tpu_torch/serve", "caps_tpu_torch/obs", "caps_tpu_torch/relational",
        "caps_tpu_torch/okapi", "caps_tpu_torch/durability",
        "caps_tpu_torch/testing/faults.py", "caps_tpu_torch/testing/chaos.py")
    #: the one sanctioned time source (exempt from clock-discipline)
    clock_exempt: Tuple[str, ...] = ("caps_tpu_torch/obs/clock.py",)
    #: modules the clock-discipline pass MUST see — same vacuity guard
    #: as ``expected_serve_modules``: a rename/move that dropped one of
    #: these from the walk would silently stop checking code whose
    #: correctness DEPENDS on the sanctioned clock (the result cache's
    #: recency decay must tick on ``obs.clock`` or fake-clock tests and
    #: production disagree)
    expected_clock_modules: frozenset = frozenset({
        "caps_tpu_torch/relational/result_cache.py"})
    #: serving tier (error-taxonomy scope)
    serve_dir: str = "caps_tpu_torch/serve"
    errors_rel: str = "caps_tpu_torch/serve/errors.py"
    serve_error_base: str = "ServeError"
    expected_serve_modules: frozenset = DEFAULT_SERVE_MODULES
    #: functions (defined in ``errors_rel``) whose return value is
    #: always a ServeError — ``raise factory(...)`` satisfies E1 (the
    #: wire layer rebuilds remote typed errors this way)
    error_factories: frozenset = frozenset({"error_from_payload"})
    #: (rel path, function qualname) roots whose same-module call closure
    #: must reach a ``classify(...)`` call (the worker path routes every
    #: execution failure through the serve/failure.py taxonomy)
    worker_roots: Tuple[Tuple[str, str], ...] = (
        ("caps_tpu_torch/serve/server.py", "QueryServer._worker_loop"),)
    classify_sinks: frozenset = frozenset({"classify"})
    #: exception attributes the containment machinery may stamp
    #: (first-writer-wins) — anything else assigned onto a caught
    #: exception is a mutation violation
    exception_markers: frozenset = frozenset({
        "caps_failed_op", "caps_device_index", "caps_transient",
        "caps_device_fault", "caps_shard_member", "caps_wcoj_fault",
        "caps_algo_fault", "caps_stale_cache", "caps_wal_fault",
        "caps_chaos_fault"})
    #: sanctioned first segments of dotted metric names
    metric_prefixes: frozenset = frozenset({
        "plan_cache", "query", "session", "ops", "serve", "collectives",
        "faults", "fused", "dist_join", "obs", "backend", "tracer",
        "updates", "compaction", "telemetry", "slo", "opstats",
        "compile", "mem", "slowlog", "warmup", "bucket", "planstore",
        "cost", "stats", "replan", "shard", "paging", "wcoj",
        "fleet", "router", "wire", "rescache", "algo", "wal",
        "chaos"})
    #: the structured event log module (obs/log.py) and the correlation
    #: fields every emit site must pass — the structured-log pass's
    #: contract (a missing module is a finding, not a silent skip)
    structured_log_rel: str = "caps_tpu_torch/obs/log.py"
    structured_log_fields: Tuple[str, ...] = ("request_id", "family")
    #: extra tracer-purity roots: every method with one of these names in
    #: the listed dirs is treated as reached by the fused record path
    #: (operator ``_compute`` bodies are recorded and replayed — clock
    #: reads, RNG, or module-state mutation there breaks replayability)
    purity_method_roots: Tuple[str, ...] = ("_compute",)
    purity_method_dirs: Tuple[str, ...] = (
        "caps_tpu_torch/relational", "caps_tpu_torch/backends", "caps_tpu_torch/algo")
    #: modules whose every function is a purity root: the device
    #: programs the fused record path runs (the port's counterpart of the
    #: reference's ``@jax.jit`` kernels, which carry no decorator here)
    purity_module_roots: Tuple[str, ...] = (
        "caps_tpu_torch/ops/wcoj.py", "caps_tpu_torch/ops/expand.py",
        "caps_tpu_torch/ops/segment.py", "caps_tpu_torch/ops/sort.py",
        "caps_tpu_torch/ops/prefetch.py",
        "caps_tpu_torch/backends/cuda/kernels.py",
        "caps_tpu_torch/algo/fixpoint.py")
    #: the generated metrics registry document (drift-checked in CI);
    #: the port's own (``docs/metrics.md`` is the JAX package's)
    metrics_doc_rel: str = "caps_tpu_torch/analysis/metrics.md"


class Source:
    """One parsed file: text, lines, AST, and suppression table."""

    def __init__(self, root: str, rel: str):
        self.rel = rel.replace(os.sep, "/")
        self.path = os.path.join(root, rel)
        with open(self.path, encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=self.rel)
        #: dotted module path relative to the project root
        self.module = self.rel[:-3].replace("/", ".")
        #: short module name — the lock-order passes' node prefix
        self.modname = os.path.basename(self.rel)[:-3]
        self._suppress: Dict[int, frozenset] = {}
        for lineno, line in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(line)
            if m:
                names = frozenset(p.strip() for p in m.group(1).split(",")
                                  if p.strip())
                self._suppress[lineno] = names

    def suppressed(self, line: int, pass_name: str) -> bool:
        names = self._suppress.get(line)
        return bool(names) and ("all" in names or pass_name in names)

    def in_dirs(self, prefixes: Iterable[str]) -> bool:
        for p in prefixes:
            p = p.rstrip("/")
            if self.rel == p or self.rel.startswith(p + "/"):
                return True
        return False


class Project:
    """The shared parse: every source of ``config.package_dir`` under
    ``root``, parsed exactly once."""

    def __init__(self, root: str, config: Optional[AnalysisConfig] = None):
        self.root = os.path.abspath(root)
        self.config = config or AnalysisConfig()
        self.sources: List[Source] = []
        self.parse_failures: List[Finding] = []
        pkg = os.path.join(self.root, self.config.package_dir)
        for dirpath, dirnames, filenames in os.walk(pkg):
            dirnames.sort()
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fname in sorted(filenames):
                if not fname.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fname),
                                      self.root)
                try:
                    self.sources.append(Source(self.root, rel))
                except SyntaxError as ex:
                    self.parse_failures.append(Finding(
                        rel.replace(os.sep, "/"), ex.lineno or 1, "parse",
                        f"does not parse: {ex.msg}"))
        self._by_rel = {s.rel: s for s in self.sources}

    def source(self, rel: str) -> Optional[Source]:
        return self._by_rel.get(rel)

    def sources_under(self, *prefixes: str) -> List[Source]:
        return [s for s in self.sources if s.in_dirs(prefixes)]


# -- pass registry -----------------------------------------------------------

PassFn = Callable[[Project], List[Finding]]
_PASSES: "Dict[str, Tuple[PassFn, str]]" = {}


def analysis_pass(name: str, description: str):
    """Register ``fn(project) -> [Finding]`` under ``name``."""
    def deco(fn: PassFn) -> PassFn:
        _PASSES[name] = (fn, description)
        return fn
    return deco


def pass_names() -> List[str]:
    return list(_PASSES)


def pass_descriptions() -> List[Tuple[str, str]]:
    return [(name, desc) for name, (_fn, desc) in _PASSES.items()]


def load_project(root: Optional[str] = None,
                 config: Optional[AnalysisConfig] = None) -> Project:
    """Parse the package once.  ``root=None`` resolves the repo root
    from this package's own location (works from a checkout and from an
    installed console script)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    return Project(root, config)


def run_passes(project: Project,
               only: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run (selected) passes over the shared parse; suppressed findings
    are dropped, the rest come back sorted by (path, line)."""
    selected = list(_PASSES) if only is None else list(only)
    unknown = [n for n in selected if n not in _PASSES]
    if unknown:
        raise KeyError(f"unknown pass(es): {', '.join(unknown)} "
                       f"(have: {', '.join(_PASSES)})")
    findings: List[Finding] = list(project.parse_failures)
    for name in selected:
        fn, _desc = _PASSES[name]
        for f in fn(project):
            src = project.source(f.path)
            if src is not None and src.suppressed(f.line, f.pass_name):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.pass_name, f.message))
    return findings


# -- small AST helpers shared by the passes ----------------------------------

def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    """The last component of a Name/Attribute chain (``c`` of ``a.b.c``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def walk_functions(tree: ast.AST):
    """Yield ``(qualname, FunctionDef, enclosing ClassDef or None)`` for
    every function in the module, methods as ``Class.method`` and nested
    functions as ``outer.<locals>.inner``."""
    def visit(node, prefix, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = prefix + child.name
                yield qual, child, cls
                yield from visit(child, qual + ".<locals>.", cls)
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, prefix + child.name + ".", child)
            else:
                yield from visit(child, prefix, cls)
    yield from visit(tree, "", None)
