"""capslint ``tracer-purity``: the replayability fence, machine-checked.

Code that runs under a jax trace — ``@jax.jit`` bodies, functions handed
to ``jax.jit(...)`` / ``shard_map(...)`` / ``pl.pallas_call(...)``, and
the operator ``_compute`` bodies the fused executor records and replays
(a recorded size stream is only sound if re-running the program
reproduces it) — must be **pure**:

* no clock reads (``time.*``, ``caps_tpu_torch.obs.clock.*``): inside a trace
  they bake one host timestamp into the compiled program; on the fused
  record path they make the recording diverge from the replay;
* no RNG (``random``/``numpy.random`` — ``jax.random`` with an explicit
  key is deterministic and allowed);
* no mutation of module-level state (``global`` writes, mutating method
  calls on module-level names): a record run that changes module state
  executes a different program than its replays.

Reachability: from each root, the same-module call closure (plain-name
calls and ``self.`` method calls) — the same resolution depth the
lock-order pass uses.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from caps_tpu_torch.analysis.core import (BANNED_TIME_READS, Finding, Project,
                                    Source, analysis_pass, dotted,
                                    terminal_name, walk_functions)

PASS = "tracer-purity"

_JIT_WRAPPERS = frozenset({"jit", "pjit", "pmap", "shard_map",
                           "pallas_call"})
#: shared with clock-discipline via core.BANNED_TIME_READS
_BANNED_TIME = BANNED_TIME_READS
_CLOCK_FNS = frozenset({"now", "wall", "sleep", "wait"})
_MUTATORS = frozenset({
    "append", "extend", "insert", "add", "update", "setdefault", "pop",
    "popitem", "remove", "discard", "clear", "appendleft", "inc", "set",
    "observe"})


class _ModuleImports:
    """Aliases of the modules the purity rules care about."""

    def __init__(self, tree: ast.AST):
        self.time_aliases: Set[str] = set()
        self.time_names: Dict[str, str] = {}      # local -> time fn
        self.random_aliases: Set[str] = set()
        self.numpy_aliases: Set[str] = set()
        self.clock_aliases: Set[str] = set()
        self.clock_names: Dict[str, str] = {}     # local -> clock fn
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    if a.name == "time":
                        self.time_aliases.add(a.asname or "time")
                    elif a.name == "random":
                        self.random_aliases.add(a.asname or "random")
                    elif a.name in ("numpy", "numpy.random"):
                        self.numpy_aliases.add(local)
                    elif a.name == "caps_tpu_torch.obs.clock":
                        self.clock_aliases.add(a.asname or "clock")
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for a in node.names:
                    local = a.asname or a.name
                    if mod == "time" and a.name in _BANNED_TIME:
                        self.time_names[local] = a.name
                    elif mod == "numpy" and a.name == "random":
                        self.numpy_aliases.add(local)
                    elif mod.endswith("obs") and a.name == "clock":
                        self.clock_aliases.add(local)
                    elif mod.endswith("obs.clock") and a.name in _CLOCK_FNS:
                        self.clock_names[local] = a.name


def _collect_roots(src: Source, method_roots, method_dirs,
                   module_roots=()) -> List[Tuple[str, ast.AST]]:
    """(reason, FunctionDef) purity roots in one module."""
    roots: List[Tuple[str, ast.AST]] = []
    fns = list(walk_functions(src.tree))
    if src.in_dirs(module_roots):
        return [("device program", fn) for _qual, fn, _cls in fns]
    by_name: Dict[str, List[ast.AST]] = {}
    for _qual, fn, _cls in fns:
        by_name.setdefault(fn.name, []).append(fn)

    def is_jit_decorator(dec: ast.AST) -> bool:
        if terminal_name(dec) in _JIT_WRAPPERS:
            return True
        if isinstance(dec, ast.Call):
            if terminal_name(dec.func) in _JIT_WRAPPERS:
                return True
            if terminal_name(dec.func) == "partial" and dec.args and \
                    terminal_name(dec.args[0]) in _JIT_WRAPPERS:
                return True
        return False

    for _qual, fn, _cls in fns:
        if any(is_jit_decorator(d) for d in fn.decorator_list):
            roots.append(("jit-decorated", fn))
        elif fn.name in method_roots and src.in_dirs(method_dirs):
            roots.append(("fused record path (_compute)", fn))
    # jax.jit(f) / shard_map(f, ...) / pallas_call(kernel, ...) where f
    # is a plain name defined in this module
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call) and \
                terminal_name(node.func) in _JIT_WRAPPERS and node.args \
                and isinstance(node.args[0], ast.Name):
            for fn in by_name.get(node.args[0].id, ()):
                roots.append((f"passed to {terminal_name(node.func)}", fn))
    return roots


def _closure(src: Source, roots: List[Tuple[str, ast.AST]]
             ) -> Dict[int, Tuple[str, ast.AST]]:
    """Same-module call closure from the roots, id(node)-keyed."""
    fns = list(walk_functions(src.tree))
    by_name: Dict[str, List[ast.AST]] = {}
    methods: Dict[str, List[ast.AST]] = {}
    for _qual, fn, cls in fns:
        by_name.setdefault(fn.name, []).append(fn)
        if cls is not None:
            methods.setdefault(fn.name, []).append(fn)
    reached: Dict[int, Tuple[str, ast.AST]] = {}
    work = list(roots)
    while work:
        reason, fn = work.pop()
        if id(fn) in reached:
            continue
        reached[id(fn)] = (reason, fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callees: List[ast.AST] = []
            if isinstance(node.func, ast.Name):
                callees = by_name.get(node.func.id, [])
            elif isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "self":
                callees = methods.get(node.func.attr, [])
            for callee in callees:
                if id(callee) not in reached:
                    # propagate the ROOT reason, not a nested chain
                    work.append((reason, callee))
    return reached


def _module_level_names(tree: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def _shallow_walk(fn: ast.AST):
    """Every node of ``fn``'s body, NOT descending into nested
    def/class statements (those are reached — and checked — separately
    when something in the closure calls them)."""
    work = list(ast.iter_child_nodes(fn))
    while work:
        node = work.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        work.extend(ast.iter_child_nodes(node))


def _check_function(fn: ast.AST, reason: str, src: Source,
                    imports: _ModuleImports, module_names: Set[str],
                    findings: List[Finding]) -> None:
    local_names: Set[str] = {a.arg for a in fn.args.args}
    local_names.update(a.arg for a in fn.args.kwonlyargs)
    # two sweeps: _shallow_walk yields in stack order, not source order,
    # so every `global` declaration must be known BEFORE any assignment
    # is judged against it
    global_decls: Set[str] = set()
    for node in _shallow_walk(fn):
        if isinstance(node, ast.Global):
            global_decls.update(node.names)
    for node in _shallow_walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    if tgt.id in global_decls:
                        findings.append(Finding(
                            src.rel, node.lineno, PASS,
                            f"writes module-level {tgt.id!r} inside "
                            f"traced code ({reason}) — record/replay "
                            f"would diverge"))
                    else:
                        local_names.add(tgt.id)

    def flag(node, what):
        findings.append(Finding(
            src.rel, node.lineno, PASS,
            f"{what} inside traced code ({reason}) — the replayability "
            f"fence forbids it"))

    def check_chain(node: ast.Attribute) -> None:
        d = dotted(node)
        if d is None:
            return
        head, _, rest = d.partition(".")
        leaf = d.rsplit(".", 1)[-1]
        if head in imports.time_aliases and leaf in _BANNED_TIME:
            flag(node, f"clock read {d!r}")
        elif head in imports.clock_aliases and \
                rest.split(".")[0] in _CLOCK_FNS:
            flag(node, f"clock read {d!r}")
        elif head in imports.random_aliases:
            flag(node, f"RNG {d!r}")
        elif head in imports.numpy_aliases and \
                rest.split(".")[0] == "random" and rest != "random":
            flag(node, f"RNG {d!r}")

    seen_chains: Set[int] = set()
    for node in _shallow_walk(fn):
        if isinstance(node, ast.Attribute):
            if id(node) in seen_chains:
                continue
            # mark the sub-chain so `np.random.rand` doesn't also
            # report its inner `np.random` attribute node
            inner = node.value
            while isinstance(inner, ast.Attribute):
                seen_chains.add(id(inner))
                inner = inner.value
            check_chain(node)
        elif isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name):
                nm = node.func.id
                if nm in imports.time_names:
                    flag(node, f"clock read "
                               f"{imports.time_names[nm]!r} "
                               f"(from-imported as {nm!r})")
                elif nm in imports.clock_names:
                    flag(node, f"clock read 'clock."
                               f"{imports.clock_names[nm]}' "
                               f"(from-imported as {nm!r})")
            elif isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.attr in _MUTATORS and \
                    node.func.value.id in module_names and \
                    node.func.value.id not in local_names:
                flag(node, f"mutates module-level "
                           f"{node.func.value.id!r} "
                           f"(.{node.func.attr}())")


def traced_functions(project: Project) -> List[Tuple[str, str]]:
    """(path, function name) of every function the purity closure
    reaches — the discovered jit/pallas/fused-record root set plus its
    same-module call closure.  Exposed so tests can assert REACHABILITY
    (e.g. that a new kernel layer's probes are actually checked), not
    just the absence of findings."""
    cfg = project.config
    out: List[Tuple[str, str]] = []
    for src in project.sources:
        roots = _collect_roots(src, cfg.purity_method_roots,
                               cfg.purity_method_dirs,
                               cfg.purity_module_roots)
        if not roots:
            continue
        for _reason, fn in _closure(src, roots).values():
            out.append((src.rel, fn.name))
    return out


@analysis_pass(PASS, "no clock reads, RNG, or module-state mutation "
                     "inside jit/shard_map/fused-record-path code")
def check(project: Project) -> List[Finding]:
    cfg = project.config
    findings: List[Finding] = []
    for src in project.sources:
        roots = _collect_roots(src, cfg.purity_method_roots,
                               cfg.purity_method_dirs,
                               cfg.purity_module_roots)
        if not roots:
            continue
        imports = _ModuleImports(src.tree)
        module_names = _module_level_names(src.tree)
        for reason, fn in _closure(src, roots).values():
            _check_function(fn, reason, src, imports, module_names,
                            findings)
    return findings
