"""capslint ``error-taxonomy``: the serving tier's failure contract.

Migrates ``scripts/check_serve_errors.py`` into the framework — pure
AST now (no package import, so CI can lint before installing torch) — and
extends it with the serving tier's documented invariants:

* **E1 — one catchable base type**: every ``raise Name(...)`` inside
  ``caps_tpu_torch/serve/`` resolves to a :class:`ServeError` subclass (class
  hierarchy read from ``serve/errors.py`` + per-module imports /
  definitions).  ``__getattr__`` bodies are exempt (the attribute
  protocol requires AttributeError), bare ``raise`` / ``raise variable``
  re-raises are out of scope (the ENGINE's error, not the tier's), and
  ``raise factory(...)`` is sanctioned for the configured error
  factories (``error_from_payload`` — the wire layer rebuilding a
  remote typed error).
  The expected-modules pinning carries over: a serve module missing
  from the walk is a finding, not a silent skip.
* **E2 — exceptions are never mutated**: an attribute assigned onto a
  caught/parameter exception is allowed only for the ``caps_*``
  containment markers, and only first-writer-wins (guarded by a
  ``getattr(exc, marker, None) is None``-style check) or onto a freshly
  constructed exception the function itself built.
* **E3 — no swallowed broad handlers**: an ``except (Base)Exception``
  in serve/ must use what it caught (bind-and-use or re-raise); a
  silent ``pass``/``continue`` body needs an explicit
  ``# pragma: no cover`` (bookkeeping-only) or a capslint suppression.
* **E4 — the worker path classifies**: the same-module call closure of
  ``QueryServer._worker_loop`` must contain a ``classify(...)`` call —
  deleting the taxonomy routing from the worker path is a finding at
  the root.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from caps_tpu_torch.analysis.core import (Finding, Project, Source,
                                    analysis_pass, terminal_name,
                                    walk_functions)

PASS = "error-taxonomy"

import builtins as _builtins

_BUILTIN_EXC = frozenset(vars(_builtins))


def _serve_error_descendants(errors_src: Optional[Source],
                             base: str) -> Set[str]:
    """Transitive subclasses of ``base`` defined in serve/errors.py."""
    if errors_src is None:
        return set()
    parents: Dict[str, List[str]] = {}
    for node in ast.walk(errors_src.tree):
        if isinstance(node, ast.ClassDef):
            parents[node.name] = [terminal_name(b) or "" for b in node.bases]
    out = {base}
    changed = True
    while changed:
        changed = False
        for cls, bases in parents.items():
            if cls not in out and any(b in out for b in bases):
                out.add(cls)
                changed = True
    return out


def _module_error_names(src: Source, serve_errors: Set[str]) -> Set[str]:
    """Names that resolve to a ServeError subclass inside this module:
    imports from the errors module plus locally defined subclasses."""
    ok: Set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            # a known ServeError subclass counts wherever inside the
            # serving package it was imported from — errors.py defines
            # them, but siblings re-export (serve/__init__) and relative
            # imports within serve/ are equally valid provenance (the
            # old importlib-based script resolved these too)
            if node.level > 0 or "serve" in mod.split(".") \
                    or mod.endswith("errors"):
                for a in node.names:
                    if a.name in serve_errors:
                        ok.add(a.asname or a.name)
    changed = True
    while changed:
        changed = False
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef) and node.name not in ok:
                if any((terminal_name(b) or "") in ok for b in node.bases):
                    ok.add(node.name)
                    changed = True
    return ok


def _getattr_exempt_ids(tree: ast.AST) -> Set[int]:
    exempt: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == "__getattr__":
            exempt.update(id(n) for n in ast.walk(node))
    return exempt


def _check_raises(src: Source, serve_errors: Set[str],
                  factories: frozenset,
                  findings: List[Finding]) -> None:
    ok_names = _module_error_names(src, serve_errors) | set(factories)
    exempt = _getattr_exempt_ids(src.tree)
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Raise) or node.exc is None \
                or id(node) in exempt:
            continue
        exc = node.exc
        if isinstance(exc, ast.Call):
            exc = exc.func
        if not isinstance(exc, ast.Name):
            continue  # re-raise of a variable / attribute: out of scope
        name = exc.id
        if name in ok_names:
            continue
        if name in _BUILTIN_EXC or _is_known_class(src, name):
            findings.append(Finding(
                src.rel, node.lineno, PASS,
                f"raises {name}, which does not inherit ServeError "
                f"(clients must be able to catch ONE base type)"))
        else:
            findings.append(Finding(
                src.rel, node.lineno, PASS,
                f"raises unresolvable name {name!r}"))


def _is_known_class(src: Source, name: str) -> bool:
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return True
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                if (a.asname or a.name.split(".")[0]) == name:
                    return True
    return False


# -- E2: exception mutation --------------------------------------------------

_EXC_ANNOTATIONS = frozenset({"BaseException", "Exception"})


def _exception_names(fn: ast.AST) -> Set[str]:
    """Names in ``fn`` known to hold exceptions: ``except ... as e``
    binders plus parameters annotated (Base)Exception."""
    out: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in list(args.args) + list(args.kwonlyargs):
            if a.annotation is not None and \
                    terminal_name(a.annotation) in _EXC_ANNOTATIONS:
                out.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.ExceptHandler) and node.name:
            out.add(node.name)
    return out


def _fresh_names(fn: ast.AST) -> Set[str]:
    """Names assigned from a constructor call inside ``fn`` — stamping a
    marker on an exception you just built is first-writer by
    construction."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _guarded_by_marker(node: ast.AST, fn: ast.AST, marker: str,
                       src: Source) -> bool:
    """True when ``node`` sits inside an ``if`` whose test mentions the
    marker (the ``getattr(exc, marker, None) is None`` idiom)."""
    for outer in ast.walk(fn):
        if isinstance(outer, ast.If) and \
                any(n is node for n in ast.walk(outer)):
            test_src = ast.get_source_segment(src.text, outer.test) or ""
            if marker in test_src:
                return True
    return False


def _check_mutations(src: Source, cfg, findings: List[Finding]) -> None:
    for _qual, fn, _cls in walk_functions(src.tree):
        exc_names = _exception_names(fn)
        if not exc_names:
            continue
        fresh = _fresh_names(fn)
        for node in ast.walk(fn):
            target_attr = None
            target_name = None
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id in exc_names:
                        target_attr, target_name = tgt.attr, tgt.value.id
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id == "setattr" and len(node.args) >= 2 and \
                    isinstance(node.args[0], ast.Name) and \
                    node.args[0].id in exc_names and \
                    isinstance(node.args[1], ast.Constant):
                target_attr = str(node.args[1].value)
                target_name = node.args[0].id
            if target_attr is None:
                continue
            if target_attr not in cfg.exception_markers:
                findings.append(Finding(
                    src.rel, node.lineno, PASS,
                    f"mutates caught exception {target_name!r} "
                    f"(sets .{target_attr}) — exceptions are shared "
                    f"across batch members/retries; attach context to "
                    f"attempt-history dicts instead"))
            elif target_name not in fresh and \
                    not _guarded_by_marker(node, fn, target_attr, src):
                findings.append(Finding(
                    src.rel, node.lineno, PASS,
                    f"marker .{target_attr} stamped on {target_name!r} "
                    f"without a first-writer-wins guard "
                    f"(getattr(..., None) is None)"))


# -- E3: swallowed broad handlers --------------------------------------------

def _catches_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    names: List[str] = []
    if t is None:
        names = ["Exception"]  # bare except
    elif isinstance(t, ast.Tuple):
        names = [terminal_name(e) or "" for e in t.elts]
    else:
        names = [terminal_name(t) or ""]
    return any(n in ("Exception", "BaseException") for n in names)


def _check_handlers(src: Source, findings: List[Finding]) -> None:
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.ExceptHandler) or \
                not _catches_broad(node):
            continue
        line_text = src.lines[node.lineno - 1] \
            if node.lineno - 1 < len(src.lines) else ""
        has_pragma = "pragma: no cover" in line_text
        body_names = {n.id for stmt in node.body
                      for n in ast.walk(stmt) if isinstance(n, ast.Name)}
        has_raise = any(isinstance(n, ast.Raise)
                        for stmt in node.body for n in ast.walk(stmt))
        if node.name and node.name not in body_names and not has_raise:
            findings.append(Finding(
                src.rel, node.lineno, PASS,
                f"broad handler binds {node.name!r} but never uses it — "
                f"a swallowed exception bypasses failure.classify"))
            continue
        body_is_noise = all(isinstance(stmt, (ast.Pass, ast.Continue))
                            for stmt in node.body)
        if node.name is None and body_is_noise and not has_pragma:
            findings.append(Finding(
                src.rel, node.lineno, PASS,
                "broad except swallows everything silently — route "
                "through failure.classify, re-raise, or mark the "
                "bookkeeping path with '# pragma: no cover'"))


# -- E4: worker path reaches classify ----------------------------------------

def _worker_reaches_classify(src: Source, root_qual: str,
                             sinks: frozenset) -> Optional[int]:
    """Line of the root function when its same-module call closure never
    calls a classify sink; None when the invariant holds."""
    fns = {qual: fn for qual, fn, _cls in walk_functions(src.tree)}
    by_simple: Dict[str, List[str]] = {}
    for qual in fns:
        by_simple.setdefault(qual.rsplit(".", 1)[-1], []).append(qual)
    root = fns.get(root_qual)
    if root is None:
        return 1
    seen: Set[str] = set()
    work = [root_qual]
    while work:
        qual = work.pop()
        if qual in seen:
            continue
        seen.add(qual)
        fn = fns[qual]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = None
            if isinstance(node.func, ast.Name):
                name = node.func.id
            elif isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "self":
                name = node.func.attr
            if name is None:
                continue
            if name in sinks:
                return None
            work.extend(q for q in by_simple.get(name, ()))
    return root.lineno


@analysis_pass(PASS, "serve/ raises inherit ServeError; exceptions "
                     "never mutated (caps_* markers first-writer-wins); "
                     "no swallowed broad handlers; worker path "
                     "routes through failure.classify")
def check(project: Project) -> List[Finding]:
    cfg = project.config
    findings: List[Finding] = []
    errors_src = project.source(cfg.errors_rel)
    serve_errors = _serve_error_descendants(errors_src,
                                            cfg.serve_error_base)
    serve_sources = project.sources_under(cfg.serve_dir)
    present = {os.path.basename(s.rel) for s in serve_sources}
    for missing in sorted(cfg.expected_serve_modules - present):
        findings.append(Finding(
            f"{cfg.serve_dir}/{missing}", 1, PASS,
            "expected serve module is MISSING from the lint walk "
            "(moved/renamed? update AnalysisConfig."
            "expected_serve_modules)"))
    if errors_src is None:
        findings.append(Finding(
            cfg.errors_rel, 1, PASS,
            "serve errors module not found — the ServeError hierarchy "
            "cannot be checked"))
        return findings
    for src in serve_sources:
        _check_raises(src, serve_errors, cfg.error_factories, findings)
        _check_handlers(src, findings)
    # mutation discipline holds package-wide (ops.py stamps
    # caps_failed_op, failure.py stamps caps_device_index, ...)
    for src in project.sources:
        _check_mutations(src, cfg, findings)
    for rel, root_qual in cfg.worker_roots:
        src = project.source(rel)
        if src is None:
            findings.append(Finding(rel, 1, PASS,
                                    "worker root module not found"))
            continue
        line = _worker_reaches_classify(src, root_qual, cfg.classify_sinks)
        if line is not None:
            findings.append(Finding(
                src.rel, line, PASS,
                f"{root_qual}'s call closure never reaches "
                f"failure.classify — execution failures are no longer "
                f"routed through the taxonomy"))
    return findings
