"""capslint ``structured-log``: the event log's correlation contract.

The structured event log (``caps_tpu_torch/obs/log.py``) exists so incidents
can be joined across streams — flight dumps, slow-query records, and
events all correlate by ``request_id`` and ``family``.  An emit site
that forgets either key produces an event nothing can join on, and the
bug only surfaces during the postmortem that needed the join.  This
pass makes the contract static:

* the log module is parsed and every function/method whose
  keyword-only parameters include ALL the required correlation fields
  is collected as an **emit function** (``EventLog.emit`` on the live
  tree);
* every call to one of those names anywhere in the package —
  ``x.emit(...)`` or a bare ``emit(...)`` — must pass each required
  field as an explicit keyword (``request_id=None`` is fine: the field
  is *present*, consumers can still join; a ``**kwargs`` splat is
  accepted as unverifiable);
* a missing or emit-less log module is itself a finding — a rename
  must not silently turn the pass vacuous (same pinning discipline as
  the error-taxonomy module list).
"""
from __future__ import annotations

import ast
from typing import List, Set

from caps_tpu_torch.analysis.core import (Finding, Project, analysis_pass,
                                    terminal_name, walk_functions)

PASS = "structured-log"


def _emit_function_names(project: Project) -> Set[str]:
    """Names of log-module functions whose keyword-only parameters
    include every required correlation field."""
    cfg = project.config
    src = project.source(cfg.structured_log_rel)
    if src is None:
        return set()
    required = set(cfg.structured_log_fields)
    names: Set[str] = set()
    for qual, fn, _cls in walk_functions(src.tree):
        kwonly = {a.arg for a in fn.args.kwonlyargs}
        if required <= kwonly:
            names.add(fn.name)
    return names


@analysis_pass(PASS, "every structured-log emit site carries the "
                     "request_id/family correlation fields")
def check(project: Project) -> List[Finding]:
    cfg = project.config
    findings: List[Finding] = []
    if project.source(cfg.structured_log_rel) is None:
        findings.append(Finding(
            cfg.structured_log_rel, 1, PASS,
            f"expected structured-log module {cfg.structured_log_rel!r} "
            f"is missing — the emit-site contract went unchecked"))
        return findings
    emit_names = _emit_function_names(project)
    if not emit_names:
        findings.append(Finding(
            cfg.structured_log_rel, 1, PASS,
            f"no emit function with keyword-only "
            f"{'/'.join(cfg.structured_log_fields)} parameters found in "
            f"{cfg.structured_log_rel!r} — the contract has no anchor"))
        return findings
    required = tuple(cfg.structured_log_fields)
    for src in project.sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = terminal_name(node.func)
            if name not in emit_names:
                continue
            kws = {kw.arg for kw in node.keywords}
            if None in kws:
                continue  # **splat: present-ness is unverifiable
            missing = [f for f in required if f not in kws]
            if missing:
                findings.append(Finding(
                    src.rel, node.lineno, PASS,
                    f"structured-log emit misses correlation field(s) "
                    f"{', '.join(missing)} — pass them explicitly "
                    f"(None is fine) so every event joins on "
                    f"{'/'.join(required)}"))
    return findings
