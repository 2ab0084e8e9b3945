"""capslint ``clock-discipline``: one sanctioned time source.

AST-based replacement for the ``scripts/check_no_naked_timers.py``
regex.  Every timing read inside ``caps_tpu_torch/`` must go through
``caps_tpu_torch.obs.clock`` (one monotonic base for spans, operator metrics,
trace exports — and one seam for fake clocks in tests).  The regex
matched ``time.perf_counter(`` textually, which caught aliased module
imports (``import time as _t; _t.perf_counter()``) but NOT name
imports: ``from time import perf_counter`` rebinds the function so no
``time.`` attribute access ever appears.  This pass closes that hole by
resolving imports:

* ``from time import <timer> [as x]`` outside the clock module is a
  finding at the import (whatever the name is later called as);
* any attribute access ``<alias>.<timer>`` where ``<alias>`` binds the
  ``time`` module (however it was imported) is a finding, call or not —
  ``now = _time.perf_counter`` re-exports the naked timer and is
  exactly how obs/clock.py itself is built, which is why that file is
  the one exemption.
"""
from __future__ import annotations

import ast
from typing import List, Set

from caps_tpu_torch.analysis.core import (BANNED_TIME_READS, Finding, Project,
                                    analysis_pass, dotted)

PASS = "clock-discipline"

#: shared with tracer-purity via core.BANNED_TIME_READS
BANNED = BANNED_TIME_READS


@analysis_pass(PASS, "no naked time.* reads outside caps_tpu_torch.obs.clock "
                     "(closes the `from time import perf_counter` hole)")
def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    exempt = set(project.config.clock_exempt)
    # vacuity guard (same contract as the error-taxonomy pass's expected
    # module set): a pinned module that fell out of the walk means the
    # check silently stopped covering code whose correctness depends on
    # the sanctioned clock — finding, not skip
    for rel in sorted(project.config.expected_clock_modules):
        if project.source(rel) is None:
            findings.append(Finding(
                rel, 1, PASS,
                f"expected module {rel!r} is missing from the analyzed "
                f"tree — clock-discipline coverage went vacuous for it "
                f"(renamed/moved? update AnalysisConfig"
                f".expected_clock_modules)"))
    for src in project.sources:
        if src.in_dirs(exempt):
            continue
        time_aliases: Set[str] = set()
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        time_aliases.add(a.asname or "time")
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name in BANNED:
                        findings.append(Finding(
                            src.rel, node.lineno, PASS,
                            f"`from time import {a.name}"
                            f"{' as ' + a.asname if a.asname else ''}` — "
                            f"naked timer import (use caps_tpu_torch.obs.clock; "
                            f"the old regex lint missed this form)"))
                    elif a.name == "*":
                        findings.append(Finding(
                            src.rel, node.lineno, PASS,
                            "`from time import *` pulls every naked "
                            "timer into the module namespace"))
        if not time_aliases:
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Attribute):
                continue
            d = dotted(node)
            if d is None:
                continue
            head, _, rest = d.partition(".")
            if head in time_aliases and rest in BANNED:
                findings.append(Finding(
                    src.rel, node.lineno, PASS,
                    f"naked timer {d!r} (use caps_tpu_torch.obs.clock — the "
                    f"single monotonic base all spans/exports share)"))
    return findings
