"""capslint — the repo's multi-pass static-analysis framework.

The serving tier's correctness rests on invariants no general-purpose
tool checks: a global lock order across ~20 locked files, the
replayability fence around traced code, the ServeError catch-one
contract, the single sanctioned clock, and the metrics registry's
naming rules.  This package machine-checks them:

=================  =========================================================
pass               guards
=================  =========================================================
lock-order         lock-acquisition graph from ``with`` nesting (+ one
                   level of call resolution) over serve/, obs/,
                   relational/, okapi/, testing/faults.py: cycles are
                   potential deadlocks; ``__del__``/atexit acquisition
                   flagged.  Runtime complement: caps_tpu_torch/obs/lockgraph.py
tracer-purity      no clock reads / RNG / module-state mutation inside
                   jax.jit / shard_map / pallas_call / fused-record code
                   (the replayability fence)
error-taxonomy     serve/ raises inherit ServeError; exceptions never
                   mutated beyond first-writer-wins caps_* markers; no
                   swallowed broad handlers; the worker path routes
                   failures through failure.classify
clock-discipline   every timing read goes through caps_tpu_torch.obs.clock —
                   AST-resolved, closing the regex lint's
                   ``from time import perf_counter`` hole
metric-names       dotted-prefix conventions, name->kind uniqueness,
                   histogram snapshot collisions; generates
                   docs/metrics.md (CI drift-checked)
structured-log     every structured-log emit site (obs/log.py contract)
                   carries the request_id/family correlation fields, so
                   events always join with flight dumps and slow-query
                   records
=================  =========================================================

Run ``python -m caps_tpu_torch.analysis`` (or the ``capslint`` console
script).  ``--only a,b`` selects passes, ``--list`` describes them,
``--json`` emits machine-readable findings, and a finding line carrying
``# capslint: disable=<pass>`` is suppressed.  The whole package is
parsed exactly once per run, shared by every pass, and nothing is
imported from the code under analysis.
"""
from __future__ import annotations

from caps_tpu_torch.analysis.core import (AnalysisConfig, Finding, Project,
                                    Source, analysis_pass, load_project,
                                    pass_descriptions, pass_names,
                                    run_passes)

# importing the pass modules registers them (registration order = run
# order = the order the table above documents)
from caps_tpu_torch.analysis import locks as _locks              # noqa: F401
from caps_tpu_torch.analysis import purity as _purity            # noqa: F401
from caps_tpu_torch.analysis import taxonomy as _taxonomy        # noqa: F401
from caps_tpu_torch.analysis import clocks as _clocks            # noqa: F401
from caps_tpu_torch.analysis import metric_names as _metric_names  # noqa: F401
from caps_tpu_torch.analysis import structlog as _structlog      # noqa: F401

from caps_tpu_torch.analysis.metric_names import (check_metrics_doc,
                                            generate_metrics_doc,
                                            write_metrics_doc)

__all__ = [
    "AnalysisConfig", "Finding", "Project", "Source", "analysis_pass",
    "load_project", "pass_descriptions", "pass_names", "run_passes",
    "check_metrics_doc", "generate_metrics_doc", "write_metrics_doc",
    "run_shim",
]


def run_shim(pass_name: str, header: str, clean_message: str,
             root: str = None) -> int:
    """Back-compat entry for the legacy lint scripts
    (scripts/check_serve_errors.py, scripts/check_no_naked_timers.py):
    run ONE pass over the repo, print findings in the scripts' output
    contract (header line + two-space-indented ``path:line: message``),
    return their exit code (0 clean / 1 findings).  Files that fail to
    parse are reported under their own header, not misattributed as
    pass findings."""
    project = load_project(root)
    findings = run_passes(project, only=[pass_name])
    parse = [f for f in findings if f.pass_name == "parse"]
    rest = [f for f in findings if f.pass_name != "parse"]
    if parse:
        print("capslint: files failed to parse (nothing was checked "
              "in them):")
        for f in parse:
            print(f"  {f.path}:{f.line}: {f.message}")
    if rest:
        print(header)
        for f in rest:
            print(f"  {f.path}:{f.line}: {f.message}")
    if findings:
        return 1
    print(clean_message)
    return 0
