"""capslint ``metric-names``: the metrics registry's naming contract.

``MetricsRegistry`` is get-or-create by string name, so nothing ever
validated the names: a typo'd prefix silently forks a metric, and one
name registered as two different instrument kinds splits its readings
across instruments (``bench.py`` and ``stats()`` would each see half).
This pass collects every literal counter/gauge/histogram name in the
package (f-strings become ``*`` wildcards; dynamic ``metric_prefix``
f-strings are expanded against every constant prefix found in the
package) and enforces:

* **shape** — names are dotted, >= 2 segments, each ``[a-z0-9_]+``;
* **prefix** — the first segment comes from the sanctioned set
  (``AnalysisConfig.metric_prefixes``);
* **kind uniqueness** — one name, one instrument kind;
* **snapshot collisions** — histograms expand to ``name.count`` /
  ``name.sum`` / ... in ``snapshot()``; another metric literally named
  ``<histogram>.<suffix>`` would collide in the flat dict.

It also generates ``docs/metrics.md`` — the registry of every metric
name, kind, and definition site — which CI drift-checks against the
source (``python -m caps_tpu_torch.analysis --check-metrics-doc``;
regenerate with ``--write-metrics-doc``).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from caps_tpu_torch.analysis.core import Finding, Project, analysis_pass

PASS = "metric-names"

_KIND_METHODS = {"counter": "counter", "gauge": "gauge",
                 "histogram": "histogram", "observe": "histogram"}
_SEGMENT = re.compile(r"^[a-z0-9_]+$")
_HIST_SUFFIXES = ("count", "sum", "min", "max", "mean")


class Metric:
    __slots__ = ("name", "kind", "sites", "pattern")

    def __init__(self, name: str, kind: str, pattern: bool):
        self.name = name
        self.kind = kind
        self.sites: List[Tuple[str, int]] = []
        #: True when the name came from an f-string (contains ``*``)
        self.pattern = pattern


def _literal_metric_name(arg: ast.AST) -> Optional[Tuple[str, bool]]:
    """(name-or-pattern, is_pattern) for a metric-name argument."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, False
    if isinstance(arg, ast.JoinedStr):
        parts: List[str] = []
        for v in arg.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("*")
        return "".join(parts), True
    return None


def _metric_prefix_constants(project: Project) -> Set[str]:
    """Every constant string bound to a ``metric_prefix`` parameter —
    defaults and call-site keywords — used to expand dynamic-prefix
    f-string patterns like ``f"{metric_prefix}.opened"``."""
    out: Set[str] = set()
    for src in project.sources:
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                # align trailing defaults with trailing positionals
                pos, posd = list(args.args), list(args.defaults)
                for a, d in zip(pos[len(pos) - len(posd):], posd):
                    if a.arg == "metric_prefix" and \
                            isinstance(d, ast.Constant) and \
                            isinstance(d.value, str):
                        out.add(d.value)
                for a, d in zip(args.kwonlyargs, args.kw_defaults):
                    if a.arg == "metric_prefix" and \
                            isinstance(d, ast.Constant) and \
                            isinstance(d.value, str):
                        out.add(d.value)
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "metric_prefix" and \
                            isinstance(kw.value, ast.Constant) and \
                            isinstance(kw.value.value, str):
                        out.add(kw.value.value)
    return out


def collect_metrics(project: Project
                    ) -> Tuple[Dict[Tuple[str, str], Metric],
                               List[Finding]]:
    """{(name, kind) -> Metric} across the package + shape findings."""
    cfg = project.config
    prefixes = _metric_prefix_constants(project)
    metrics: Dict[Tuple[str, str], Metric] = {}
    findings: List[Finding] = []

    def record(name: str, pattern: bool, kind: str, rel: str,
               line: int) -> None:
        m = metrics.get((name, kind))
        if m is None:
            m = metrics[(name, kind)] = Metric(name, kind, pattern)
        m.sites.append((rel, line))

    sites: List[Tuple[str, bool, str, str, int]] = []
    for src in project.sources:
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _KIND_METHODS and node.args):
                continue
            got = _literal_metric_name(node.args[0])
            if got is None:
                continue  # histogram-instance .observe(v) etc.
            name, pattern = got
            sites.append((name, pattern, _KIND_METHODS[node.func.attr],
                          src.rel, node.lineno))
        # snapshot-injected keys: ``metrics_snapshot`` implementations
        # merge backend/fused/tracer stats straight into the registry's
        # flat dict — same namespace, same naming rules, and they belong
        # in docs/metrics.md next to the registered instruments
        for node in ast.walk(src.tree):
            if not (isinstance(node, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                    and node.name == "metrics_snapshot"):
                continue
            for sub in ast.walk(node):
                keys: List[ast.AST] = []
                if isinstance(sub, ast.Dict):
                    keys = [k for k in sub.keys if k is not None]
                elif isinstance(sub, ast.Assign):
                    keys = [t.slice for t in sub.targets
                            if isinstance(t, ast.Subscript)]
                for key in keys:
                    got = _literal_metric_name(key)
                    if got is None or "." not in got[0]:
                        continue
                    sites.append((got[0], got[1], "snapshot", src.rel,
                                  key.lineno))
    for name, pattern, kind, rel, lineno in sites:
        expanded = [name]
        if pattern and name.startswith("*.") and prefixes:
            # dynamic-prefix f-string (the breaker's metric_prefix):
            # expand against every constant prefix in the package
            expanded = [f"{p}{name[1:]}" for p in sorted(prefixes)]
            pattern = False
        for exp in expanded:
            segments = exp.split(".")
            bad_seg = [s for s in segments
                       if s != "*" and not _SEGMENT.match(s)]
            if len(segments) < 2 or bad_seg:
                findings.append(Finding(
                    rel, lineno, PASS,
                    f"metric name {exp!r} violates the dotted "
                    f"lowercase convention (<prefix>.<name>[.<detail>])"))
                continue
            if segments[0] != "*" and \
                    segments[0] not in cfg.metric_prefixes:
                findings.append(Finding(
                    rel, lineno, PASS,
                    f"metric name {exp!r} uses unsanctioned prefix "
                    f"{segments[0]!r} (known: "
                    f"{', '.join(sorted(cfg.metric_prefixes))})"))
                continue
            record(exp, pattern, kind, rel, lineno)
    return metrics, findings


@analysis_pass(PASS, "dotted metric-name conventions, name->kind "
                     "uniqueness, histogram snapshot collisions; "
                     "source of docs/metrics.md")
def check(project: Project) -> List[Finding]:
    metrics, findings = collect_metrics(project)
    by_name: Dict[str, List[Metric]] = {}
    for (_name, _kind), m in sorted(metrics.items()):
        by_name.setdefault(m.name, []).append(m)
    for name, ms in sorted(by_name.items()):
        if len(ms) > 1:
            kinds = sorted({m.kind for m in ms})
            sites = "; ".join(f"{r}:{ln}" for m in ms
                              for r, ln in m.sites[:2])
            rel, line = ms[-1].sites[0]
            findings.append(Finding(
                rel, line, PASS,
                f"metric {name!r} registered as {len(kinds)} different "
                f"kinds ({', '.join(kinds)}) — get-or-create would "
                f"split its readings across instruments ({sites})"))
    hist_names = {m.name for (_n, k), m in metrics.items()
                  if k == "histogram"}
    for (name, _kind), m in sorted(metrics.items()):
        for h in hist_names:
            if name != h and name.startswith(h + ".") and \
                    name[len(h) + 1:] in _HIST_SUFFIXES:
                rel, line = m.sites[0]
                findings.append(Finding(
                    rel, line, PASS,
                    f"metric {name!r} collides with histogram {h!r}'s "
                    f"snapshot expansion ({h}.count/.sum/...)"))
    return findings


# -- docs/metrics.md ---------------------------------------------------------

_DOC_HEADER = """\
# Metrics registry

<!-- GENERATED by `python -m caps_tpu_torch.analysis --write-metrics-doc`.
     Do not edit by hand: CI drift-checks this file against the source
     (`python -m caps_tpu_torch.analysis --check-metrics-doc`). -->

Every counter / gauge / histogram name the engine registers, collected
by capslint's `metric-names` pass from the literal call sites in
`caps_tpu_torch/` (f-string segments appear as `*`).  Histograms expand in
`session.metrics_snapshot()` to `<name>.count` / `.sum` / `.min` /
`.max` / `.mean`.

`collectives.<op>.calls` / `.traced_bytes` keep the JAX package's names
but count per RUN: each call of a `parallel/collectives.py` collective
adds one call and the bytes it moves (the JAX package's wrappers run
once per trace of a `shard_map` program, so there they count per
compile).  `backend.ici_bytes` / `.ici_payload_bytes` (and the per-query
`ici_bytes` metrics) count the bytes that cross between shards; on a
virtual mesh, whose shards share one card, that is a copy within the
card's memory.  `backend.gathers` / `.gather_bytes` (and the per-query
`gathers` / `gather_bytes` metrics) count the gathers of row-resident
tables to the lead device and their bytes, which `ici_bytes` includes.

```python
from caps_tpu_torch.obs.metrics import MetricsRegistry

reg = MetricsRegistry()
reg.counter("serve.completed").inc()
assert reg.snapshot()["serve.completed"] == 1
```

| name | kind | defined at |
| --- | --- | --- |
"""


def generate_metrics_doc(project: Project) -> str:
    metrics, _findings = collect_metrics(project)
    rows = []
    for (name, kind), m in sorted(metrics.items()):
        sites = ", ".join(f"`{r}:{ln}`"
                          for r, ln in sorted(set(m.sites))[:3])
        rows.append(f"| `{name}` | {kind} | {sites} |")
    return _DOC_HEADER + "\n".join(rows) + "\n"


def check_metrics_doc(project: Project) -> Optional[str]:
    """None when docs/metrics.md matches the source, else a message."""
    import os
    want = generate_metrics_doc(project)
    path = os.path.join(project.root, project.config.metrics_doc_rel)
    try:
        with open(path, encoding="utf-8") as f:
            have = f.read()
    except OSError:
        return (f"{project.config.metrics_doc_rel} is missing — "
                f"generate it with `python -m caps_tpu_torch.analysis "
                f"--write-metrics-doc`")
    if have != want:
        return (f"{project.config.metrics_doc_rel} is stale — metric "
                f"definitions changed; regenerate with `python -m "
                f"caps_tpu_torch.analysis --write-metrics-doc`")
    return None


def write_metrics_doc(project: Project) -> str:
    import os
    path = os.path.join(project.root, project.config.metrics_doc_rel)
    content = generate_metrics_doc(project)
    with open(path, "w", encoding="utf-8") as f:
        f.write(content)
    return path
