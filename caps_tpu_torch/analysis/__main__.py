"""``python -m caps_tpu_torch.analysis`` / ``capslint`` — the CLI.

Exit codes: 0 clean, 1 findings (or metrics-doc drift), 2 usage error.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from caps_tpu_torch.analysis import (check_metrics_doc, load_project,
                               pass_descriptions, pass_names, run_passes,
                               write_metrics_doc)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="capslint",
        description="multi-pass static analysis of caps_tpu_torch/ "
                    "(lock-order, tracer-purity, error-taxonomy, "
                    "clock-discipline, metric-names)")
    ap.add_argument("--only", metavar="PASS[,PASS...]",
                    help="run only these passes")
    ap.add_argument("--list", action="store_true", dest="list_passes",
                    help="list passes and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as a JSON array")
    ap.add_argument("--root", default=None,
                    help="project root (default: this checkout)")
    ap.add_argument("--check-metrics-doc", action="store_true",
                    help="also fail when docs/metrics.md is stale")
    ap.add_argument("--write-metrics-doc", action="store_true",
                    help="regenerate docs/metrics.md and exit")
    try:
        args = ap.parse_args(argv)
    except SystemExit as ex:
        return int(ex.code or 0)

    if args.list_passes:
        for name, desc in pass_descriptions():
            print(f"{name:18s} {desc}")
        return 0

    project = load_project(args.root)

    if args.write_metrics_doc:
        path = write_metrics_doc(project)
        print(f"wrote {path}")
        return 0

    only = None
    if args.only:
        only = [p.strip() for p in args.only.split(",") if p.strip()]
    try:
        findings = run_passes(project, only=only)
    except KeyError as ex:
        print(f"capslint: {ex.args[0]}", file=sys.stderr)
        return 2

    drift = check_metrics_doc(project) if args.check_metrics_doc else None

    if args.json:
        out = [f.as_dict() for f in findings]
        if drift:
            out.append({"path": project.config.metrics_doc_rel, "line": 1,
                        "pass": "metric-names", "message": drift})
        print(json.dumps(out, indent=2))
        return 1 if (findings or drift) else 0

    ran = only if only is not None else pass_names()
    if findings:
        for f in findings:
            print(f.format())
        print(f"\ncapslint: {len(findings)} finding(s) across "
              f"{len(ran)} pass(es), {len(project.sources)} files")
    else:
        print(f"capslint: clean ({len(ran)} passes, "
              f"{len(project.sources)} files, one shared parse)")
    if drift:
        print(f"capslint: {drift}")
    return 1 if (findings or drift) else 0


if __name__ == "__main__":
    sys.exit(main())
