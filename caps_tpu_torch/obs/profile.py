"""PROFILE support: annotate a relational operator tree with the
measurements of its latest execution.

``relational/ops.py`` stamps every executed operator with
``op._last_metrics = (op_metrics_list, entry)`` where ``entry`` is the
dict it appended to the runtime context's ``op_metrics``.  The list
identity doubles as a run tag: a cached plan's ``rebind`` swaps in a
fresh ``op_metrics`` list, so an operator whose stamp points at an older
list did NOT execute in the profiled run (e.g. the count-pushdown's
lazy fallback join plan) and is rendered as not-executed rather than
with stale numbers.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def profile_tree(root, context) -> Dict[str, Any]:
    """Snapshot ``root``'s operator tree with per-node measurements into
    plain dicts (no operator/table references, safe to retain)."""

    def node(op) -> Dict[str, Any]:
        stamp = getattr(op, "_last_metrics", None)
        executed = stamp is not None and stamp[0] is context.op_metrics
        d: Dict[str, Any] = {
            "op": type(op).__name__.removesuffix("Op"),
            "args": op._pretty_args(),
            "executed": executed,
        }
        if executed:
            entry = stamp[1]
            for k, v in entry.items():
                if k != "op":
                    d[k] = v
        d["children"] = [node(c) for c in op.children]
        return d

    tree = node(root)
    tree["rows"] = tree.get("rows", 0)
    return tree


def render_profile(tree: Dict[str, Any], depth: int = 0,
                   _rows_upper: bool = False) -> str:
    """Pretty-print an annotated tree (the ``plans['profile']`` text):

        Aggregate(...) [rows=1 time=0.8ms bytes_in=96]
            └─Join(...) [rows=12 time=2.1ms bytes_in=4096]

    The granularity tags carry into the text (the "never silently wrong
    numbers" contract holds for the human-facing rendering too):
    dispatch-only times (fused replay without per-op sync) print as
    ``dispatch=`` rather than ``time=``, served upper-bound row counts
    as ``rows<=``, and a per-replay aggregate device time heads the
    tree."""
    label = tree["op"] + (f"({tree['args']})" if tree["args"] else "")
    # under generic replay without per-op sync, inner row counts are
    # served upper bounds; the session fixes the ROOT to the exact
    # result cardinality (rows_inner marks the run)
    rows_upper = _rows_upper or tree.get("rows_inner") == "upper-bound"
    dispatch = tree.get("timing") == "dispatch"
    if tree["executed"]:
        rows_eq = "<=" if rows_upper and depth > 0 else "="
        time_key = "dispatch" if dispatch else "time"
        ann = (f"[rows{rows_eq}{tree.get('rows')} "
               f"{time_key}={1e3 * tree.get('seconds', 0.0):.3f}ms "
               f"bytes_in={tree.get('bytes_in', 0)}")
        if tree.get("device_s") is not None:
            ann += f" device={1e3 * tree['device_s']:.3f}ms"
        ann += "]"
    else:
        ann = "[not executed]"
    lines = []
    if depth == 0 and tree.get("replay_device_s") is not None:
        lines.append(f"fused replay: per-op times are host dispatch; "
                     f"aggregate device="
                     f"{1e3 * tree['replay_device_s']:.3f}ms")
    lines.append(("    " * depth) + ("└─" if depth else "") + f"{label} {ann}")
    for c in tree["children"]:
        lines.append(render_profile(c, depth + 1, rows_upper))
    return "\n".join(lines)


def tag_timing(tree: Dict[str, Any], timing: str) -> None:
    """Stamp a timing-granularity label on every node (fused-replay
    runs: per-op numbers are host dispatch times, the honest device
    number is the per-replay aggregate span)."""
    tree["timing"] = timing
    for c in tree["children"]:
        tag_timing(c, timing)


def find_executed_rows(tree: Dict[str, Any]) -> Optional[int]:
    """Row count of the topmost executed node (the result cardinality
    when the root itself ran)."""
    if tree["executed"]:
        return tree.get("rows")
    for c in tree["children"]:
        r = find_executed_rows(c)
        if r is not None:
            return r
    return None
