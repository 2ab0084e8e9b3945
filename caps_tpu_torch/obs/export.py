"""Span exporters: JSON-lines dumps and ``chrome://tracing`` files
(the counterpart of ``caps_tpu/obs/export.py``).

* :func:`write_jsonl` — one JSON object per span (flattened, with
  ``span_id`` / ``parent_id`` links), greppable and trivially loadable
  into pandas;
* :func:`write_chrome_trace` — the Trace Event Format consumed by
  ``chrome://tracing`` / Perfetto: complete ("ph": "X") events for
  timed spans, instant ("ph": "i") events for zero-duration ones,
  timestamps in microseconds on the shared monotonic clock base.
"""
from __future__ import annotations

import json
from typing import IO, Any, Dict, Iterable, Iterator, List, Tuple, Union

from caps_tpu_torch.obs.tracer import Span

PathOrFile = Union[str, IO[str]]


def _walk(spans: Iterable[Span]) -> Iterator[Tuple[Span, int, int]]:
    """Yield (span, span_id, parent_id) depth-first; parent_id -1 = root."""
    next_id = 0
    stack: List[Tuple[Span, int]] = [(s, -1) for s in reversed(list(spans))]
    while stack:
        span, parent = stack.pop()
        sid = next_id
        next_id += 1
        yield span, sid, parent
        for c in reversed(span.children):
            stack.append((c, sid))


def _open(path_or_file: PathOrFile):
    if isinstance(path_or_file, str):
        return open(path_or_file, "w"), True
    return path_or_file, False


def write_jsonl(spans: Iterable[Span], path_or_file: PathOrFile) -> int:
    """Write one JSON line per span; returns the number written."""
    f, close = _open(path_or_file)
    n = 0
    try:
        for span, sid, parent in _walk(spans):
            d = span.to_dict()
            d.pop("children", None)
            d["span_id"] = sid
            d["parent_id"] = parent
            f.write(json.dumps(d) + "\n")
            n += 1
    finally:
        if close:
            f.close()
    return n


def chrome_trace_events(spans: Iterable[Span]) -> List[Dict[str, Any]]:
    """Spans → Trace Event Format dicts (ts/dur in microseconds).

    ``pid`` is the span's ``device`` attr where a span carries one,
    inherited from the parent span when a child lacks its own and
    falling back to 0: spans of several devices render as parallel
    per-device lanes instead of interleaving on one row."""
    events: List[Dict[str, Any]] = []
    lane: Dict[int, int] = {}
    for span, sid, parent in _walk(spans):
        args: Dict[str, Any] = dict(span.attrs)
        if span.rows is not None:
            args["rows"] = span.rows
        if span.bytes is not None:
            args["bytes"] = span.bytes
        if span.device_s is not None:
            args["device_ms"] = round(1e3 * span.device_s, 6)
        try:
            pid = int(span.attrs["device"])
        except (KeyError, TypeError, ValueError):
            pid = lane.get(parent, 0)
        lane[sid] = pid
        base = {"name": span.name, "cat": span.kind, "pid": pid, "tid": 0,
                "ts": round(1e6 * span.t0, 3), "args": args}
        if span.kind == "event" or (span.wall_s == 0.0 and not span.children):
            events.append({**base, "ph": "i", "s": "t"})
        else:
            events.append({**base, "ph": "X",
                           "dur": round(1e6 * span.wall_s, 3)})
    return events


def write_chrome_trace(spans: Iterable[Span],
                       path_or_file: PathOrFile) -> int:
    """Write a ``chrome://tracing``-loadable JSON file; returns the
    number of events written."""
    events = chrome_trace_events(spans)
    f, close = _open(path_or_file)
    try:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    finally:
        if close:
            f.close()
    return len(events)
