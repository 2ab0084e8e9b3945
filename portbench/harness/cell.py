"""One run of one cell: set-up, the window, the check, the result line.

The order is the contract's: data and the program are set up and every
shape the traffic uses is warmed (``setup_s`` ends at the first timed
request); the window runs for ``--seconds`` (traced with ``--trace 1``);
the card's peak memory is read; the program's state is freed; the plain
reference answers every request of the window and each answer is
judged; the result is printed.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time
from typing import Any, Dict, List, Optional

from portbench.harness import env, spec
from portbench.harness.drivers import Driver, Record
from portbench.harness.traffic import answer_key, param_space

# the longest traced window: a longer one makes a trace too large to read
# within a run's time
TRACE_CAP_S = 10.0


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    seconds: float            # the window's length
    setup_s: float
    data_info: Dict[str, Any]
    records: List[Record]
    window_start: float
    window_end: float
    syncs: int                # size reads of the window (backend.syncs)
    batching: Dict[str, float]
    trace: Any = None         # harness.trace.TraceData, traced runs only
    recorders: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def sent(self) -> List[Record]:
        return [r for r in self.records if r.t_submit < self.window_end]

    def answered(self) -> List[Record]:
        return [r for r in self.sent() if r.rows is not None]


def judge(records: List[Record], families, reference, control: bool,
          recorded: Dict[int, Dict[str, Any]]) -> Dict[str, Any]:
    """Hold every answer of the window to the reference's; with
    ``control`` the control's answers stand in for the program's.  An
    answer that never came counts as wrong."""
    want: Dict[tuple, Any] = {}
    wrong = unanswered = 0
    first_wrong = None
    for r in records:
        key = answer_key(r.family, r.params)
        if key not in want:
            want[key] = reference.answer(families[r.family], r.params)
        got = r.rows
        if control:
            got = reference.control(families[r.family], r.params,
                                    recorded.get(r.family, r.params))
        r.ok = got is not None and got == want[key]
        unanswered += got is None
        if not r.ok:
            wrong += 1
            if first_wrong is None:
                first_wrong = {"family": families[r.family]["name"],
                               "params": r.params, "error": r.error,
                               "got": None if got is None else got[:3],
                               "want": want[key][:3]}
    return {"wrong": wrong, "unanswered": unanswered,
            "checked": len(records), "distinct_answers": len(want),
            "first_wrong": first_wrong}


def checks_of(verdict: Dict[str, Any]) -> Dict[str, Any]:
    """The number compared beside its limit: answers of the window that
    differ from the reference's or never came (an exact comparison: the
    limit is 0); beside it the guard that the window held an answer."""
    return {"wrong_answers": {"value": verdict["wrong"], "max": 0},
            "answers_checked": {"value": verdict["checked"], "min": 1}}


def passed(checks: Dict[str, Any]) -> bool:
    return all(("max" not in c or c["value"] <= c["max"])
               and ("min" not in c or c["value"] >= c["min"])
               for c in checks.values())


def run(workload: str, seed: int, seconds: float, trace: bool,
        started: float, device: Optional[str] = None,
        config_override: Optional[Dict[str, Any]] = None,
        control: bool = False, bench: Optional[Dict[str, Any]] = None,
        base: str = spec.HERE) -> Dict[str, Any]:
    """One run; returns the result line's object.  ``device`` None means
    the card (the benchmark's runs); the tests pass ``"cpu"`` with a
    smaller configuration to drive the rest of a run without one, and
    may name cells of their own (``bench``, with its parts under
    ``base``)."""
    cell = spec.load_cell(workload, bench, base)
    import torch
    card = device is None
    if card:
        env.require_cards(torch, cell.chips)
    # seconds since ``started`` at the end of each step of the set-up
    phases = {"imports": time.perf_counter() - started}
    cfg = dict(cell.config, **(config_override or {}))
    dev = "cuda" if card else device
    data = cell.generator.make(seed, cfg, dev)
    phases["data"] = time.perf_counter() - started

    import caps_tpu_torch
    from caps_tpu_torch.interop import graph_from_numpy
    from caps_tpu_torch.okapi.config import EngineConfig
    session = caps_tpu_torch.local_session(
        device=dev, config=EngineConfig(**cell.mix.get("session", {})))
    graph = graph_from_numpy(session, data["nodes"], data["rels"])
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    phases["ingest"] = time.perf_counter() - started
    driver = Driver(sync, session, graph, cell.mix, seed)
    warm = driver.warm()
    sync()
    phases["warm"] = time.perf_counter() - started
    if card:
        torch.cuda.reset_peak_memory_stats()

    window = min(seconds, TRACE_CAP_S) if trace else seconds
    tracer = recs = None
    if trace:
        from portbench.harness import roofline
        from portbench.harness.trace import Tracer
        recs = roofline.recorders()
        for r in recs.values():
            r.__enter__()
        if card:
            tracer = Tracer(torch)
            tracer.start()
    batching0 = _batching(driver)
    syncs0, fused0 = session.backend.syncs, _fused(session)
    setup_s = time.perf_counter() - started
    wall = 0.0
    try:
        records = driver.window(window)
        sync()
        wall = time.perf_counter() - driver.window_start
    finally:
        trace_data = tracer.stop(wall) if tracer is not None else None
        for r in (recs or {}).values():
            r.__exit__()
    syncs = session.backend.syncs - syncs0
    fused = {k: v - fused0.get(k, 0) for k, v in _fused(session).items()}
    batching1 = _batching(driver)
    batching = {k: batching1[k] - batching0[k] for k in batching1}
    w_start, w_end = driver.window_start, driver.window_end
    peak = torch.cuda.max_memory_allocated() if card else 0
    # the first request each family served is the one its stream was
    # recorded with (the warm-up's first parameter set)
    recorded = {i: (param_space(f) or [{}])[0]
                for i, f in enumerate(cell.mix["families"])}
    driver.close()
    del driver, graph, session
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    env.check_imports()

    t_ref = time.perf_counter()
    reference = cell.generator.Reference(data, cfg, dev)
    ctx = Context(seconds=window, setup_s=setup_s,
                  data_info=data["info"], records=records,
                  window_start=w_start, window_end=w_end, syncs=syncs,
                  batching=batching, trace=trace_data,
                  recorders=recs or {})
    sent = ctx.sent()
    verdict = judge(sent, cell.mix["families"], reference, control,
                    recorded)
    del reference
    reference_s = time.perf_counter() - t_ref
    checks = checks_of(verdict)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        if trace and trace_data is None:
            break   # a run without the card reads no trace
        value = cell.reader(m).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result: Dict[str, Any] = {
        "correct": passed(checks),
        "attempted": len(sent),
        "failed": sum(1 for r in sent if not r.ok),
        "metrics": metrics,
        "device": _device(torch, cell, peak, card),
    }
    if trace_data is not None:
        from portbench.harness.trace import breakdown
        result["device"]["busy_s"] = trace_data.busy_s()
        result["device"]["window_s"] = trace_data.wall_s
        result["breakdown"] = breakdown(trace_data, tracer.ranges)
    result["program"] = {"setup_phases_s": phases, "warm": warm,
                         "done_per_5s": _done_per_slice(records, w_start,
                                                        window, 5.0),
                         "window_fused": fused,
                         "window_size_reads": syncs,
                         "data": data["info"],
                         "reference_s": reference_s,
                         "unanswered": verdict["unanswered"],
                         "distinct_answers": verdict["distinct_answers"],
                         "first_wrong": verdict["first_wrong"],
                         "control": control}
    result["checks"] = checks
    return result


def _done_per_slice(records: List[Record], start: float, seconds: float,
                    slice_s: float) -> List[int]:
    """Requests answered in each ``slice_s`` of the window: whether a
    run's rate drifts inside it or holds."""
    out = [0] * max(1, math.ceil(seconds / slice_s))
    for r in records:
        if r.t_done is not None and start <= r.t_done < start + seconds:
            out[min(len(out) - 1, int((r.t_done - start) // slice_s))] += 1
    return out


def _batching(driver: Driver) -> Dict[str, float]:
    if driver.server is None:
        return {"batches": 0, "members": 0}
    b = driver.server.stats()["batching"]
    return {"batches": b["batches"], "members": b["members"]}


def _fused(session) -> Dict[str, int]:
    snap = session.metrics_snapshot()
    return {k: v for k, v in snap.items()
            if k.startswith("fused.") or k == "replan.triggered"}


def _device(torch, cell: spec.Cell, peak: int, card: bool) -> Dict[str, Any]:
    if not card:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips, "memory_peak_bytes": int(peak)}


def print_result(result: Dict[str, Any], out=sys.stdout, err=sys.stderr):
    """The numbers compared beside their limits as the last lines on
    standard error, then the result as the last line on standard out."""
    for name, c in result["checks"].items():
        limit = (f"<= {c['max']}" if "max" in c else f">= {c['min']}")
        print(f"check {name} = {c['value']} (limit {limit})", file=err)
    err.flush()
    print(json.dumps(result, default=_plain), file=out, flush=True)


def _plain(v):
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    if hasattr(v, "item"):
        return v.item()
    return str(v)
