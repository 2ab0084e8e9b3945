"""The device trace of a traced window, and the arithmetic over it.

``torch.profiler``'s low-level calls record the window (the Python event
list that ``torch.profiler.profile`` builds on exit takes minutes for a
few hundred thousand launches, so the raw events are read instead).
Every thread is traced: the server runs queries on threads of its own.
The port opens its operator ranges (``caps_tpu_torch.<Op>``) only where
``torch.autograd._profiler_enabled()`` is true, which a trace of all
threads does not report, so it is made to say so while the trace runs.

The union arithmetic is a copy of ``device_profile`` in
``chip_smoke.py``: the device is busy where a kernel or a copy runs,
the union of their intervals; the ranges' copies on the device timeline
are not device work.
"""
from __future__ import annotations

import dataclasses
import heapq
import re
from typing import Dict, List, Optional, Tuple

RANGE_PREFIX = "caps_tpu_torch."


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float
    owner: Optional[str]     # innermost operator range open at its launch


@dataclasses.dataclass
class TraceData:
    ops: List[DeviceOp]
    wall_s: float            # the traced window, on the host's clock

    def busy_s(self) -> float:
        return union_us([(o.start_us, o.end_us) for o in self.ops]) / 1e6

    def matching(self, pattern: str) -> List[DeviceOp]:
        rx = re.compile(pattern)
        return [o for o in self.ops if rx.search(o.name)]

    def owned_by(self, op_name: str) -> List[DeviceOp]:
        return [o for o in self.ops if o.owner == op_name]


def union_us(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of intervals."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo


def merged(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def innermost_at(points: List[float],
                 ranges: List[Tuple[float, float, str]]) -> List[Optional[str]]:
    """For each time in ``points``, the name of the latest-opened range
    of ``ranges`` (start, end, name) that covers it, or None."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    rs = sorted(ranges)
    out: List[Optional[str]] = [None] * len(points)
    heap: List[Tuple[float, float, str]] = []   # (-start, end, name)
    j = 0
    for i in order:
        t = points[i]
        while j < len(rs) and rs[j][0] <= t:
            heapq.heappush(heap, (-rs[j][0], rs[j][1], rs[j][2]))
            j += 1
        # ranges that closed before t can never cover a later point
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        if heap:
            out[i] = heap[0][2]
        # a closed range below the top stays until it reaches the top;
        # the top itself is checked against t above
    return out


class Tracer:
    """Start and stop a trace of all threads' CPU work and the card."""

    def __init__(self, torch):
        self.torch = torch
        self._saved = None

    def start(self) -> None:
        import torch.autograd as ag
        from torch._C._profiler import ProfilerActivity, _ExperimentalConfig
        try:
            exp = _ExperimentalConfig(profile_all_threads=True)
        except TypeError as ex:
            # the port's operators run on threads of their own; a trace
            # of one thread would leave their device time unowned
            raise RuntimeError("this PyTorch cannot trace all threads "
                               "(_ExperimentalConfig has no "
                               "profile_all_threads)") from ex
        cfg = ag.ProfilerConfig(ag.ProfilerState.KINETO, False, False, False,
                                False, False, exp)
        acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        self.torch.cuda.synchronize()
        ag._prepare_profiler(cfg, acts)
        ag._enable_profiler(cfg, acts)
        self._saved = ag._profiler_enabled
        ag._profiler_enabled = lambda: True

    def stop(self, wall_s: float) -> TraceData:
        import torch.autograd as ag
        from torch.autograd import DeviceType
        self.torch.cuda.synchronize()
        if self._saved is not None:
            ag._profiler_enabled = self._saved
            self._saved = None
        events = ag._disable_profiler().events()
        cpu: Dict[int, Tuple[int, float, float]] = {}
        ranges: Dict[int, List[Tuple[float, float, str]]] = {}
        device = []
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if not name.startswith(RANGE_PREFIX) \
                        and not e.is_user_annotation():
                    device.append((name, e.start_ns() / 1e3, e.end_ns() / 1e3,
                                   e.linked_correlation_id(),
                                   e.correlation_id()))
                continue
            tid, a, b = e.start_thread_id(), e.start_ns() / 1e3, \
                e.end_ns() / 1e3
            cpu[e.correlation_id()] = (tid, a, b)
            if name.startswith(RANGE_PREFIX):
                ranges.setdefault(tid, []).append(
                    (a, b, name[len(RANGE_PREFIX):]))
        # each device op's launch: the CPU event it is linked to (the
        # innermost op or range open when it was launched), then the
        # innermost operator range on that thread at that time
        launch_at: Dict[int, List[Tuple[int, float]]] = {}
        for i, (_n, _a, _b, linked, corr) in enumerate(device):
            hit = cpu.get(linked) or cpu.get(corr)
            if hit is not None:
                launch_at.setdefault(hit[0], []).append((i, hit[1]))
        owner: List[Optional[str]] = [None] * len(device)
        for tid, pts in launch_at.items():
            names = innermost_at([t for _i, t in pts], ranges.get(tid, []))
            for (i, _t), nm in zip(pts, names):
                owner[i] = nm
        ops = [DeviceOp(n, a, b, owner[i])
               for i, (n, a, b, _l, _c) in enumerate(device)]
        self.ranges = [r for rs in ranges.values() for r in rs]
        return TraceData(ops=ops, wall_s=wall_s)


def breakdown(trace: TraceData, ranges: List[Tuple[float, float, str]],
              top: int = 10) -> Dict[str, list]:
    """The device ops that took most time, by name, and the idle gaps
    between busy intervals summed by the innermost operator range open
    (on any thread) at each gap's middle: what the host was doing."""
    by_name: Dict[str, float] = {}
    for o in trace.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end_us - o.start_us)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged([(o.start_us, o.end_us) for o in trace.ops])
    gaps = [(a1, b0) for (_a0, a1), (b0, _b1) in zip(busy, busy[1:])]
    names = innermost_at([(a + b) / 2 for a, b in gaps], ranges)
    idle: Dict[str, float] = {}
    for (a, b), nm in zip(gaps, names):
        key = nm if nm is not None else "outside operators"
        idle[key] = idle.get(key, 0.0) + (b - a)
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps_top]}
