"""The harness's arithmetic: interval unions, the operator open at a
time, the breakdown, the latency percentile, the kernels' work."""
import pytest

from portbench.end_to_end import p95_ms as P
from portbench.harness import roofline, trace
from portbench.harness.drivers import Record


def test_union():
    assert trace.union_us([]) == 0.0
    assert trace.union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0


def test_innermost_range_at_each_point():
    ranges = [(0, 10, "Join"), (2, 4, "Filter"), (6, 12, "Sort")]
    got = trace.innermost_at([1, 3, 5, 7, 11, 13], ranges)
    assert got == ["Join", "Filter", "Join", "Sort", "Sort", None]


def test_breakdown():
    ops = [trace.DeviceOp("k1", 0, 2, "Join"), trace.DeviceOp("k2", 5, 6, None),
           trace.DeviceOp("k1", 8, 9, None)]
    t = trace.TraceData(ops=ops, wall_s=1e-5)
    b = trace.breakdown(t, [(2, 5, "Filter")])
    assert b["device_ops"] == [["k1", 3e-6], ["k2", 1e-6]]
    assert b["idle_gaps"] == [["Filter", 3e-6], ["outside operators", 2e-6]]
    assert t.busy_s() == pytest.approx(4e-6)
    assert [o.name for o in t.owned_by("Join")] == ["k1"]


def rec(lat, ok=True):
    r = Record(0, 0, {}, 0.0, lat)
    r.ok = ok
    return r


def test_p95_nearest_rank_and_failures_last():
    recs = [rec(i / 1000) for i in range(1, 101)]
    assert P.p95_ms(recs) == pytest.approx(95.0)
    recs[0].ok = False          # the fastest fails: slower than any other
    assert P.p95_ms(recs) == pytest.approx(96.0)


def test_kernel_work():
    # the grouped query's K2 call (chip_smoke.py's kernel phase)
    b, ops = roofline.k2_work(262_144, 4, 4, 2_097_152)
    assert b == 262_144 * 8 + 2_097_152 * 9
    assert roofline.bound_s(b, ops) * 1e3 == pytest.approx(0.0063, abs=1e-4)
    assert roofline.k1_work(100, 10, "count") == (540, 100)
    assert roofline.k1_work(100, 10, "sum") == (940, 100)


def test_kernel_names():
    import re
    names = ["void scan_reduce<int>(int const*, int, unsigned int*)",
             "expand_tiles(int const*, int const*, int, int)",
             "void hist_kernel<0>(int const*, unsigned char const*)",
             "void at::native::reduce_kernel<512, 1>(sum_kernel_impl)"]
    k2 = [bool(re.search(roofline.K2_KERNELS, n)) for n in names]
    k1 = [bool(re.search(roofline.K1_KERNELS, n)) for n in names]
    assert k2 == [True, True, False, False]
    assert k1 == [False, False, True, False]
