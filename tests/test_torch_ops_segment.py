"""The port's dense segment aggregation (caps_tpu_torch/ops/segment.py)
against the JAX package's Pallas kernel, run in interpret mode on the
CPU, on the same seeded inputs.

Integer kinds and float min/max must match exactly (float NaNs by
position, zeros by sign bit).  ``sum_f32`` holds to rtol 1e-5, atol 1e-5:
the JAX kernel sums in float32 on the MXU (a matmul per row tile), the
port sums in double and rounds once, so the two round differently."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import caps_tpu_torch
from caps_tpu.ops import dense_segment_agg as jax_dense_segment_agg
from caps_tpu_torch.ops import dense_segment_agg, dense_segment_agg_plain
from caps_tpu_torch.ops import segment as S
from caps_tpu_torch.okapi.types import CTString

KINDS = ["count", "sum_f32", "sum_i32", "min_i32", "max_i32",
         "min_f32", "max_f32"]


def _inputs(kind, n, s):
    rng = np.random.RandomState(KINDS.index(kind) * 7919 + n * 31 + s)
    codes = rng.randint(0, s, n).astype(np.int32)
    ok = rng.rand(n) < 0.8
    if kind.endswith("f32"):
        values = rng.randn(n).astype(np.float32)
    elif kind == "count":
        values = codes
    else:
        values = rng.randint(-1000, 1000, n).astype(np.int32)
    return codes, ok, values


def _assert_matches_jax(codes, ok, values, s, kind):
    want = np.asarray(jax_dense_segment_agg(
        jnp.asarray(codes), jnp.asarray(ok), jnp.asarray(values), s, kind,
        interpret=True))
    got = dense_segment_agg(torch.from_numpy(codes), torch.from_numpy(ok),
                            torch.from_numpy(values), s, kind).numpy()
    assert got.shape == (s,)
    assert got.dtype == want.dtype
    if kind == "sum_f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    elif kind.endswith("f32"):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        keep = ~np.isnan(want)
        np.testing.assert_array_equal(got[keep].view(np.int32),
                                      want[keep].view(np.int32))
    else:
        np.testing.assert_array_equal(got, want)
    return got


# S = 4097, 5000 and 20000 lie above one kernel window (the JAX kernel
# tiles its segment axis); n = 0 gives the identities
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [0, 1, 1000, 3000])
@pytest.mark.parametrize("s", [1, 130, 1500, 4097, 5000, 20000])
def test_dense_segment_agg_matches_jax(kind, n, s):
    _assert_matches_jax(*_inputs(kind, n, s), s, kind)


def _special_rows(layout):
    """Rows for eight slots of signed zeros, NaNs of both signs and
    infinities, the rest masked or out of range, over three 1024-row
    tiles.  ``layout`` "adjacent" puts a slot's rows next to each other,
    "tiles" puts them in different row tiles."""
    n = 3000
    codes = np.full(n, 50, np.int32)          # out of range
    ok = np.zeros(n, bool)
    v = np.full(n, np.nan, np.float32)        # masked NaNs are ignored
    slots = [[0.0, -0.0], [-0.0, 0.0], [1.0, np.nan], [np.inf, -np.nan],
             [np.nan, -np.nan], [-np.inf, 5.0, -np.nan, 2.0],
             [-0.0, -np.inf, np.inf, 0.0], [np.nan]]
    rows = iter(range(n)) if layout == "adjacent" else None
    for seg, vals in enumerate(slots):
        for i, x in enumerate(vals):
            r = next(rows) if rows else 1024 * (i % 3) + 7 * seg + i
            codes[r], ok[r], v[r] = seg, True, x
    codes[2990:] = np.arange(-5, 5)            # masked or out of range
    return codes, ok, v


@pytest.mark.parametrize("kind", ["min_f32", "max_f32"])
@pytest.mark.parametrize("layout", ["adjacent", "tiles"])
def test_float_min_max_signed_zero_and_nan_match_jax(kind, layout):
    codes, ok, v = _special_rows(layout)
    got = _assert_matches_jax(codes, ok, v, 9, kind)
    zero = 0 if kind == "max_f32" else 1      # slots 0 and 1: only zeros
    assert list(np.signbit(got[:2])) == [bool(zero)] * 2
    assert np.isnan(got[2:6]).all() and np.isnan(got[7])
    assert got[8] == (np.inf if kind == "min_f32" else -np.inf)


@pytest.mark.parametrize("kind", ["min_f32", "max_f32"])
def test_float_min_max_nan_rows_between_finite_rows(kind):
    rng = np.random.RandomState(7)
    n = 2500
    codes = rng.randint(0, 40, n).astype(np.int32)
    ok = rng.rand(n) < 0.9
    v = rng.randn(n).astype(np.float32)
    table = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf],
                     np.float32)
    pick = rng.rand(n) < 0.02
    v[pick] = table[rng.randint(0, 6, pick.sum())]
    _assert_matches_jax(codes, ok, v, 40, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s", [1, 4096, 8193, 70000])
def test_segment_geometry_windows_cover_the_slots(kind, s):
    for n, sms in ((0, 132), (1, 132), (2_097_152, 132), (10 ** 8, 132),
                   (5000, 1)):
        for vector in (True, False):
            blocks, windows = S.segment_geometry(n, s, kind, sms, vector)
            assert windows[0][0] == 0
            assert sum(w for _, w in windows) == s
            for (b0, w0), (b1, _) in zip(windows, windows[1:]):
                assert b1 == b0 + w0
            limit = (S.MAX_SEGMENTS_F64 if kind == "sum_f32"
                     else S.MAX_SEGMENTS)
            assert all(1 <= w <= limit for _, w in windows)
            assert len(windows) == -(-s // limit)
            c = S.cluster_size(kind)
            assert blocks % c == 0 and blocks >= c
            assert blocks <= max(c, sms * S.BLOCKS_PER_SM)
    # the main path's call: one window, a full wave of whole clusters
    blocks, windows = S.segment_geometry(2_097_152, 1002, "count", 132)
    assert windows == [(0, 1002)] and blocks == 512
    with pytest.raises(ValueError):
        S.segment_geometry(10, 0, kind, 132)


def test_vector_head_aligns_views():
    # a contiguous view one row in: three scalar rows, then 16-byte loads
    assert S.vector_head(1028, 257, 2052, 100) == (True, 3)
    assert S.vector_head(1024, 256, 2048, 100) == (True, 0)
    # ok one byte off from codes: no shared boundary, all rows scalar
    assert S.vector_head(1024, 257, 2048, 100) == (False, 0)
    assert S.vector_head(1024, 256, 2048, 3) == (False, 0)


def test_float_order_key_orders_like_the_reference():
    x = torch.tensor([-np.inf, -2.5, -0.0, 0.0, 1e-45, 3.0, np.inf],
                     dtype=torch.float32)
    key = S.float_order_key(x, 0)
    assert torch.all(key[1:] > key[:-1])
    assert torch.equal(S.float_from_key(key).view(torch.int32),
                       x.view(torch.int32))
    nan = torch.tensor([np.nan, -np.nan], dtype=torch.float32)
    lo = torch.iinfo(torch.int32).min
    assert S.float_order_key(nan, lo).tolist() == [lo, lo]
    assert torch.isnan(S.float_from_key(S.float_order_key(nan, lo))).all()


def test_dense_group_by_gate_matches_the_reference():
    """Above 4096 slots (4095 strings and the null key) the dense
    route declines on a CPU session, as the JAX backend's gate does."""
    from caps_tpu_torch.backends.cuda import table as T
    assert T.DENSE_GROUP_MAX_SEGMENTS == 4096
    session = caps_tpu_torch.local_session(device="cpu")
    f = session.table_factory
    for strings, dense in ((4095, True), (4096, False)):
        session.backend.pool.encode_many(
            [f"g{i}" for i in range(strings)])
        t = f.from_columns({"k": ["g0", "g1"] * 50}, {"k": CTString})
        calls = []
        real = T.OPS.dense_segment_agg
        try:
            T.OPS.dense_segment_agg = lambda *a: calls.append(a) or real(*a)
            out = t._group_dense_cuda(["k"], [])
        finally:
            T.OPS.dense_segment_agg = real
        assert (out is not None) == dense
        assert bool(calls) == dense


def test_all_rows_masked_gives_identities():
    codes = torch.zeros(100, dtype=torch.int32)
    ok = torch.zeros(100, dtype=torch.bool)
    vals_f = torch.ones(100, dtype=torch.float32)
    assert dense_segment_agg_plain(codes, ok, codes, 3, "count").tolist() \
        == [0, 0, 0]
    assert dense_segment_agg_plain(codes, ok, vals_f, 2, "min_f32").tolist() \
        == [float("inf")] * 2
    assert dense_segment_agg_plain(codes, ok, codes, 2, "max_i32").tolist() \
        == [torch.iinfo(torch.int32).min] * 2


def test_out_of_range_codes_are_ignored():
    codes = torch.tensor([-1, 0, 1, 5], dtype=torch.int32)
    ok = torch.ones(4, dtype=torch.bool)
    assert dense_segment_agg(codes, ok, codes, 2, "count").tolist() == [1, 1]


# -- the sharded form: once per shard, then the combine ------------------------

def _sharded_both(codes, ok, values, s, kind, n_shards=8):
    from caps_tpu.ops.segment import \
        dense_segment_agg_sharded as jax_sharded
    from caps_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from caps_tpu_torch.ops import dense_segment_agg_sharded
    from caps_tpu_torch.parallel.mesh import make_mesh
    want = np.asarray(jax_sharded(
        jax_make_mesh(n_shards), "shard", jnp.asarray(codes),
        jnp.asarray(ok), jnp.asarray(values), s, kind, interpret=True))
    got = dense_segment_agg_sharded(
        make_mesh(n_shards, device="cpu"), torch.from_numpy(codes),
        torch.from_numpy(ok), torch.from_numpy(values), s, kind).numpy()
    assert got.shape == want.shape == (s,) and got.dtype == want.dtype
    return got, want


def _bitwise(got, want):
    """Equal bit for bit, NaNs by position."""
    if got.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        keep = ~np.isnan(want)
        np.testing.assert_array_equal(got[keep].view(np.int32),
                                      want[keep].view(np.int32))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,s", [(0, 5), (8, 3), (1000, 17), (3000, 64),
                                 (4096, 4097), (8000, 20000)])
def test_dense_segment_agg_sharded_matches_jax(kind, n, s):
    """Every kind over an 8-shard mesh against the JAX package's
    ``dense_segment_agg_sharded`` on 8 devices: bit for bit, except
    ``sum_f32``, whose per-shard sums round differently (module
    docstring) — held to the same tolerance as the one-device kernel."""
    codes, ok, values = _inputs(kind, n, s)
    got, want = _sharded_both(codes, ok, values, s, kind)
    if kind == "sum_f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        _bitwise(got, want)


@pytest.mark.parametrize("kind", ["min_f32", "max_f32"])
@pytest.mark.parametrize("layout", ["spread", "nan_first", "all_nan",
                                    "one_shard", "empty_shards"])
def test_sharded_float_min_max_signed_zero_and_nan(kind, layout):
    """NaN of both signs and ±0 across shard boundaries, held bit for
    bit to the JAX package's pmin / pmax over its per-device partials:
    a NaN partial wins only from the first shard, ±0 keep the earlier
    shard's sign, and an empty slot keeps its identity."""
    n, s = 64, 6
    codes = (np.arange(n) % s).astype(np.int32)
    values = np.zeros(n, np.float32)
    values[codes == 0] = -0.0
    values[(codes == 0) & (np.arange(n) % 16 == 0)] = 0.0
    values[codes == 1] = np.where(np.arange(n)[codes == 1] < 32, 0.0, -0.0)
    values[(codes == 2) & (np.arange(n) == 20)] = np.float32("nan")
    values[(codes == 3) & (np.arange(n) == 45)] = -np.float32("nan")
    values[codes == 4] = np.linspace(-2, 2, int((codes == 4).sum()))
    ok = np.ones(n, bool)
    ok[codes == 5] = False
    if layout == "nan_first":
        values[2] = np.float32("nan")   # code 2 on shard 0
    elif layout == "all_nan":
        values[codes == 2] = np.float32("nan")
    elif layout == "one_shard":
        ok[8:] &= codes[8:] != 0
    elif layout == "empty_shards":
        ok[:32] = False
    got, want = _sharded_both(codes, ok, values, s, kind)
    _bitwise(got, want)


def test_sharded_group_by_needs_a_shard_multiple(monkeypatch):
    """The group-by shards K1 only where the table's capacity divides
    over the mesh, as in the JAX package: a 3-shard mesh over 256-row
    capacities runs the one-device kernel."""
    from caps_tpu_torch import ops as OPS
    from caps_tpu_torch.okapi.config import EngineConfig
    from caps_tpu_torch.testing.factory import create_graph
    calls = []
    real = OPS.dense_segment_agg_sharded

    def spy(*a, **k):
        calls.append(a[0].size)
        return real(*a, **k)
    monkeypatch.setattr(OPS, "dense_segment_agg_sharded", spy)
    create = ("CREATE (:P {c: 'x', v: 1}), (:P {c: 'y', v: 5}), "
              "(:P {c: 'x', v: 3})")
    q = ("MATCH (p:P) RETURN p.c AS c, count(*) AS n, min(p.v) AS lo, "
         "max(p.v) AS hi ORDER BY c")
    want = [{"c": "x", "n": 2, "lo": 1, "hi": 3},
            {"c": "y", "n": 1, "lo": 5, "hi": 5}]
    for shape, sharded in (((8,), True), ((3,), False), ((2, 4), True)):
        calls.clear()
        s = caps_tpu_torch.local_session(
            device="cpu", config=EngineConfig(mesh_shape=shape))
        g = create_graph(s, create, {})
        assert g.cypher(q).records.to_maps() == want
        assert bool(calls) == sharded, shape
        assert all(c == 8 for c in calls)
