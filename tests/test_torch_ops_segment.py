"""The port's dense segment aggregation (caps_tpu_torch/ops/segment.py)
against the JAX package's Pallas kernel, run in interpret mode on the
CPU, on the same seeded inputs.

Integer kinds must match exactly.  ``sum_f32`` adds in another order
than the TPU kernel's matmul, so it holds to rtol 1e-5, atol 1e-5."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from caps_tpu.ops import dense_segment_agg as jax_dense_segment_agg
from caps_tpu_torch.ops import dense_segment_agg, dense_segment_agg_plain

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


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 1000, 3000])
@pytest.mark.parametrize("s", [1, 130, 1500])
def test_dense_segment_agg_matches_jax(kind, n, s):
    codes, ok, values = _inputs(kind, n, s)
    want = np.asarray(jax_dense_segment_agg(
        jnp.asarray(codes), jnp.asarray(ok), jnp.asarray(values), s, kind,
        interpret=True))
    got = dense_segment_agg(torch.from_numpy(codes), torch.from_numpy(ok),
                            torch.from_numpy(values), s, kind).numpy()
    assert got.shape == (s,)
    assert got.dtype == want.dtype
    if kind == "sum_f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


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
