"""The port's expand-positions (caps_tpu_torch/ops/expand.py) against the
JAX package's Pallas kernel (interpret mode) and its jnp twin, on the same
seeded inputs.  All outputs are integers: exact."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from caps_tpu.ops import expand_positions as jax_expand_positions
from caps_tpu.ops import expand_positions_ref as jax_expand_positions_ref
from caps_tpu.ops import join_expand_via_positions as jax_join_expand
from caps_tpu_torch.ops import (
    build_csr, expand_positions, expand_positions_plain,
    join_expand_via_positions,
)


def _counts(seed, cap_l, out_cap, zero_frac=0.4):
    """Counts with runs of zeros whose total fits in out_cap."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, 6, cap_l)
    counts[rng.rand(cap_l) < zero_frac] = 0
    counts[cap_l // 3: cap_l // 3 + 17] = 0       # a long zero run
    while counts.sum() > out_cap:
        counts[rng.randint(cap_l)] = 0
    lo = rng.randint(0, 4 * cap_l, cap_l)
    return counts.astype(np.int64), lo.astype(np.int64)


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("out_cap", [256, 512, 1024])
@pytest.mark.parametrize("cap_l", [100, 600])
def test_expand_positions_matches_pallas(out_cap, cap_l):
    counts, lo = _counts(out_cap + cap_l, cap_l, out_cap)
    want = jax_expand_positions(jnp.asarray(counts), jnp.asarray(lo),
                                out_cap, interpret=True)
    got = expand_positions(torch.from_numpy(counts), torch.from_numpy(lo),
                           out_cap)
    _check(got, want)


@pytest.mark.parametrize("out_cap", [300, 1000])   # not a 256 multiple
def test_expand_positions_non_tileable_cap(out_cap):
    counts, lo = _counts(out_cap, 150, out_cap)
    want = jax_expand_positions_ref(jnp.asarray(counts), jnp.asarray(lo),
                                    out_cap)
    got = expand_positions_plain(torch.from_numpy(counts),
                                 torch.from_numpy(lo), out_cap)
    _check(got, want)


def test_expand_positions_all_zero_counts():
    counts = np.zeros(64, np.int64)
    lo = np.arange(64, dtype=np.int64)
    want = jax_expand_positions(jnp.asarray(counts), jnp.asarray(lo), 256,
                                interpret=True)
    got = expand_positions(torch.from_numpy(counts), torch.from_numpy(lo),
                           256)
    _check(got, want)
    assert not got[2].any()


@pytest.mark.parametrize("left_join", [False, True])
def test_join_expand_via_positions_matches_jax(left_join):
    rng = np.random.RandomState(7 + left_join)
    cap_l, cap_r, out_cap = 200, 300, 1024
    counts, lo = _counts(11, cap_l, out_cap - cap_l)
    lo = np.minimum(lo, cap_r - 1)
    perm = rng.permutation(cap_r).astype(np.int32)
    l_ok = rng.rand(cap_l) < 0.9
    want = jax_join_expand(jnp.asarray(counts), jnp.asarray(lo),
                           jnp.asarray(perm), jnp.asarray(l_ok), out_cap,
                           left_join, interpret=True)
    got = join_expand_via_positions(
        torch.from_numpy(counts), torch.from_numpy(lo),
        torch.from_numpy(perm), torch.from_numpy(l_ok), out_cap, left_join)
    _check(got, want)


def test_build_csr_groups_rows_by_key():
    keys = np.array([3, 1, 3, 0, 1, 3], np.int64)
    ok = np.array([1, 1, 1, 1, 0, 1], bool)
    csr = build_csr(keys, ok, 8, "cpu")
    assert csr.n_keys == 4
    assert csr.indptr.tolist() == [0, 1, 2, 2, 5]
    assert csr.perm.tolist()[:5] == [3, 1, 0, 2, 5]
    counts, lo = csr.probe(torch.tensor([3, 2, 9, 1]),
                           torch.tensor([True, True, True, False]))
    assert counts.tolist() == [3, 0, 0, 0]
    assert lo.tolist()[0] == 2
