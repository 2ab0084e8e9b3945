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


# --- the edge cases of the merge-path kernel (ops/csrc/expand_positions.cu),
# held on the plain version against the JAX package.  NV is the kernel's
# tile of merged items (slots and row ends).

def _edge_case(name):
    from caps_tpu_torch.ops.expand import NV
    rng = np.random.RandomState(len(name))
    if name == "zero_run_over_a_tile":
        counts = rng.randint(0, 3, NV + 500)
        counts[:NV + 100] = 0
        out_cap = 2048
    elif name == "row_over_many_tiles":
        counts = rng.randint(0, 3, 300)
        counts[150] = 3 * NV
        out_cap = 8192
    elif name == "total_eq_out_cap":
        counts = rng.randint(0, 5, 400)
        counts[-1] += 1024 - counts.sum() % 1024
        out_cap = int(counts.sum())
    elif name == "cap_l_over_out_cap":
        counts = np.zeros(3000, np.int64)
        counts[::29] = 2
        out_cap = 512
    elif name == "cap_l_1":
        counts = np.array([300])
        out_cap = 512
    else:  # "out_cap_not_tileable"
        counts = rng.randint(0, 4, 500)
        out_cap = int(counts.sum()) + 77
    assert counts.sum() <= out_cap
    lo = rng.randint(0, 10 ** 6, len(counts))
    return counts.astype(np.int64), lo.astype(np.int64), out_cap


@pytest.mark.parametrize("name", [
    "zero_run_over_a_tile", "row_over_many_tiles", "total_eq_out_cap",
    "cap_l_over_out_cap", "cap_l_1", "out_cap_not_tileable"])
def test_expand_positions_merge_path_edge_cases_match_jax(name):
    counts, lo, out_cap = _edge_case(name)
    if out_cap % 256:
        want = jax_expand_positions_ref(jnp.asarray(counts), jnp.asarray(lo),
                                        out_cap)
    else:
        want = jax_expand_positions(jnp.asarray(counts), jnp.asarray(lo),
                                    out_cap, interpret=True)
    got = expand_positions(torch.from_numpy(counts), torch.from_numpy(lo),
                           out_cap)
    _check(got, want)
    # int32 inputs give the same result
    got32 = expand_positions(torch.from_numpy(counts.astype(np.int32)),
                             torch.from_numpy(lo.astype(np.int32)), out_cap)
    _check(got32, want)


_BUCKETS = [1, 7, 256, 1000, 1024, 4096, 16384, 65536, 262144, 1048576,
            2097152, 3 * 2 ** 20 + 5]


@pytest.mark.parametrize("out_cap", _BUCKETS)
@pytest.mark.parametrize("cap_l", [1, 300, 16384, 262144])
def test_expand_geometry_covers_the_merged_sequence(cap_l, out_cap):
    from caps_tpu_torch.ops.expand import NV, expand_geometry
    scan_tiles, tiles, words = expand_geometry(cap_l, out_cap)
    # every merged item (out_cap slots, cap_l row ends) has a tile, and
    # no tile starts past the end
    assert tiles * NV >= out_cap + cap_l > (tiles - 1) * NV
    assert scan_tiles * NV >= cap_l > (scan_tiles - 1) * NV
    # ends + bases, the scan blocks' sums, and one split per tile boundary
    assert words == 2 * cap_l + scan_tiles + tiles + 1


def test_expand_positions_cuda_refuses_cpu_and_int32_overflow():
    from caps_tpu_torch.ops.expand import NV, expand_positions_cuda
    c = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        expand_positions_cuda(c, c, 8)
    with pytest.raises(ValueError, match="float"):
        expand_positions_cuda(c.float(), c, 8)
    # merged positions (out_cap slots + cap_l row ends + a tile) are int32
    for out_cap in (2 ** 31 - NV - 4, 2 ** 31, -1):
        with pytest.raises(ValueError, match="exceed int32"):
            expand_positions_cuda(c, c, out_cap)
    with pytest.raises(ValueError, match="CUDA"):   # the largest it takes
        expand_positions_cuda(c, c, 2 ** 31 - NV - 5)
