"""The port's bitonic sort permutation (caps_tpu_torch/ops/sort.py) and
stable multi-key sort (backends/cuda/kernels.py) against the JAX
package's network twin and ``lax.sort`` path, on the same seeded keys.
Permutations must be identical."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from caps_tpu.backends.tpu import kernels as JK
from caps_tpu.ops import sort as JS
from caps_tpu_torch.backends.cuda import kernels as K
from caps_tpu_torch.ops import (
    bitonic_sort_perm, bitonic_sort_perm_plain, sort_cap_supported,
    sort_perm_cuda, split_planes,
)

CAP = 256


def _int_keys(seed, nkeys, cap=CAP):
    rng = np.random.RandomState(seed)
    keys = []
    for i in range(nkeys):
        if i % 2 == 0:  # heavy duplicates: stability stress
            k = rng.randint(0, 4, cap)
        else:           # the full int64 range, values >= 2^53 included
            k = rng.randint(-(2 ** 62), 2 ** 62, cap) * 2 + rng.randint(0, 2, cap)
            k[:8] = [2 ** 53, 2 ** 53 + 1, -(2 ** 63), 2 ** 63 - 1,
                     2 ** 53 + 1, 0, -1, 2 ** 53]
        keys.append(k.astype(np.int64))
    return keys


def _float_keys(seed, cap=CAP):
    rng = np.random.RandomState(seed)
    k = rng.choice([-1.5, 0.0, -0.0, 2.0, np.inf, -np.inf, np.nan], cap)
    return [k.astype(np.float64), rng.randint(0, 3, cap).astype(np.int64)]


def test_sort_cap_supported_matches_jax():
    for cap in (128, 256, 384, 512, 1024, 16384, 32768):
        assert sort_cap_supported(cap) == JS.sort_cap_supported(cap)


@pytest.mark.parametrize("case", ["int1", "int2", "int3", "float"])
def test_split_planes_matches_jax(case):
    keys = _float_keys(5) if case == "float" else _int_keys(3, int(case[-1]))
    want = JS.split_planes([jnp.asarray(k) for k in keys])
    got = split_planes([torch.from_numpy(k) for k in keys])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["int1", "int2", "int3", "float"])
def test_bitonic_plain_matches_jax_twin(case):
    keys = _float_keys(9) if case == "float" else _int_keys(13, int(case[-1]))
    planes = JS.split_planes([jnp.asarray(k) for k in keys])
    want = np.asarray(JS.bitonic_sort_perm_twin(tuple(planes)))
    got = bitonic_sort_perm_plain(
        [torch.from_numpy(np.array(p)) for p in planes])
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU wrapper takes the plain version
    np.testing.assert_array_equal(
        bitonic_sort_perm([torch.from_numpy(np.array(p))
                           for p in planes]).numpy(), want)


@pytest.mark.parametrize("case", ["int1", "int2", "int3", "float"])
def test_sort_perm_matches_lax_sort(case):
    keys = _float_keys(21) if case == "float" else _int_keys(17, int(case[-1]))
    want = np.asarray(JK.sort_perm([jnp.asarray(k) for k in keys], CAP))
    got = K.sort_perm([torch.from_numpy(k) for k in keys], CAP)
    np.testing.assert_array_equal(got.numpy(), want)
    # the engine's kernel route canonicalizes float keys first, so it
    # orders exactly like the stable sort
    got_net = sort_perm_cuda([torch.from_numpy(k) for k in keys], CAP)
    np.testing.assert_array_equal(got_net.numpy(), want)


def test_bitonic_at_cap_512():
    keys = _int_keys(29, 2, cap=512)
    want = K.sort_perm([torch.from_numpy(k) for k in keys], 512)
    got = bitonic_sort_perm_plain(split_planes(
        [torch.from_numpy(k) for k in keys]))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# --- launch geometry of the co-rank merge sort (ops/csrc/bitonic_sort.cu)

_SUPPORTED = [256 << i for i in range(7)]          # 256 ... 16384


@pytest.mark.parametrize("n_planes", [1, 2, 3, 10, 32, 45, 64])
@pytest.mark.parametrize("cap", _SUPPORTED)
def test_sort_geometry_fits_a_block(cap, n_planes):
    from caps_tpu_torch.ops.sort import (
        MAX_THREADS, SMEM_BUDGET, sort_geometry, sort_smem_bytes,
    )
    assert sort_cap_supported(cap)
    chunk, smem, passes = sort_geometry(cap, n_planes)
    assert chunk & (chunk - 1) == 0 and 32 <= chunk <= min(cap, MAX_THREADS)
    assert smem == sort_smem_bytes(chunk, n_planes)
    assert smem <= SMEM_BUDGET <= 232_448      # H100: a block's maximum
    assert 2 ** passes == cap // chunk          # merge passes = log2(cap/C)
    # the chunk is the largest that fits: doubling it would not
    if chunk < min(cap, MAX_THREADS):
        assert sort_smem_bytes(2 * chunk, n_planes) > SMEM_BUDGET


@pytest.mark.parametrize("chunk", [32, 256, 1024])
def test_sort_geometry_max_chunk(chunk):
    """The chunk is the largest that fits: it shrinks as the planes grow,
    and the merge passes make up the rest of the capacity."""
    from caps_tpu_torch.ops.sort import sort_geometry
    n_planes = {32: 1000, 256: 100, 1024: 10}[chunk]
    got, _, passes = sort_geometry(4096, n_planes)
    assert got == chunk and chunk << passes == 4096


def test_sort_geometry_refuses_planes_that_do_not_fit():
    from caps_tpu_torch.ops.sort import sort_geometry
    with pytest.raises(ValueError, match="do not fit"):
        sort_geometry(16384, 2000)


@pytest.mark.parametrize("cap", [1024, 4096])
def test_stable_permutation_above_one_chunk(cap):
    """At the main path's capacity and above it, the port's permutation
    is the JAX package's stable ``lax.sort`` permutation."""
    keys = _int_keys(41 + cap, 3, cap=cap)
    want = np.asarray(JK.sort_perm([jnp.asarray(k) for k in keys], cap))
    got = bitonic_sort_perm(split_planes([torch.from_numpy(k) for k in keys]))
    np.testing.assert_array_equal(got.numpy(), want)
