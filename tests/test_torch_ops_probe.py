"""The port's tile gather (caps_tpu_torch/ops/prefetch.py) against the JAX
package's capability-probe program — the ``prefetch`` family's Pallas
kernel ``k2`` of caps_tpu/ops/probe.py, built as the probe builds it and
run in interpret mode on the same seeded inputs — and the kernel
self-test (caps_tpu_torch/ops/probe.py) on the CPU.  Integer outputs:
exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from caps_tpu_torch import ops
from caps_tpu_torch.ops import probe
from caps_tpu_torch.ops.prefetch import prefetch_gather_plain


def _jax_probe_prefetch(xs: np.ndarray, blk: np.ndarray, tile: int):
    """The probe's ``prefetch`` program (caps_tpu/ops/probe.py:80-97),
    with interpret=True and the given inputs."""
    def k2(blk_ref, x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2
    n_tiles = blk.shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(n_tiles,),
        in_specs=[pl.BlockSpec((tile,), lambda i, blk: (blk[i],),
                               memory_space=pltpu.VMEM)],
        out_specs=[pl.BlockSpec((tile,), lambda i, blk: (i,),
                                memory_space=pltpu.VMEM)],
    )
    out = pl.pallas_call(k2, grid_spec=grid_spec, interpret=True,
                         out_shape=[jax.ShapeDtypeStruct((tile * n_tiles,),
                                                         jnp.int32)])(
        jnp.asarray(blk), jnp.asarray(xs))
    return np.asarray(out[0])


def _blk(kind: str, n_tiles: int) -> np.ndarray:
    rng = np.random.RandomState(n_tiles)
    return {"identity": np.arange(n_tiles),
            "reversed": np.arange(n_tiles)[::-1].copy(),
            "repeated": np.full(n_tiles, n_tiles // 2),
            "random": rng.randint(0, n_tiles, n_tiles)}[kind].astype(np.int32)


@pytest.mark.parametrize("n_tiles", [4, 9])
@pytest.mark.parametrize("kind", ["identity", "reversed", "repeated",
                                  "random"])
def test_prefetch_gather_plain_matches_pallas_probe(kind, n_tiles):
    tile = 256
    rng = np.random.RandomState(7 + n_tiles)
    xs = rng.randint(-2 ** 20, 2 ** 20, tile * n_tiles).astype(np.int32)
    blk = _blk(kind, n_tiles)
    want = _jax_probe_prefetch(xs, blk, tile)
    got = prefetch_gather_plain(torch.from_numpy(xs), torch.from_numpy(blk),
                                tile)
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_program_at_its_own_inputs():
    """The probe's own call: x = arange(1024), blk = arange(4)."""
    xs = np.arange(1024, dtype=np.int32)
    blk = np.arange(4, dtype=np.int32)
    want = _jax_probe_prefetch(xs, blk, 256)
    np.testing.assert_array_equal(want, 2 * xs)
    got = prefetch_gather_plain(torch.from_numpy(xs), torch.from_numpy(blk),
                                256)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefetch_gather_plain_other_tile_and_source_count():
    """More source tiles than output tiles, and a tile that is not a
    multiple of 4 (the kernel's scalar path)."""
    x = torch.arange(700, dtype=torch.int32)
    blk = torch.tensor([6, 0, 3, 3], dtype=torch.int32)
    got = prefetch_gather_plain(x, blk, 100)
    want = torch.cat([2 * x[600:700], 2 * x[0:100], 2 * x[300:400],
                      2 * x[300:400]])
    assert torch.equal(got, want)


@pytest.mark.parametrize("feature", probe.FEATURES)
def test_ensure_kernels_is_a_no_op_on_the_cpu(feature):
    before_launches = ops.launches()
    before_tests = probe.selftest_seconds()
    assert ops.ensure_kernels(feature, torch.device("cpu")) is None
    assert ops.ensure_kernels(feature, "cpu") is None
    assert ops.launches() == before_launches
    assert probe.selftest_seconds() == before_tests


def test_ensure_kernels_rejects_an_unknown_family():
    with pytest.raises(ValueError, match="unknown kernel family"):
        ops.ensure_kernels("wcoj", "cpu")


def test_self_test_difference_names_its_family():
    with pytest.raises(probe.KernelSelfTestError, match="sort: .* differs"):
        probe._expect_equal("sort", "bitonic_sort(cap=256)",
                            torch.tensor([0, 2, 1]), torch.tensor([0, 1, 2]))
    with pytest.raises(probe.KernelSelfTestError, match="basic: .* gave"):
        probe._expect_equal("basic", "segment_agg", torch.zeros(3),
                            torch.zeros(3, dtype=torch.int32))
