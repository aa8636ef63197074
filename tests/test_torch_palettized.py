"""The port's palettized ops (ml_stable_diffusion_torch/ops/palettized.py)
against the JAX package's, on the CPU.

- ``pack_bits``/``unpack_bits`` and ``pack_4bit``/``unpack_4bit``: the same
  bytes as the JAX package for every bit width and ragged counts (exact);
- ``palettized_dense``: unpacked and 4-bit packed indices (atol 1e-5: two
  float32 matmuls that sum in different orders);
- ``palettized_dense_fused`` on CPU tensors (its plain version) against the
  Pallas kernel in interpret mode, at the JAX test's cases
  (tests/test_pallas_kernels.py: (64, 256, 384) at 4, 6 and 8 bits, bias,
  batched input) and a ragged K = 320: atol 1e-4 float32 and 5e-2 bf16, the
  JAX test's tolerances (float32 summation order; one bf16 rounding step of
  outputs of order 1), and the result dtype with and without a bias; indices
  at or past the LUT's length read 0 in both (2 and 6 bits);
- ``launch_plan``, the bf16 kernel's plan, at every SD-2.1 UNet Linear call
  (``kernel_bounds.linear_calls``) and ragged shapes: its tiles cover every
  output element once, its K splits cover K exactly, its workspace holds
  every split's partial sums, and its grid fills the 132 SMs wherever K
  allows.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_stable_diffusion_tpu.compress.palettize import palettize_array as jax_palettize_array
from ml_stable_diffusion_tpu.ops import palettized as jax_ops

from ml_stable_diffusion_torch.ops import palettized as ops

ATOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.mark.parametrize("nbits", range(1, 9))
def test_pack_bits_bytes_match_jax(nbits):
    rng = np.random.RandomState(nbits)
    for count in (1, 7, 8, 9, 1001, 4099):
        idx = rng.randint(0, 2 ** nbits, size=count).astype(np.uint8)
        want = jax_ops.pack_bits(idx, nbits)
        got = ops.pack_bits(torch.from_numpy(idx), nbits)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(ops.unpack_bits(got, nbits, count).numpy(),
                                      jax_ops.unpack_bits(want, nbits, count))


def test_pack_4bit_matches_jax():
    idx = np.random.RandomState(0).randint(0, 16, size=1001).astype(np.uint8)
    packed = ops.pack_4bit(idx)
    np.testing.assert_array_equal(packed.numpy(), jax_ops.pack_4bit(idx))
    np.testing.assert_array_equal(ops.unpack_4bit(packed, idx.size).numpy(),
                                  np.asarray(jax_ops.unpack_4bit(jnp.asarray(packed.numpy()),
                                                                 idx.size)))


@pytest.mark.parametrize("packed", [False, True])
def test_palettized_dense_matches_jax(packed):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 64).astype(np.float32)
    pt = jax_palettize_array(rng.randn(64, 32).astype(np.float32), 4)
    bias = rng.randn(32).astype(np.float32)
    idx = jax_ops.pack_4bit(pt.indices) if packed else pt.indices
    want = jax_ops.palettized_dense(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(pt.lut),
                                    pt.shape, bias=jnp.asarray(bias))
    got = ops.palettized_dense(torch.from_numpy(x), torch.from_numpy(idx),
                               torch.from_numpy(pt.lut), pt.shape, bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _fused_pair(x, pt, bias=None):
    """(JAX Pallas kernel in interpret mode, port on CPU tensors), float32."""
    dtype = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x.float().numpy()).astype(dtype)
    want = jax_ops.palettized_dense_fused(
        jx, jnp.asarray(pt.indices), jnp.asarray(pt.lut), pt.shape,
        bias=None if bias is None else jnp.asarray(bias), interpret=True)
    got = ops.palettized_dense_fused(x, torch.from_numpy(pt.indices), torch.from_numpy(pt.lut),
                                     pt.shape, bias=None if bias is None else
                                     torch.from_numpy(bias))
    return want, got


@pytest.mark.parametrize("nbits,dtype", [(4, "float32"), (6, "bfloat16"), (8, "float32")])
def test_fused_matches_jax_kernel(nbits, dtype):
    rng = np.random.RandomState(0)
    M, K, N = 64, 256, 384
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(getattr(torch, dtype))
    pt = jax_palettize_array(rng.randn(K, N).astype(np.float32) * 0.1, nbits)
    bias = rng.randn(N).astype(np.float32)
    want, got = _fused_pair(x, pt, bias)
    assert got.shape == (M, N) and got.dtype == torch.float32  # bf16 x + f32 bias -> f32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=ATOL[dtype])


def test_fused_batched_input_matches_jax():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 32, 128).astype(np.float32))
    pt = jax_palettize_array(rng.randn(128, 256).astype(np.float32), 6)
    want, got = _fused_pair(x, pt)
    assert got.shape == (2, 32, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ragged_k_and_result_dtype(dtype):
    """K = 320 (the SD-2.1 UNet's first width: not a power of two) and 154
    rows; without a bias the result keeps x's dtype, as in JAX."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(154, 320).astype(np.float32)).to(getattr(torch, dtype))
    pt = jax_palettize_array(rng.randn(320, 96).astype(np.float32) / np.sqrt(320), 6)
    want, got = _fused_pair(x, pt)
    assert str(got.dtype) == f"torch.{dtype}" and str(want.dtype) == dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL[dtype])


def test_fused_rejects_packed_indices():
    pt = jax_palettize_array(np.random.RandomState(3).randn(64, 32).astype(np.float32), 4)
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="unpacked"):
        ops.palettized_dense_fused(x, ops.pack_4bit(pt.indices), torch.from_numpy(pt.lut),
                                   pt.shape)
    with pytest.raises(ValueError, match="CUDA"):
        ops.palettized_dense_fused_cuda(x, torch.from_numpy(pt.indices),
                                        torch.from_numpy(pt.lut), pt.shape)


@pytest.mark.parametrize("nbits", [2, 6])
def test_fused_reference_reads_zero_past_the_lut(nbits):
    """Indices at or past the LUT's length: the plain version gives the
    Pallas kernel's result (its select-sum reads 0 there)."""
    rng = np.random.RandomState(10 + nbits)
    M, K, N = 16, 128, 256
    n_lut = 2 ** nbits
    x = rng.randn(M, K).astype(np.float32)
    idx = rng.randint(0, 256, size=K * N).astype(np.uint8)
    assert (idx >= n_lut).mean() > 0.5
    lut = (rng.randn(n_lut) / np.sqrt(K)).astype(np.float32)
    want = jax_ops._dequant_matmul(jnp.asarray(x), jnp.asarray(idx.reshape(K, N)),
                                   jnp.asarray(lut), n_lut, interpret=True)
    got = ops.palettized_dense_fused_reference(torch.from_numpy(x), torch.from_numpy(idx),
                                               torch.from_numpy(lut), (K, N))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL["float32"])
    # and an index past the LUT is not a wrapped or clipped one
    ones = torch.full((K * N,), 255, dtype=torch.uint8)
    zero = ops.palettized_dense_fused_reference(torch.from_numpy(x), ones,
                                                torch.from_numpy(lut), (K, N))
    assert not zero.abs().max().item()


#: every (M, K, N) of a palettizable nn.Linear in one SD-2.1 UNet call at
#: 512x512, CFG batch 2 (kernel_bounds.linear_calls; the next test holds the
#: list to it)
SD21_LINEAR_CALLS = [
    (8192, 320, 320), (8192, 320, 2560), (8192, 1280, 320), (2048, 640, 640),
    (2048, 640, 5120), (2048, 2560, 640), (512, 1280, 1280), (512, 1280, 10240),
    (512, 5120, 1280), (154, 1024, 320), (154, 1024, 640), (154, 1024, 1280),
    (128, 1280, 1280), (128, 1280, 10240), (128, 5120, 1280), (2, 320, 1280),
    (2, 1280, 320), (2, 1280, 640), (2, 1280, 1280)]
RAGGED_CALLS = list(itertools.product((1, 2, 154), (320, 1000), (320, 129)))


def test_sd21_linear_calls_are_kernel_bounds():
    from kernel_bounds import linear_calls

    from ml_stable_diffusion_torch.models.unet import UNetConfig

    assert sorted(linear_calls(UNetConfig.sd21(), (64, 64), 1024)) == sorted(SD21_LINEAR_CALLS)


@pytest.mark.parametrize("M,K,N", SD21_LINEAR_CALLS + RAGGED_CALLS)
def test_launch_plan_covers_and_fills(M, K, N):
    plan = ops.launch_plan(M, K, N)
    assert plan.bm in ops.TILE_M and plan.bn in (64, 128)
    n_tiles, m_tiles, splits = plan.grid
    assert splits == plan.splits
    # the tiles of one split cover every output element exactly once
    count = np.zeros((M, N), np.uint8)
    for bx, by in itertools.product(range(n_tiles), range(m_tiles)):
        count[by * plan.bm:(by + 1) * plan.bm, bx * plan.bn:(bx + 1) * plan.bn] += 1
    assert (count == 1).all()
    # the K splits cover K exactly, each at least one tile deep
    step = plan.tiles_per_split * ops.K_TILE
    ranges = [(z * step, min(K, (z + 1) * step)) for z in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a < b for a, b in ranges)
    assert all(b == a2 for (_, b), (a2, _) in zip(ranges, ranges[1:]))
    # the workspace holds each split's f32 (M, N) partial sums, none without a split
    assert plan.workspace_floats(M, N) == (splits * M * N if splits > 1 else 0)
    # a full wave of blocks wherever K allows: else each split is one tile
    # deep at the narrowest tiles
    assert plan.blocks >= ops.SMS or (
        plan.tiles_per_split == 1 and plan.bn == 64 and plan.bm <= 64), plan
