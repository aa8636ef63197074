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
  outputs of order 1), and the result dtype with and without a bias.
"""

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
