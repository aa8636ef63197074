"""The port's GroupNorm(+SiLU) against the JAX package's, on the CPU.

- ``group_norm_silu_reference`` (the plain version of the CUDA kernel, NCHW)
  against the Pallas kernel ``_gn_silu_pallas`` run in interpret mode (NHWC),
  for float32 and bfloat16, SiLU on and off, at 4, 30 and 60 channels a
  group and at a ragged 7x9 image;
- the dispatch ``group_norm_silu`` on a CPU tensor against the JAX
  ``group_norm_silu`` (its XLA fallback off the TPU);
- ``group_norm_silu_lowmem`` against its JAX counterpart.

Tolerance: max abs 1e-5 in float32, 5e-2 in bfloat16 (one bfloat16 step at
|y| ~ 4, tests/test_pallas_kernels.py's).  Inputs are made with numpy,
x = a_c * z + b_c with per-channel scales in [0.5, 2] and offsets in
[-2, 2].  On the CPU the kernel is never launched.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ml_stable_diffusion_tpu.ops.groupnorm import _gn_silu_pallas
from ml_stable_diffusion_tpu.ops.groupnorm import group_norm_silu as jax_group_norm_silu
from ml_stable_diffusion_tpu.ops.groupnorm import (
    group_norm_silu_lowmem as jax_group_norm_silu_lowmem,
)

from ml_stable_diffusion_torch.ops.groupnorm import (
    group_norm_silu,
    group_norm_silu_cuda,
    group_norm_silu_lowmem,
    group_norm_silu_reference,
)

ATOL = {"float32": 1e-5, "bfloat16": 5e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

#: (B, H, W, C, groups): 4, 30 and 60 channels a group; a ragged 7x9 image
#: of 3 channels a group (groups that start off 16-byte boundaries in NCHW)
SHAPES = [(2, 4, 4, 32, 8), (2, 4, 4, 240, 8), (1, 4, 2, 480, 8), (2, 7, 9, 96, 32)]


def _inputs(B, H, W, C, seed):
    """NHWC float32 x with per-channel scale and offset, gamma and beta."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(0.5, 2.0, C).astype(np.float32)
    b = rng.uniform(-2.0, 2.0, C).astype(np.float32)
    x = (a * rng.randn(B, H, W, C) + b).astype(np.float32)
    gamma = (1.0 + 0.5 * rng.randn(C)).astype(np.float32)
    beta = (0.5 * rng.randn(C)).astype(np.float32)
    return x, gamma, beta


def _port(fn, x, gamma, beta, dtype, *args):
    """Run a port function on NHWC numpy x (as NCHW torch) -> NHWC float32."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(TORCH_DTYPES[dtype])
    out = fn(xt, torch.from_numpy(gamma), torch.from_numpy(beta), *args)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    return out.float().permute(0, 2, 3, 1).numpy()


def _jax_x(x, dtype):
    return jnp.asarray(x).astype(JAX_DTYPES[dtype])


@pytest.mark.parametrize("apply_silu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,W,C,G", SHAPES)
def test_reference_matches_pallas_kernel(B, H, W, C, G, dtype, apply_silu):
    x, gamma, beta = _inputs(B, H, W, C, seed=C + H)
    ref = np.asarray(_gn_silu_pallas(_jax_x(x, dtype), jnp.asarray(gamma), jnp.asarray(beta),
                                     G, 1e-5, apply_silu, interpret=True), np.float32)
    got = _port(group_norm_silu_reference, x, gamma, beta, dtype, G, 1e-5, apply_silu)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,W,C,G", SHAPES[1:])
def test_dispatch_on_cpu_matches_jax_fallback(B, H, W, C, G, dtype):
    x, gamma, beta = _inputs(B, H, W, C, seed=7)
    before = group_norm_silu_cuda.launches
    ref = np.asarray(jax_group_norm_silu(_jax_x(x, dtype), jnp.asarray(gamma),
                                         jnp.asarray(beta), G, 1e-5), np.float32)
    got = _port(group_norm_silu, x, gamma, beta, dtype, G, 1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL[dtype])
    assert group_norm_silu_cuda.launches == before  # a CPU tensor takes the plain version


@pytest.mark.parametrize("apply_silu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lowmem_matches_jax(dtype, apply_silu):
    B, H, W, C, G = SHAPES[1]
    x, gamma, beta = _inputs(B, H, W, C, seed=9)
    ref = np.asarray(jax_group_norm_silu_lowmem(_jax_x(x, dtype), jnp.asarray(gamma),
                                                jnp.asarray(beta), G, 1e-5, apply_silu),
                     np.float32)
    got = _port(group_norm_silu_lowmem, x, gamma, beta, dtype, G, 1e-5, apply_silu)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL[dtype])


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 32, 4, 4)
    p = torch.ones(32)
    before = group_norm_silu_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        group_norm_silu_cuda(x, p, p, 8)
    assert group_norm_silu_cuda.launches == before


@pytest.mark.parametrize("fn", [group_norm_silu_reference, group_norm_silu_lowmem,
                                group_norm_silu])
def test_groups_must_divide_channels(fn):
    x = torch.zeros(1, 30, 4, 4)
    p = torch.ones(30)
    with pytest.raises(ValueError, match="groups"):
        fn(x, p, p, 8)


@pytest.fixture(scope="module")
def sdxl_gn_shapes():
    """The 26 resnet GroupNorm+SiLU shapes of the SDXL base and refiner UNets
    at 1024x1024, CFG batch 2 (recorded on the meta device), and ragged
    ones."""
    from kernel_bounds import gn_calls
    from ml_stable_diffusion_torch.models.unet import UNetConfig

    shapes = set(gn_calls(UNetConfig.sdxl(), (128, 128), 2048, n_time_ids=6))
    shapes |= set(gn_calls(UNetConfig.sdxl_refiner(), (128, 128), 1280, n_time_ids=5))
    assert len(shapes) == 26
    return sorted(shapes) + [(2, 96, 7, 9), (1, 64, 5, 5), (1, 64, 701, 701),
                             (1, 256, 129, 129), (3, 96, 33, 35)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_plan(sdxl_gn_shapes, dtype):
    """Each plan covers the run exactly with its cluster's slices, fits a
    block's 227 KB of shared memory, takes clusters of 8 or 16, and streams
    only where no cluster's slice fits."""
    from ml_stable_diffusion_torch.ops.groupnorm import MAX_SLICE_BYTES, launch_plan

    itemsize = torch.tensor([], dtype=dtype).element_size()
    for B, C, H, W in sdxl_gn_shapes:
        n = C // 32 * H * W
        plan = launch_plan(B, C, 32, H * W, dtype)
        assert plan.cluster in (8, 16) and plan.blocks == B * 32 * plan.cluster
        # the kernel's partition of a group's whole 16-byte vectors (any
        # alignment of the group's start: at most one vector fewer)
        for vectors in {n * itemsize // 16, max(n * itemsize // 16 - 1, 0)}:
            cuts = [vectors * r // plan.cluster for r in range(plan.cluster + 1)]
            assert cuts[0] == 0 and cuts[-1] == vectors
            assert max(b - a for a, b in zip(cuts, cuts[1:])) * 16 <= plan.slice_bytes
        assert plan.smem_bytes + 1024 + 256 <= 232448
        fits = any(-(-(n * itemsize // 16) // cs) * 16 <= MAX_SLICE_BYTES for cs in (8, 16))
        assert plan.resident == fits
    # every SDXL shape keeps its slices in shared memory in bf16
    if dtype == torch.bfloat16:
        assert all(launch_plan(B, C, 32, H * W, dtype).resident
                   for B, C, H, W in sdxl_gn_shapes[:26])
