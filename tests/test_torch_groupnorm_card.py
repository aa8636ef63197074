"""The GroupNorm+SiLU CUDA kernel against its plain version, on the card.

Skips without an NVIDIA GPU.  This file imports no JAX, so it also runs on
a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_groupnorm_card.py
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import pytest
import torch

from ml_stable_diffusion_torch.ops.groupnorm import (
    group_norm_silu,
    group_norm_silu_cuda,
    group_norm_silu_reference,
    launch_plan,
)

#: max-abs tolerance against the plain version (bf16: tests/test_pallas_kernels.py's)
ATOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
#: relative RMS tolerance, ||got - ref|| / ||ref|| (chip_smoke.py holds the same)
REL_RMS = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


@pytest.fixture
def cuda_device():
    """Decided when the test runs, not at import: every worker collects the
    same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


def _inputs(shape, dtype, device, seed):
    """x = a_c * z + b_c with per-channel a_c in [0.5, 2], b_c in [-2, 2]."""
    g = torch.Generator(device=device).manual_seed(seed)
    B, C, H, W = shape
    a = 0.5 + 1.5 * torch.rand(C, 1, 1, generator=g, device=device)
    b = 4.0 * torch.rand(C, 1, 1, generator=g, device=device) - 2.0
    x = (a * torch.randn(shape, generator=g, device=device) + b).to(dtype)
    gamma = (1.0 + 0.5 * torch.randn(C, generator=g, device=device)).to(dtype)
    beta = (0.5 * torch.randn(C, generator=g, device=device)).to(dtype)
    return x, gamma, beta


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,silu", [
    ((2, 320, 128, 128), torch.bfloat16, True),   # SDXL base, 10 channels a group
    ((2, 960, 64, 64), torch.bfloat16, True),     # 30 channels a group
    ((2, 1920, 32, 32), torch.bfloat16, True),    # 60 channels a group
    ((2, 96, 7, 9), torch.float32, True),         # ragged: groups off 16-byte boundaries
    ((2, 96, 7, 9), torch.bfloat16, False),
    ((1, 64, 5, 5), torch.float32, False),        # groups smaller than one vector
])
def test_gn_kernel_matches_plain(shape, dtype, silu, cuda_device):
    x, gamma, beta = _inputs(shape, dtype, cuda_device, seed=shape[1])
    before = group_norm_silu_cuda.launches
    got = group_norm_silu(x, gamma, beta, 32, 1e-5, silu)
    torch.cuda.synchronize()
    assert group_norm_silu_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    ref = group_norm_silu_reference(x, gamma, beta, 32, 1e-5, silu).float()
    diff = got.float() - ref
    assert diff.abs().max().item() <= ATOL[dtype]
    assert (diff.norm() / ref.norm()).item() <= REL_RMS[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,groups,cluster,resident", [
    ((2, 320, 128, 128), torch.bfloat16, 32, 8, True),    # SDXL: slices in shared memory
    ((2, 960, 128, 128), torch.bfloat16, 32, 16, True),   # SDXL: clusters of 16
    ((1, 256, 129, 129), torch.float32, 4, 8, False),     # 4.3 MB groups: streaming, ragged
    ((1, 256, 129, 129), torch.bfloat16, 4, 16, True),    # ragged run, resident
    ((2, 96, 7, 9), torch.bfloat16, 32, 8, True),         # groups off 16-byte boundaries
])
def test_gn_kernel_each_plan(shape, dtype, groups, cluster, resident, cuda_device):
    """Each of the launch plan's paths against the plain version."""
    B, C, H, W = shape
    plan = launch_plan(B, C, groups, H * W, dtype)
    assert (plan.cluster, plan.resident) == (cluster, resident)
    x, gamma, beta = _inputs(shape, dtype, cuda_device, seed=C + groups)
    got = group_norm_silu_cuda(x, gamma, beta, groups, 1e-5, True)
    ref = group_norm_silu_reference(x, gamma, beta, groups, 1e-5, True).float()
    diff = got.float() - ref
    assert diff.abs().max().item() <= ATOL[dtype]
    assert (diff.norm() / ref.norm()).item() <= REL_RMS[dtype]


@pytest.mark.cuda
def test_gn_kernel_f32_params_and_unaligned_base(cuda_device):
    """bf16 x with f32 gamma/beta, and an x whose base is off a 16-byte
    boundary (the wrapper copies it)."""
    x, gamma, beta = _inputs((2, 64, 9, 9), torch.bfloat16, cuda_device, seed=5)
    flat = torch.cat([x.new_zeros(1), x.flatten()])
    shifted = flat[1:].view(x.shape)
    assert shifted.data_ptr() % 16 != 0
    got = group_norm_silu_cuda(shifted, gamma.float(), beta.float(), 32)
    ref = group_norm_silu_reference(x, gamma.float(), beta.float(), 32).float()
    assert (got.float() - ref).abs().max().item() <= ATOL[torch.bfloat16]


@pytest.mark.cuda
def test_gn_kernel_rejects_unsupported(cuda_device):
    x = torch.zeros(2, 64, 8, 8, device=cuda_device)
    p = torch.ones(64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous NCHW"):
        group_norm_silu_cuda(x.to(memory_format=torch.channels_last), p, p, 32)
    with pytest.raises(ValueError, match="groups"):
        group_norm_silu_cuda(x, p, p, 24)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        group_norm_silu_cuda(x.half(), p, p, 32)
