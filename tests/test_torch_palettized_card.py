"""The fused dequant-matmul CUDA kernel against its plain version, on the
card.

Skips without an NVIDIA GPU.  This file imports no JAX, so it also runs on
a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_palettized_card.py
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import pytest
import torch

from ml_stable_diffusion_torch.ops.palettized import (
    pack_4bit,
    palettized_dense_fused,
    palettized_dense_fused_cuda,
    palettized_dense_fused_reference,
)

#: max-abs tolerance against the plain version (tests/test_pallas_kernels.py's:
#: 5e-2 bf16, 1e-4 f32): the two differ by f32 summation order, then by one
#: bf16 rounding of outputs of order 1
ATOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
#: relative RMS tolerance, ||got - ref|| / ||ref||: a dropped 64-deep k tile
#: moves the output by >= 0.11 at K = 5120 (chip_smoke.py holds the same)
REL_RMS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda_device():
    """Decided when the test runs, not at import: every worker collects the
    same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


def _inputs(M, K, N, nbits, dtype, device, seed):
    """x ~ N(0, 1), indices uniform over the LUT, LUT ~ N(0, 1/K): outputs
    of order 1."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=device).to(dtype)
    idx = torch.randint(0, 2 ** nbits, (K * N,), generator=g, device=device,
                        dtype=torch.int32).to(torch.uint8)
    lut = torch.randn(2 ** nbits, generator=g, device=device) / K ** 0.5
    return x, idx, lut


def _check(got, ref, dtype):
    diff = got.float() - ref.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / ref.float().norm()).item()
    assert err <= ATOL[dtype], (err, ATOL[dtype])
    assert rel <= REL_RMS[dtype], (rel, REL_RMS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("M,K,N", [
    (8192, 320, 2560),   # GEGLU projection at 64x64, CFG batch 2
    (154, 1024, 640),    # cross-attention key/value at CFG batch 2
    (512, 5120, 1280),   # feed-forward output at 16x16
])
def test_kernel_matches_plain_sd21(M, K, N, nbits, cuda_device):
    x, idx, lut = _inputs(M, K, N, nbits, torch.bfloat16, cuda_device, seed=M + nbits)
    before = palettized_dense_fused_cuda.launches
    got = palettized_dense_fused(x, idx, lut, (K, N))
    torch.cuda.synchronize()
    assert palettized_dense_fused_cuda.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    _check(got, palettized_dense_fused_reference(x, idx, lut, (K, N)), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,dtype", [
    (2, 1280, 1280, torch.float32),    # time embedding rows, FMA kernel
    (154, 320, 96, torch.float32),
    (77, 300, 130, torch.bfloat16),    # ragged M, K (not a multiple of 8) and N
    (130, 72, 200, torch.bfloat16),    # ragged M and N, K in whole vectors
    (3, 7, 5, torch.float32),
    # split-K remainders (K = 320: 5 tiles of 64; 1024: 16; 5120: 80) at the
    # M of the time embedding, the cross-attention keys and the 16x16 level;
    # N = 320 is not a multiple of the 128-column tile
    (2, 320, 320, torch.bfloat16),
    (2, 1024, 320, torch.bfloat16),
    (2, 5120, 320, torch.bfloat16),
    (154, 320, 320, torch.bfloat16),
    (154, 1024, 320, torch.bfloat16),
    (154, 5120, 320, torch.bfloat16),
    (512, 320, 320, torch.bfloat16),
    (512, 1024, 320, torch.bfloat16),
    (512, 5120, 320, torch.bfloat16),
    (154, 1024, 200, torch.bfloat16),  # N not a multiple of 16: the loads without TMA
])
def test_kernel_ragged_and_f32(M, K, N, dtype, cuda_device):
    x, idx, lut = _inputs(M, K, N, 6, dtype, cuda_device, seed=K)
    bias = torch.randn(N, device=cuda_device)
    got = palettized_dense_fused(x.reshape(1, M, K), idx, lut, (K, N), bias=bias)
    torch.cuda.synchronize()
    ref = palettized_dense_fused_reference(x.reshape(1, M, K), idx, lut, (K, N), bias=bias)
    assert got.shape == (1, M, N) and got.dtype == torch.float32  # promoted by the f32 bias
    _check(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (2, 1280, 1280),    # split 10 ways, reduced in split order
    (8192, 320, 320),   # no split
])
def test_kernel_is_deterministic(M, K, N, cuda_device):
    """Two runs of one input give the same bits: split-K partial sums are
    added in a fixed order, with no atomics."""
    x, idx, lut = _inputs(M, K, N, 6, torch.bfloat16, cuda_device, seed=M)
    first = palettized_dense_fused_cuda(x, idx, lut, (K, N))
    second = palettized_dense_fused_cuda(x, idx, lut, (K, N))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_packed_indices_raise(cuda_device):
    x, idx, lut = _inputs(16, 64, 32, 4, torch.bfloat16, cuda_device, seed=0)
    before = palettized_dense_fused_cuda.launches
    with pytest.raises(ValueError, match="unpacked"):
        palettized_dense_fused(x, pack_4bit(idx), lut, (64, 32))
    assert palettized_dense_fused_cuda.launches == before


@pytest.mark.cuda
def test_cpu_tensor_takes_plain_version(cuda_device):
    x, idx, lut = _inputs(16, 64, 32, 4, torch.float32, "cpu", seed=1)
    before = palettized_dense_fused_cuda.launches
    palettized_dense_fused(x, idx, lut, (64, 32))
    assert palettized_dense_fused_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        palettized_dense_fused_cuda(x, idx, lut, (64, 32))
