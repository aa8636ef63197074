"""The flash CUDA kernel against its plain version, on the card: the
single-stream entry and the multi-stream one (SD3's joint attention).

Skips without an NVIDIA GPU.  This file imports no JAX, so it also runs on
a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_flash_card.py
"""

import pytest
import torch

from ml_stable_diffusion_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_cuda,
    flash_attention_multi_q,
    flash_attention_multi_q_cuda,
    flash_attention_multi_q_reference,
    flash_attention_reference,
)

#: max-abs tolerance against the plain version (tests/test_pallas_kernels.py's)
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: relative RMS tolerance, ||got - ref|| / ||ref||: with unit-normal inputs a
#: bfloat16 output is itself of the order of ATOL, so the max-abs bound alone
#: would pass a kernel that dropped a KV tile; f32 leaves room for the FMA
#: kernel's own summation order (chip_smoke.py holds the same bounds)
REL_RMS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def assert_matches_plain(got, q, k, v):
    ref = flash_attention_reference(q, k, v).float()
    diff = got.float() - ref
    assert diff.abs().max().item() <= ATOL[q.dtype]
    assert (diff.norm() / ref.norm()).item() <= REL_RMS[q.dtype]


@pytest.fixture
def cuda_device():
    """Decided when the test runs, not at import: every worker collects the
    same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((2, 330, 3, 64), torch.float32),
    ((2, 330, 3, 64), torch.bfloat16),
    ((2, 256, 20, 64), torch.bfloat16),
    ((2, 4096, 5, 64), torch.bfloat16),
    ((1, 300, 1, 512), torch.float32),
    ((1, 300, 1, 512), torch.bfloat16),
    ((2, 77, 3, 64), torch.bfloat16),
    ((2, 154, 24, 64), torch.bfloat16),   # 154 keys: under one 128-row k/v tile and a half
    ((2, 1000, 4, 64), torch.bfloat16),   # 128-row q tiles; keys not a multiple of 128
])
def test_flash_kernel_matches_plain(shape, dtype, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert_matches_plain(got, q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [0, 8])
def test_flash_kernel_reads_strided_views(pad, cuda_device):
    """q, k, v as head slices of one (B, S, 3, H, D + pad) projection: the
    kernel reads them through strides (pad 8: a head stride of 144 bytes,
    16-byte aligned but not a whole 128-byte row)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(2, 300, 3, 4, 64 + pad, generator=g,
                      device=cuda_device).to(torch.bfloat16)[..., :64]
    q, k, v = qkv.unbind(2)
    assert_matches_plain(flash_attention_cuda(q, k, v), q, k, v)


@pytest.mark.cuda
def test_flash_kernel_rejects_unsupported(cuda_device):
    q = torch.zeros(1, 256, 2, 80, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head widths"):
        flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 256, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_cuda(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("q_lens,sk,heads,dtype", [
    ((4096, 154), 4250, 24, torch.bfloat16),  # SD3-medium 1024x1024
    ((384, 77), 461, 3, torch.float32),       # ragged: both streams and the keys
    ((384, 77), 461, 3, torch.bfloat16),
    ((300,), 300, 2, torch.bfloat16),         # one stream
    ((5, 70, 64, 1), 140, 2, torch.float32),  # four streams, tiny ones among them
    ((5, 70, 64, 130), 200, 2, torch.bfloat16),  # four streams; keys not a multiple of 128
    ((154,), 4250, 24, torch.bfloat16),       # the context stream alone: 64-row tiles
    ((4096, 154), 154, 2, torch.bfloat16),    # 154 keys
])
def test_multi_q_kernel_matches_plain(q_lens, sk, heads, dtype, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    qs = [torch.randn(2, n, heads, 64, generator=g, device=cuda_device).to(dtype)
          for n in q_lens]
    k, v = (torch.randn(2, sk, heads, 64, generator=g, device=cuda_device).to(dtype)
            for _ in range(2))
    before = flash_attention_multi_q_cuda.launches
    got = flash_attention_multi_q(qs, k, v)
    torch.cuda.synchronize()
    assert flash_attention_multi_q_cuda.launches == before + 1
    refs = flash_attention_multi_q_reference(qs, k, v)
    for out, ref, q in zip(got, refs, qs):
        assert out.dtype == dtype and out.shape == q.shape
        diff = out.float() - ref.float()
        assert diff.abs().max().item() <= ATOL[dtype]
        assert (diff.norm() / ref.float().norm()).item() <= REL_RMS[dtype]


@pytest.mark.cuda
def test_multi_q_kernel_rejects_unsupported(cuda_device):
    q = torch.zeros(1, 256, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1 to 4 query streams"):
        flash_attention_multi_q_cuda([q] * 5, q, q)
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention_multi_q_cuda([q, q.float()], q, q)
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention_multi_q_cuda([q, q[:, :, :1]], q, q)
