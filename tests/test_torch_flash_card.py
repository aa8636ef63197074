"""The flash CUDA kernel against its plain version, on the card: the
single-stream entry and the multi-stream one (SD3's joint attention).

Skips without an NVIDIA GPU.  This file imports no JAX, so it also runs on
a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_flash_card.py
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import pytest
import torch

from ml_stable_diffusion_torch.ops.flash_attention import (
    SMS,
    bf16_plan,
    flash_attention,
    flash_attention_cuda,
    flash_attention_multi_q,
    flash_attention_multi_q_cuda,
    flash_attention_multi_q_reference,
    flash_attention_reference,
    flash_attention_wide_f32_cuda,
    flash_split_tf32_cuda,
    flash_split_tf32_reference,
    persistent_resident_blocks,
    wide_f32_plan,
    wide_f32_planes,
)

#: max-abs tolerance against the plain version (tests/test_pallas_kernels.py's)
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: relative RMS tolerance, ||got - ref|| / ||ref||: with unit-normal inputs a
#: bfloat16 output is itself of the order of ATOL, so the max-abs bound alone
#: would pass a kernel that dropped a KV tile; f32 leaves room for the
#: kernels' own summation order (chip_smoke.py holds the same bounds)
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
    ((1, 330, 1, 512), torch.float32),    # 3xTF32: ragged, 6 kv splits and the combine
    ((1, 4096, 1, 512), torch.float32),   # 3xTF32: the SD-2.1 VAE, 2 kv splits
    ((2, 300, 3, 512), torch.float32),    # 3xTF32: several heads
    ((1, 300, 1, 512), torch.bfloat16),
    ((2, 77, 3, 64), torch.bfloat16),
    ((2, 154, 24, 64), torch.bfloat16),   # 154 keys: under one 128-row k/v tile and a half
    ((2, 1000, 4, 64), torch.bfloat16),   # 128-row q tiles; keys not a multiple of 128
    # SD-1.5's widths: one, two and three 64-column chunks, in both tiles
    # where the width has both
    ((2, 4096, 8, 40), torch.bfloat16),   # 512x512 64x64 blocks: 128-row tiles
    ((2, 330, 3, 40), torch.bfloat16),    # ragged, 64-row tiles
    ((2, 1024, 8, 80), torch.bfloat16),   # 32x32 blocks: 64-row tiles
    ((2, 2304, 8, 80), torch.bfloat16),   # 768x768's 48x48: 128-row tiles
    ((2, 330, 3, 80), torch.bfloat16),    # ragged
    ((2, 256, 8, 160), torch.bfloat16),   # 16x16 blocks: 64-row tiles
    ((2, 1200, 8, 160), torch.bfloat16),  # 64-row tiles at any length; keys not
                                          # a multiple of 64
])
def test_flash_kernel_matches_plain(shape, dtype, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    before = flash_attention_cuda.launches
    wide = flash_attention_wide_f32_cuda.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    # f32 at D = 512 takes the 3xTF32 kernel, every other case the others
    assert flash_attention_wide_f32_cuda.launches == wide + (
        dtype == torch.float32 and shape[-1] == 512)
    assert got.dtype == dtype and got.shape == q.shape
    assert_matches_plain(got, q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,D", [
    # SD-1.5 cross-attention over a prompt of four 77-token windows: 308 =
    # 2 x 128 + 52 keys, the last tile ragged, at every chunked width
    (2, 4096, 308, 40), (2, 1024, 308, 80), (2, 256, 308, 160),
    # and over the multilingual projection's 256 rows
    (2, 4096, 256, 40), (2, 1024, 256, 80), (2, 256, 256, 160),
    # batch 1 (serial CFG, ControlNet)
    (1, 4096, 308, 40), (1, 256, 308, 160),
])
def test_flash_kernel_cross_attention(B, Sq, Sk, D, cuda_device):
    """Sq != Sk on the single-stream entry; k and v fresh projections of
    the context, as ``Attention`` makes them."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    H = 8
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda_device).to(torch.bfloat16)
    ctx = torch.randn(B, Sk, 96, generator=g, device=cuda_device, dtype=torch.bfloat16)
    wk, wv = (torch.randn(H * D, 96, generator=g, device=cuda_device,
                          dtype=torch.bfloat16) / 10 for _ in range(2))
    k, v = ((ctx @ w.t()).view(B, Sk, H, D) for w in (wk, wv))
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
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
@pytest.mark.parametrize("D", [40, 80, 160])
def test_flash_kernel_reads_fused_projection_views(D, cuda_device):
    """SD-1.5's widths with q, k, v as views of one fused (B, S, 3 H D)
    projection: row strides of 3 H D elements, read in place."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    B, S, H = 2, 300, 8
    x = torch.randn(B, S, 64, generator=g, device=cuda_device, dtype=torch.bfloat16)
    w = torch.randn(3 * H * D, 64, generator=g, device=cuda_device, dtype=torch.bfloat16)
    q, k, v = (x @ w.t() / 8).view(B, S, 3, H, D).unbind(2)
    assert not q.is_contiguous()
    assert_matches_plain(flash_attention_cuda(q, k, v), q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [40, 80, 160])
def test_multi_q_kernel_at_sd15_widths(D, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(6)
    qs = [torch.randn(2, n, 4, D, generator=g, device=cuda_device).to(torch.bfloat16)
          for n in (300, 77)]
    k, v = (torch.randn(2, 377, 4, D, generator=g, device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    for out, ref in zip(flash_attention_multi_q_cuda(qs, k, v),
                        flash_attention_multi_q_reference(qs, k, v)):
        diff = out.float() - ref.float()
        assert diff.abs().max().item() <= ATOL[torch.bfloat16]
        assert (diff.norm() / ref.float().norm()).item() <= REL_RMS[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,D", [
    # the persistent kernel at D = 40 and 80 (csrc/flash_attention.cu:
    # flash_wgmma_persistent): 128-row tiles with a partial last one
    (2, 1000, 1000, 40), (2, 1000, 330, 80),
    # five query tiles a head: the last cluster pair's second tile is past
    # the sequence (D = 40 pairs blocks)
    (2, 640, 640, 40),
    # short and ragged kv loops: 256, 308 and 330 keys at both widths
    (2, 4096, 330, 40), (2, 1024, 330, 80), (2, 2304, 256, 80), (2, 2304, 308, 80),
    # batch 1: D = 40 keeps 128-row pairs, D = 80 takes 64-row tiles
    (1, 4096, 330, 40), (1, 1024, 308, 80), (1, 1000, 256, 80),
    # several units a block, kv over many tiles
    (2, 2304, 2304, 80),
])
def test_persistent_kernel_edges(B, Sq, Sk, D, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(8)
    H = 8
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn(B, Sk, H, D, generator=g, device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert_matches_plain(got, q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [40, 80])
def test_persistent_kernel_reads_fused_projection_views(D, cuda_device):
    """128-row tiles (and at D = 40 cluster pairs) over views of one fused
    (B, S, 3 H D) projection."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    B, S, H = 2, 1100, 8
    x = torch.randn(B, S, 64, generator=g, device=cuda_device, dtype=torch.bfloat16)
    w = torch.randn(3 * H * D, 64, generator=g, device=cuda_device, dtype=torch.bfloat16)
    q, k, v = (x @ w.t() / 8).view(B, S, 3, H, D).unbind(2)
    assert not q.is_contiguous()
    assert_matches_plain(flash_attention_cuda(q, k, v), q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("q_lens,D", [((4096, 77), 40), ((1024, 77), 80)])
def test_multi_q_persistent_wide(q_lens, D, cuda_device):
    """Two query streams at SD-1.5's widths on 128-row tiles: 33 tiles a
    head at D = 40, an odd count for the cluster pairs, across the streams'
    boundary."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    qs = [torch.randn(2, n, 8, D, generator=g, device=cuda_device).to(torch.bfloat16)
          for n in q_lens]
    k, v = (torch.randn(2, sum(q_lens), 8, D, generator=g, device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    for out, ref in zip(flash_attention_multi_q_cuda(qs, k, v),
                        flash_attention_multi_q_reference(qs, k, v)):
        diff = out.float() - ref.float()
        assert diff.abs().max().item() <= ATOL[torch.bfloat16]
        assert (diff.norm() / ref.float().norm()).item() <= REL_RMS[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("q_lens,B,D", [((4096,), 2, 40), ((4096,), 1, 40), ((1024,), 2, 80),
                                        ((1024,), 1, 80), ((330,), 2, 40)])
def test_persistent_grid_fits_the_card(q_lens, B, D, cuda_device):
    """bf16_plan's persistent grid assumes blocks_per_sm blocks on every SM
    at once (clusters of two at D = 40 with 128-row tiles); the CUDA
    runtime's count for the instantiation the launch takes agrees."""
    plan = bf16_plan(q_lens, B, 8, D)
    assert plan.kernel == "persistent"
    assert persistent_resident_blocks(D, plan.rows) == plan.blocks_per_sm * SMS


@pytest.mark.cuda
def test_flash_kernel_rejects_unsupported(cuda_device):
    q = torch.zeros(1, 256, 2, 96, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head widths"):
        flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 256, 2, 80, device=cuda_device, dtype=torch.float32)
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
@pytest.mark.parametrize("q_lens,sk,heads", [
    ((384, 77), 461, 3),     # ragged streams and keys, kv splits
    ((4096, 154), 4250, 1),  # two streams over 67 key tiles: 3 splits of 23
])
def test_wide_f32_multi_q_matches_plain(q_lens, sk, heads, cuda_device):
    """f32 D = 512 query streams through the 3xTF32 kernel's stream table."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    qs = [torch.randn(1, n, heads, 512, generator=g, device=cuda_device) for n in q_lens]
    k, v = (torch.randn(1, sk, heads, 512, generator=g, device=cuda_device) for _ in range(2))
    before = flash_attention_wide_f32_cuda.launches
    got = flash_attention_multi_q_cuda(qs, k, v)
    torch.cuda.synchronize()
    assert flash_attention_wide_f32_cuda.launches == before + 1
    for out, ref in zip(got, flash_attention_multi_q_reference(qs, k, v)):
        diff = out - ref
        assert diff.abs().max().item() <= ATOL[torch.float32]
        assert (diff.norm() / ref.norm()).item() <= REL_RMS[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("q_lens,sk,B,H", [((330,), 330, 1, 1), ((70, 5), 100, 2, 3)])
def test_split_prepass_matches_plain(q_lens, sk, B, H, cuda_device):
    """The pre-pass writes the planes of its plain version bit for bit: the
    same round-to-nearest-away tf32 split, padding and transposition."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    qs = [torch.randn(B, n, H, 512, generator=g, device=cuda_device) for n in q_lens]
    k, v = (torch.randn(B, sk, H, 512, generator=g, device=cuda_device) for _ in range(2))
    plan = wide_f32_plan(q_lens, sk, B, H)
    ws = torch.full((plan.workspace_bytes // 4,), float("nan"), device=cuda_device)
    flash_split_tf32_cuda(qs, k, v, plan, ws)
    torch.cuda.synchronize()
    for got, ref in zip(wide_f32_planes(ws, plan, B, H),
                        flash_split_tf32_reference(qs, k, v, plan)):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_multi_q_kernel_rejects_unsupported(cuda_device):
    q = torch.zeros(1, 256, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1 to 4 query streams"):
        flash_attention_multi_q_cuda([q] * 5, q, q)
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention_multi_q_cuda([q, q.float()], q, q)
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention_multi_q_cuda([q, q[:, :, :1]], q, q)
