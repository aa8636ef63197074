"""Port attention and activations against the JAX package, on the CPU.

The port's plain path is held against ``_xla_attention``; its flash-path
function (on a CPU tensor: the kernel's plain version) against the JAX
flash wrapper with the Pallas kernel in interpret mode, at the shapes of
tests/test_pallas_kernels.py.  Max-abs tolerances are that file's: 2e-5 in
float32, 2e-2 in bfloat16.  With unit-normal q, k, v a bfloat16 output is
itself ~2e-2 at 1024 keys, so a relative RMS bound scaled to the reference
is also held: 1e-5 in float32, 1e-2 in bfloat16 (measured on the CPU:
<= 5e-7 and <= 3.1e-3).  The CUDA kernel itself is checked on the card by
tests/test_torch_flash_card.py and by chip_smoke.py.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ml_stable_diffusion_tpu.ops import activations as jax_act
from ml_stable_diffusion_tpu.ops.attention import _flash_qualifies as jax_flash_qualifies
from ml_stable_diffusion_tpu.ops.attention import _xla_attention
from ml_stable_diffusion_tpu.ops.flash_attention import flash_attention as jax_flash

from ml_stable_diffusion_torch.ops import activations as port_act
from ml_stable_diffusion_torch.ops import attention as port_attn
from ml_stable_diffusion_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    SUPPORTED_HEAD_DIMS,
    flash_attention,
    flash_attention_cuda,
)

SHAPES = [
    (256, 77, "float32"),
    (256, 77, "bfloat16"),
    (256, 256, "float32"),
    (1024, 1024, "bfloat16"),
    (512, 200, "float32"),
    (330, 330, "float32"),
]
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
REL_RMS = {"float32": 1e-5, "bfloat16": 1e-2}


def _qkv(sq, sk, D=64, B=2, H=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, sq, H, D).astype(np.float32),
            rng.randn(B, sk, H, D).astype(np.float32),
            rng.randn(B, sk, H, D).astype(np.float32))


def _jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


def _assert_close(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, atol=ATOL[dtype])
    rel_rms = np.sqrt(((got - ref) ** 2).sum() / (ref ** 2).sum())
    assert rel_rms <= REL_RMS[dtype], rel_rms


@pytest.mark.parametrize("sq,sk,dtype", SHAPES)
def test_plain_attention_matches_xla(sq, sk, dtype):
    q, k, v = _qkv(sq, sk)
    ref = _xla_attention(*(_jax(x, dtype) for x in (q, k, v)))
    got = port_attn._plain_attention(*(_torch(x, dtype) for x in (q, k, v)))
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("sq,sk,dtype", SHAPES)
def test_flash_path_matches_pallas_interpret(sq, sk, dtype):
    q, k, v = _qkv(sq, sk, seed=1)
    ref = jax_flash(*(_jax(x, dtype) for x in (q, k, v)), block_q=256,
                    block_k=128, interpret=True)
    got = flash_attention(*(_torch(x, dtype) for x in (q, k, v)))
    _assert_close(got, ref, dtype)


def test_flash_wide_head_matches_pallas_interpret():
    """The VAE's single 512-wide head (tests/test_pallas_kernels.py's
    wide-head case and tolerance)."""
    q, k, v = _qkv(256, 256, D=512, B=1, H=1, seed=7)
    ref = jax_flash(*(_jax(x, "float32") for x in (q, k, v)), block_q=128,
                    block_k=128, interpret=True)
    got = flash_attention(*(_torch(x, "float32") for x in (q, k, v)))
    np.testing.assert_allclose(_np(got), _np(ref), atol=3e-5)


@pytest.mark.parametrize("sq,sk", [(77, 77), (12, 20)])
def test_plain_causal_and_bias_match_xla(sq, sk):
    q, k, v = _qkv(sq, sk, seed=2)
    bias = np.random.RandomState(3).randn(1, 3, sq, sk).astype(np.float32)
    for kw_j, kw_t in [({"causal": True}, {"causal": True}),
                       ({"bias": jnp.asarray(bias)}, {"bias": torch.from_numpy(bias)})]:
        ref = _xla_attention(*(_jax(x, "float32") for x in (q, k, v)), **kw_j)
        got = port_attn.dot_product_attention(
            *(_torch(x, "float32") for x in (q, k, v)), **kw_t)
        np.testing.assert_allclose(_np(got), _np(ref), atol=2e-5)


@pytest.mark.parametrize("sq,sk,D", [
    (4096, 4096, 64), (1024, 1024, 64), (256, 256, 64),  # UNet self-attention
    (4096, 77, 64),       # UNet cross attention
    (64, 64, 64),         # 8x8 mid block
    (77, 77, 64),         # text encoder
    (4096, 4096, 512),    # VAE mid block
    (255, 4096, 64), (4096, 255, 64),  # below the threshold on either side
    (4096, 4096, 80),     # SD-1.5's width in float32: no f32 kernel at it
])
def test_dispatch_rule_follows_jax(sq, sk, D, monkeypatch):
    """On a CUDA tensor the port takes FLASH exactly where the JAX rule does
    (Sq >= 256, Sk >= 256) and the kernel has the dtype's head width; a CPU
    tensor never qualifies.  Shapes only: meta tensors stand in for CUDA
    ones (float32 here, bfloat16 below)."""
    _check_dispatch(sq, sk, D, torch.float32, monkeypatch)


@pytest.mark.parametrize("sq,sk,D", [
    (4096, 4096, 40), (1024, 1024, 80), (256, 256, 160),  # SD-1.5 self-attention
    (4096, 77, 40),       # its cross attention
    (4096, 4096, 64),
    (4096, 4096, 96),     # a width no configuration produces
])
def test_dispatch_rule_follows_jax_in_bf16(sq, sk, D, monkeypatch):
    _check_dispatch(sq, sk, D, torch.bfloat16, monkeypatch)


def _check_dispatch(sq, sk, D, dtype, monkeypatch):
    q = torch.empty(1, sq, 1, D, device="meta", dtype=dtype)
    k = torch.empty(1, sk, 1, D, device="meta", dtype=dtype)
    assert not port_attn._flash_qualifies(q, k)  # not a CUDA tensor
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr("jax.default_backend", lambda: "tpu")
    jax_rule = jax_flash_qualifies(jnp.zeros((1, sq, 1, D)), jnp.zeros((1, sk, 1, D)))
    assert port_attn._flash_qualifies(q, k) == (jax_rule and D in KERNEL_HEAD_DIMS[dtype])
    assert set(KERNEL_HEAD_DIMS[dtype]) <= set(SUPPORTED_HEAD_DIMS)


def test_auto_dispatch_on_cpu_is_plain(monkeypatch):
    calls = []
    monkeypatch.setattr("ml_stable_diffusion_torch.ops.flash_attention.flash_attention",
                        lambda *a, **k: calls.append(1))
    q, k, v = (_torch(x, "float32") for x in _qkv(256, 256))
    port_attn.dot_product_attention(q, k, v)
    assert calls == []


def test_kernel_wrapper_raises_off_the_card():
    q, k, v = (_torch(x, "float32") for x in _qkv(256, 256))
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=True)
    assert flash_attention_cuda.launches == before


@pytest.mark.parametrize("name", ["gelu_erf", "gelu_tanh", "quick_gelu"])
def test_activations_match_jax(name):
    x = np.random.RandomState(4).randn(4, 257).astype(np.float32) * 4
    ref = getattr(jax_act, name)(jnp.asarray(x))
    got = getattr(port_act, name)(torch.from_numpy(x))
    # atol 1e-5 on values up to 12: the two erf implementations differ in the
    # last bits, and 1 + erf(x) cancels for large negative x
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("q_lens,B,H,D,want", [
    # (kernel, query rows, chunks, kv rows, stages, q buffers, P v columns,
    # cluster, blocks)
    # SD-1.5 64x64: 128-row tiles, pairs of blocks sharing k/v loads, a
    # block an SM; batch 1 (ControlNet, serial CFG) the same
    ((4096,), 2, 8, 40, ("persistent", 128, 1, 128, 4, 2, 40, 2, 132)),
    ((4096,), 1, 8, 40, ("persistent", 128, 1, 128, 4, 2, 40, 2, 132)),
    # an odd count of query tiles: the last pair's second tile is past the end
    ((640,), 2, 8, 40, ("persistent", 128, 1, 128, 4, 2, 40, 2, 96)),
    # 32x32: 128 blocks of 128 rows, no cluster; three kv stages and one q
    # buffer fit two chunks
    ((1024,), 2, 8, 80, ("persistent", 128, 2, 128, 3, 1, 80, 1, 128)),
    ((2304,), 2, 8, 80, ("persistent", 128, 2, 128, 3, 1, 80, 1, 132)),
    # batch-1 32x32: 128-row tiles would leave half the SMs idle
    ((1024,), 1, 8, 80, ("persistent", 64, 2, 64, 4, 2, 80, 1, 128)),
    # ragged and small: 64-row tiles, two blocks an SM at one chunk
    ((330,), 2, 3, 40, ("persistent", 64, 1, 64, 4, 2, 40, 1, 36)),
    ((300, 77), 2, 4, 40, ("persistent", 64, 1, 64, 4, 2, 40, 1, 56)),
    ((330,), 2, 3, 80, ("persistent", 64, 2, 64, 4, 2, 80, 1, 36)),
    # 16x16 and D = 160 at any length: the per-tile kernel, 64 rows
    ((256,), 2, 8, 160, ("per-tile", 64, 3, 64, 3, 1, 192, 1, 64)),
    ((4096,), 2, 8, 160, ("per-tile", 64, 3, 64, 3, 1, 192, 1, 1024)),
    # D = 64 (SD-2.1, SDXL, SD3) as before
    ((4096,), 2, 5, 64, ("per-tile", 128, 1, 128, 4, 1, 64, 1, 320)),
    ((256,), 2, 20, 64, ("per-tile", 64, 1, 64, 4, 1, 64, 1, 160)),
    ((4096, 154), 2, 24, 64, ("per-tile", 128, 1, 128, 4, 1, 64, 1, 1632)),
])
def test_bf16_plan(q_lens, B, H, D, want):
    """The bf16 kernels' instantiation, as csrc/flash_attention.cu's
    FlashShape / launch_wgmma and PersistShape / launch_persistent_plan
    choose it, in one block's shared memory (half an SM's at two blocks)."""
    from ml_stable_diffusion_torch.ops.flash_attention import (
        SMEM_ONE_BLOCK,
        SMEM_TWO_BLOCKS,
        bf16_plan,
    )

    plan = bf16_plan(q_lens, B, H, D)
    assert (plan.kernel, plan.rows, plan.chunks, plan.kv_rows, plan.stages, plan.q_buffers,
            plan.pv_cols, plan.cluster, plan.blocks) == want
    assert plan.smem_bytes <= (SMEM_TWO_BLOCKS if plan.blocks_per_sm == 2 else SMEM_ONE_BLOCK)
    # the FMA pipe takes 1/8 of the exponentials where the SFU bounds the
    # kernel: D = 40's 192 tensor flops a logit against an exponential's 256
    assert plan.fma_exp_share == (0.125 if D == 40 else 0.0)


def _phase2_bf16_shapes():
    import chip_smoke

    return [(label, q_lens, B, H, D) for label, q_lens, _, B, H, D, dtype, _ in
            chip_smoke.FLASH_SHAPES + chip_smoke.MULTI_Q_SHAPES
            if dtype == torch.bfloat16 and D != 512]


@pytest.mark.parametrize("label,q_lens,B,H,D", _phase2_bf16_shapes())
def test_bf16_plan_at_every_phase2_shape(label, q_lens, B, H, D):
    """Every bf16 shape chip_smoke.py's phase 2 runs has a plan that fits,
    on the kernel its width takes, a cluster's blocks a whole number of
    pairs, and no more blocks than work or SMs."""
    from ml_stable_diffusion_torch.ops.flash_attention import (
        PERSISTENT_HEAD_DIMS,
        SMEM_ONE_BLOCK,
        SMEM_TWO_BLOCKS,
        SMS,
        bf16_plan,
    )

    plan = bf16_plan(q_lens, B, H, D)
    assert plan.kernel == ("persistent" if D in PERSISTENT_HEAD_DIMS else "per-tile")
    assert plan.smem_bytes <= (SMEM_TWO_BLOCKS if plan.blocks_per_sm == 2 else SMEM_ONE_BLOCK)
    tiles = sum(-(-n // plan.rows) for n in q_lens) * B * H
    if plan.kernel == "persistent":
        assert plan.blocks % plan.cluster == 0
        assert plan.blocks <= min(plan.blocks_per_sm * SMS, -(-tiles // plan.cluster)
                                  * plan.cluster)
        assert plan.pv_cols == D
    else:
        assert plan.blocks == tiles


def test_exp2_fma_emulation_error_bound():
    """The FMA-pipe 2^x (csrc/hopper.cuh:exp2_fma) against torch.exp2 over
    [-126, 0]: within the relative error its header states, far below
    bf16's rounding of P (2^-9); below -126 (a masked logit) it gives its
    2^-126."""
    from ml_stable_diffusion_torch.ops.flash_attention import (
        EXP2_FMA_REL_ERR,
        exp2_fma_emulation,
    )

    gen = torch.Generator().manual_seed(11)
    x = torch.cat([torch.linspace(-126.0, 0.0, 400_001), -126.0 * torch.rand(200_000, generator=gen),
                   torch.tensor([-126.0, -125.5, -1.5, -0.5, 0.0])])
    got, ref = exp2_fma_emulation(x).double(), torch.exp2(x.double())
    rel = ((got - ref) / ref).abs().max().item()
    assert rel <= EXP2_FMA_REL_ERR
    assert EXP2_FMA_REL_ERR < 2.0 ** -9 / 100
    low = exp2_fma_emulation(torch.tensor([-1e30, -200.0, -126.0])).double()
    assert torch.equal(low, low[2].expand(3))
    assert abs(low[2].item() / 2.0 ** -126 - 1) <= EXP2_FMA_REL_ERR
