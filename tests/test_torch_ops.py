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
    ((4096,), 2, 8, 40, (128, 1, 128, 4)),   # SD-1.5 64x64 blocks
    ((1024,), 2, 8, 80, (64, 2, 64, 4)),     # 32x32: 128 blocks < 132 SMs
    ((256,), 2, 8, 160, (64, 3, 64, 3)),     # 16x16
    ((2304,), 2, 8, 80, (128, 2, 64, 4)),    # 768x768's 48x48
    ((4096,), 2, 8, 160, (64, 3, 64, 3)),    # three chunks: 64 rows always
    ((4096,), 2, 5, 64, (128, 1, 128, 4)),   # SD-2.1, as before
    ((4096, 154), 2, 24, 64, (128, 1, 128, 4)),
])
def test_bf16_plan(q_lens, B, H, D, want):
    """The bf16 kernel's instantiation (rows, chunks, kv rows, stages), as
    csrc/flash_attention.cu:FlashShape and launch_wgmma choose it, in one
    block's shared memory."""
    from ml_stable_diffusion_torch.ops.flash_attention import bf16_plan

    plan = bf16_plan(q_lens, B, H, D)
    assert (plan.rows, plan.chunks, plan.kv_rows, plan.stages) == want
    assert plan.smem_bytes <= 232448
