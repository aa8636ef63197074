"""The port's SD3 pieces against the JAX package, on the CPU: the joint
attention (multi-stream flash path and its dispatch), the rectified-flow
scheduler, the MMDiT, and the SD3 configurations of CLIP, VAE and MMDiT.

Inputs come from seeded numpy.  Tolerances: the multi-stream flash path
against the Pallas kernel in interpret mode at tests/test_pallas_kernels.py's
multi-stream shapes, atol 2e-5 in float32 (that file's) and 2e-2 with a
relative RMS of 1e-2 in bfloat16 (tests/test_torch_ops.py's); scheduler
tables equal, steps within 1e-6; a tiny MMDiT within PSNR 35 dB of the Flax
model in float32 (measured: ~118 dB, max abs 5e-5 of a ~6.5 peak) and atol
2e-4.  The CUDA kernel itself is checked on the card by
tests/test_torch_flash_card.py and chip_smoke.py.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.models.clip import CLIPTextConfig as JaxCLIPConfig
from ml_stable_diffusion_tpu.models.clip import CLIPTextEncoder as JaxCLIP
from ml_stable_diffusion_tpu.models.mmdit import MMDiT as JaxMMDiT
from ml_stable_diffusion_tpu.models.mmdit import MMDiTConfig as JaxMMDiTConfig
from ml_stable_diffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
from ml_stable_diffusion_tpu.models.vae import VAEDecoder as JaxVAEDecoder
from ml_stable_diffusion_tpu.ops.attention import joint_dot_product_attention as jax_joint
from ml_stable_diffusion_tpu.ops.flash_attention import flash_attention_multi_q as jax_multi_q
from ml_stable_diffusion_tpu.schedulers import DiscreteFlowScheduler as JaxFlow

from ml_stable_diffusion_torch.convert.from_jax import (
    clip_text_state_dict,
    mmdit_state_dict,
    vae_decoder_state_dict,
)
from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from ml_stable_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEDecoder
from ml_stable_diffusion_torch.ops import attention as port_attn
from ml_stable_diffusion_torch.ops.flash_attention import (
    flash_attention_multi_q,
    flash_attention_multi_q_cuda,
)
from ml_stable_diffusion_torch.schedulers import SCHEDULER_MAP, DiscreteFlowScheduler

from helpers import mmdit_params_to_diffusers_sd, randomize_params
from test_torch_models import _layout

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
REL_RMS = {"float32": 1e-5, "bfloat16": 1e-2}
#: tests/test_pallas_kernels.py::test_flash_multi_q_matches_concat's shapes
B, H, D, NX, NC = 2, 3, 64, 384, 77


def _streams(seed=0, nx=NX, nc=NC):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, n, H, D).astype(np.float32) for n in (nx, nc, nx + nc, nx + nc)]


def _to(x, dtype, lib):
    if lib == "jax":
        return jnp.asarray(x).astype(getattr(jnp, dtype))
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


def _assert_close(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    np.testing.assert_allclose(got, ref, atol=ATOL[dtype])
    assert np.sqrt(((got - ref) ** 2).sum() / (ref ** 2).sum()) <= REL_RMS[dtype]


# -- joint attention -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_q_matches_pallas_interpret(dtype):
    qx, qc, k, v = _streams()
    ref = jax_multi_q([_to(qx, dtype, "jax"), _to(qc, dtype, "jax")],
                      _to(k, dtype, "jax"), _to(v, dtype, "jax"), interpret=True)
    got = flash_attention_multi_q([_to(qx, dtype, "torch"), _to(qc, dtype, "torch")],
                                  _to(k, dtype, "torch"), _to(v, dtype, "torch"))
    assert [tuple(g.shape) for g in got] == [(B, NX, H, D), (B, NC, H, D)]
    for g, r in zip(got, ref):
        assert g.dtype == getattr(torch, dtype)
        _assert_close(g, r, dtype)


@pytest.mark.parametrize("impl", ["auto", "plain", "flash"])
def test_joint_attention_matches_jax(impl):
    """Every implementation gives the JAX joint attention (its XLA path on
    the CPU); on CPU tensors FLASH takes the kernel's plain version."""
    qx, qc, k, v = _streams(seed=1)
    ref = jax_joint([jnp.asarray(qx), jnp.asarray(qc)], jnp.asarray(k), jnp.asarray(v))
    got = port_attn.joint_dot_product_attention(
        [torch.from_numpy(qx), torch.from_numpy(qc)], torch.from_numpy(k),
        torch.from_numpy(v), impl=impl)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), _np(r), atol=ATOL["float32"])


@pytest.mark.parametrize("nx,nc,flash", [
    (4096, 154, True),   # SD3-medium 1024x1024: the context stream rides along
    (1024, 154, True),   # 512x512
    (255, 154, False),   # the first stream below the threshold
    (16, 10, False),     # the tiny test model
])
def test_joint_dispatch_decides_on_the_first_stream(nx, nc, flash, monkeypatch):
    """AUTO on a CUDA tensor sends every stream to the kernel exactly when
    the first stream qualifies (the JAX rule); a CPU tensor stays plain.
    Meta tensors stand in for CUDA ones."""
    calls = []
    monkeypatch.setattr("ml_stable_diffusion_torch.ops.flash_attention.flash_attention_multi_q",
                        lambda qs, k, v: calls.append(len(qs)) or list(qs))
    qs = [torch.empty(1, nx, 2, 64, device="meta"), torch.empty(1, nc, 2, 64, device="meta")]
    k = torch.empty(1, nx + nc, 2, 64, device="meta")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    port_attn.joint_dot_product_attention(qs, k, k)
    assert calls == ([2] if flash else [])


def test_multi_q_kernel_wrapper_raises_off_the_card():
    qx, qc, k, v = (torch.from_numpy(x) for x in _streams())
    before = flash_attention_multi_q_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_multi_q_cuda([qx, qc], k, v)
    with pytest.raises(ValueError, match="1 to 4 query streams"):
        flash_attention_multi_q_cuda([qx] * 5, k, v)
    assert flash_attention_multi_q_cuda.launches == before


# -- rectified-flow scheduler ------------------------------------------------------

@pytest.mark.parametrize("shift", [1.0, 3.0])
@pytest.mark.parametrize("steps", [4, 20])
def test_flow_scheduler_matches_jax(steps, shift):
    """Grid, float timesteps, Euler velocity steps and pred_x0, step by step."""
    jsched, psched = JaxFlow(shift=shift), DiscreteFlowScheduler(shift=shift)
    jplan, pplan = jsched.set_timesteps(steps), psched.set_timesteps(steps)
    assert pplan.num_steps == jplan.num_steps and pplan.init_noise_sigma == 1.0
    np.testing.assert_array_equal(pplan.timesteps, np.asarray(jplan.timesteps))
    np.testing.assert_array_equal(pplan.table("sigmas"), np.asarray(jplan.table("sigmas")))
    rng = np.random.RandomState(steps)
    x = rng.randn(1, 16, 8, 8).astype(np.float32)
    outs = rng.randn(steps, 1, 16, 8, 8).astype(np.float32)
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    for i in range(steps):
        v = outs[i]
        np.testing.assert_allclose(
            psched.pred_x0(pplan, {}, torch.from_numpy(v), i, px).numpy(),
            np.asarray(jsched.pred_x0(jplan, {}, jnp.asarray(v), i, jx)), rtol=1e-6, atol=1e-6)
        _, jx = jsched.step(jplan, {}, jnp.asarray(v), i, jx)
        _, px = psched.step(pplan, {}, torch.from_numpy(v), i, px)
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6,
                                   err_msg=f"step {i}")


def test_flow_scheduler_is_registered_and_rejects_img2img():
    """Registered; img2img strength, which it rejected before the VAE
    encoder was ported, now slices the sigma grid as the JAX scheduler's."""
    assert SCHEDULER_MAP["DiscreteFlow"] is DiscreteFlowScheduler
    got = DiscreteFlowScheduler().set_timesteps(4, strength=0.5)
    ref = JaxFlow().set_timesteps(4, strength=0.5)
    assert got.num_steps == ref.num_steps == 2
    np.testing.assert_array_equal(got.table("sigmas"), np.asarray(ref.table("sigmas")))


# -- MMDiT -------------------------------------------------------------------------

def _tiny_mmdit(qk_norm):
    """tests/test_pipeline_sd3.py's tiny MMDiT, with or without qk RMSNorm."""
    cfg = JaxMMDiTConfig(patch_size=2, in_channels=16, out_channels=16, depth=2,
                         hidden_size=32, num_heads=4, context_dim=128, pooled_dim=64,
                         pos_embed_max_size=16, qk_norm=qk_norm)
    model = JaxMMDiT(cfg)
    params = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 8, 8, 16)),
                            jnp.zeros((1,)), jnp.zeros((1, 10, 128)), jnp.zeros((1, 64)))["params"]
    return model, randomize_params(params, seed=21 + qk_norm)


def _psnr(got, ref):
    return 10 * np.log10(np.abs(ref).max() ** 2 / ((got - ref) ** 2).mean())


@pytest.mark.parametrize("loader", ["from_jax", "diffusers"])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_mmdit_matches_flax(qk_norm, loader):
    """Weights carried by convert.from_jax.mmdit_state_dict, or laid out as a
    diffusers SD3Transformer2DModel checkpoint (tests/helpers.py), load
    strictly; NCHW in and out against the Flax NHWC model, float timesteps."""
    model, params = _tiny_mmdit(qk_norm)
    if loader == "from_jax":
        sd = mmdit_state_dict(jax.tree.map(np.asarray, params))
    else:
        sd = {k: torch.from_numpy(v.copy())
              for k, v in mmdit_params_to_diffusers_sd(params).items()}
    port = MMDiT(MMDiTConfig(**dataclasses.asdict(model.config)))
    port.load_state_dict(sd, strict=True)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    t = np.asarray([997.25, 3.5], np.float32)
    ctx = rng.randn(2, 10, 128).astype(np.float32)
    pooled = rng.randn(2, 64).astype(np.float32)
    ref = np.asarray(jax.jit(model.apply)({"params": params}, x, t, ctx, pooled))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                   torch.from_numpy(ctx), torch.from_numpy(pooled))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 8, 8)
    got = got.permute(0, 2, 3, 1).numpy()
    assert _psnr(got, ref) >= 35.0
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_mmdit_scalar_timestep_and_unported_controlnet():
    model, params = _tiny_mmdit(False)
    port = MMDiT(MMDiTConfig(**dataclasses.asdict(model.config)))
    port.load_state_dict(mmdit_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 16, 8, 8).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(2, 10, 128).astype(np.float32))
    pooled = torch.from_numpy(rng.randn(2, 64).astype(np.float32))
    with torch.no_grad():
        a = port(x, torch.tensor(500.0), ctx, pooled)
        b = port(x, torch.tensor([500.0, 500.0]), ctx, pooled)
    torch.testing.assert_close(a, b)
    # SD3 ControlNet residuals (no longer refused): one residual for every
    # block but the last, against Flax (tests/test_torch_controlnet_sd3.py
    # holds the interval scheme at 3 to 5 residuals)
    res = rng.randn(2, 16, 32).astype(np.float32)
    ref = np.asarray(model.apply({"params": params}, x.permute(0, 2, 3, 1).numpy(),
                                 np.full((2,), 500.0, np.float32), ctx.numpy(), pooled.numpy(),
                                 controlnet_residuals=(res,)))
    with torch.no_grad():
        got = port(x, torch.tensor(500.0), ctx, pooled,
                   controlnet_residuals=[torch.from_numpy(res)])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=2e-4)
    assert np.abs(got.numpy() - a.numpy()).max() > 1e-2


# -- SD3 configurations at full size ---------------------------------------------------

@pytest.mark.parametrize("kind", ["mmdit_sd3_medium", "clip_l", "clip_g", "vae_sd3"])
def test_sd3_full_size_layout_loads(kind):
    """Every converted key of the full-size JAX configuration exists in the
    port module with the converted shape, and nothing is missing (what a
    strict load checks), from abstract shapes only."""
    if kind == "mmdit_sd3_medium":
        jcfg, pcfg = JaxMMDiTConfig.sd3_medium(), MMDiTConfig.sd3_medium()
        fields = dataclasses.asdict(pcfg)
        # the port's MMDiT-X field (SD3.5-medium), which the JAX MMDiT lacks
        assert fields.pop("dual_attention_layers") == ()
        assert fields == dataclasses.asdict(jcfg)
        args = (jnp.zeros((1, 16, 16, 16)), jnp.zeros((1,)),
                jnp.zeros((1, 154, jcfg.context_dim)), jnp.zeros((1, jcfg.pooled_dim)))
        layout = _layout(JaxMMDiT(jcfg), args, mmdit_state_dict)
        with torch.device("meta"):
            port = MMDiT(pcfg)
    elif kind.startswith("clip"):
        jcfg = JaxCLIPConfig.sd1() if kind == "clip_l" else JaxCLIPConfig.sdxl_g()
        pcfg = CLIPTextConfig.sd1() if kind == "clip_l" else CLIPTextConfig.sdxl_g()
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
        layout = _layout(JaxCLIP(jcfg), (jnp.zeros((1, 77), jnp.int32),), clip_text_state_dict)
        with torch.device("meta"):
            port = CLIPTextEncoder(pcfg)
    else:
        jcfg, pcfg = JaxVAEConfig.sd3(), VAEConfig.sd3()
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
        layout = _layout(JaxVAEDecoder(jcfg), (jnp.zeros((1, 8, 8, 16)),),
                         vae_decoder_state_dict)
        with torch.device("meta"):
            port = VAEDecoder(pcfg)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    if kind == "mmdit_sd3_medium":
        # the (M, M, D) positional grid converts to the diffusers (1, M*M, D)
        M, D = pcfg.pos_embed_max_size, pcfg.hidden_size
        assert layout.pop("pos_embed.pos_embed") == (M, M, D)
        assert want.pop("pos_embed.pos_embed") == (1, M * M, D)
    assert layout == want


def test_sd35_large_config_is_the_jax_one():
    """SD3.5-large differs from SD3-medium only in its sizes and qk RMSNorm,
    whose layout the tiny qk_norm model above checks."""
    fields = dataclasses.asdict(MMDiTConfig.sd35_large())
    # the port's MMDiT-X field (SD3.5-medium), which the JAX MMDiT lacks
    assert fields.pop("dual_attention_layers") == ()
    assert fields == dataclasses.asdict(JaxMMDiTConfig.sd35_large())


def test_sd3_pooled_width():
    """CLIP-L's unprojected pooled output (768) and bigG's projection (1280)
    make the MMDiT's 2048-wide pooled input."""
    with torch.device("meta"):
        l_out = CLIPTextEncoder(CLIPTextConfig.sd1())(torch.zeros(1, 77, dtype=torch.long))
        g_out = CLIPTextEncoder(CLIPTextConfig.sdxl_g())(torch.zeros(1, 77, dtype=torch.long))
    widths = (l_out["pooled_output"].shape[-1], g_out["pooled_output"].shape[-1])
    assert widths == (768, 1280) and sum(widths) == MMDiTConfig.sd3_medium().pooled_dim
    assert (l_out["penultimate_hidden_state"].shape[-1]
            + g_out["penultimate_hidden_state"].shape[-1]) == 2048
