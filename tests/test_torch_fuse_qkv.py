"""Fused self-attention projections (``convert/optimize.py:fuse_qkv_params``,
``UNetConfig.fuse_qkv``) against the JAX package's, on the CPU.

The fused state dict equals the JAX fused tree converted (bit for bit); the
fused port UNet agrees with the JAX fused UNet (float32, atol 1e-4: the
timestep embedding's sin/cos ulps, as the unfused UNet's test) and with the
port's unfused UNet on the same weights (atol 1e-5: one GEMM of 3C outputs
for three of C, the same products summed in another blocking).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.convert.optimize import fuse_qkv_params as jax_fuse_qkv_params
from ml_stable_diffusion_tpu.models.unet import UNet2DConditionModel as JaxUNet

from ml_stable_diffusion_torch.convert.from_jax import unet_state_dict
from ml_stable_diffusion_torch.convert.optimize import fuse_qkv_params
from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig

from helpers import CTX_DIM, randomize_params
from torch_helpers import tiny_unet


def _pair(xl):
    model, params = tiny_unet(xl=xl, cross_dim=CTX_DIM)
    return model, jax.tree.map(np.asarray, randomize_params(params, 11))


def _inputs(xl):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([20.0, 700.0], np.float32)
    ctx = rng.randn(2, 77, CTX_DIM).astype(np.float32) * 0.5
    added = ({"text_embeds": rng.randn(2, 32).astype(np.float32),
              "time_ids": rng.uniform(0, 1024, (2, 6)).astype(np.float32)} if xl else None)
    return x, t, ctx, added


def _port(params, fused, xl):
    cfg = UNetConfig(**dataclasses.asdict(tiny_unet(xl=xl, cross_dim=CTX_DIM)[0].config))
    sd = unet_state_dict(params)
    if fused:
        cfg, sd = dataclasses.replace(cfg, fuse_qkv=True), fuse_qkv_params(sd)
    module = UNet2DConditionModel(cfg)
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _call(module, x, t, ctx, added):
    a = None if added is None else {k: torch.from_numpy(v) for k, v in added.items()}
    with torch.no_grad():
        out = module(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(t),
                     torch.from_numpy(ctx), a)
    return out.numpy().transpose(0, 2, 3, 1)


def test_fuse_qkv_params_matches_jax():
    """The port's fused state dict is the JAX fused tree converted: attn1's
    three projections concatenated on the output dim as ``to_qkv``, attn2
    and every other entry as they were."""
    _, params = _pair(False)
    fused = fuse_qkv_params(unet_state_dict(params))
    want = unet_state_dict(jax_fuse_qkv_params(params))
    assert fused.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(fused[k], v), k
    assert any(k.endswith("attn1.to_qkv.weight") for k in fused)
    assert not any(".attn1.to_q." in k or ".attn2.to_qkv" in k for k in fused)
    assert any(".attn2.to_q." in k for k in fused)


@pytest.mark.parametrize("xl", [False, True], ids=["sd", "sdxl"])
def test_fused_unet_matches_jax_and_unfused(xl):
    model, params = _pair(xl)
    x, t, ctx, added = _inputs(xl)
    jmodel = JaxUNet(dataclasses.replace(model.config, fuse_qkv=True))
    kw = {} if added is None else {"added_cond": {k: jnp.asarray(v) for k, v in added.items()}}
    ref = np.asarray(jax.jit(lambda p: jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(t),
                                                    jnp.asarray(ctx), **kw))(
        jax_fuse_qkv_params(params)))
    fused = _call(_port(params, True, xl), x, t, ctx, added)
    plain = _call(_port(params, False, xl), x, t, ctx, added)
    np.testing.assert_allclose(fused, ref, atol=1e-4)
    np.testing.assert_allclose(fused, plain, atol=1e-5)
