"""Full-model conversion gates: ported Flax forward vs the independent torch
mirror (convert/torch_mirrors.py) on the same diffusers-layout state dict.

This is the assembled-model analog of the reference's conversion-time UNet
check (torch2coreml.py:970-975): block ordering, skip-residual pop order,
SDXL's mirrored head indexing, and the MMDiT pos-embed crop are all checked
NUMERICALLY, not by element counts.  Each family also proves the gate TRIPS
on a deliberately mis-wired port (swapped transformer blocks / resnets)."""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.convert import verify
from ml_stable_diffusion_tpu.convert.mmdit import (
    port_mmdit,
    port_sd3_controlnet,
)
from ml_stable_diffusion_tpu.convert.unet import port_unet
from ml_stable_diffusion_tpu.convert.controlnet import port_controlnet
from ml_stable_diffusion_tpu.convert.vae import (
    port_vae_decoder,
    port_vae_encoder,
)
from ml_stable_diffusion_tpu.models.controlnet import ControlNetModel
from ml_stable_diffusion_tpu.models.controlnet_sd3 import (
    SD3ControlNetConfig,
    SD3ControlNetModel,
)
from ml_stable_diffusion_tpu.models.mmdit import MMDiT, MMDiTConfig
from ml_stable_diffusion_tpu.models.unet import UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_tpu.models.vae import VAEConfig, VAEDecoder, VAEEncoder

from helpers import (
    flax_params_to_diffusers_sd,
    mmdit_params_to_diffusers_sd,
    randomize_params,
)

#: heavy E2E/sweep file — excluded from the fast default profile
pytestmark = pytest.mark.slow

TINY_SD = UNetConfig(
    block_out_channels=(32, 64),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1,
    transformer_layers_per_block=(1, 1),
    num_attention_heads=(2, 4),
    cross_attention_dim=48,
    norm_num_groups=8,
)

TINY_XL = dataclasses.replace(
    TINY_SD,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
    transformer_layers_per_block=(1, 2),
    addition_embed_type="text_time",
    projection_class_embeddings_input_dim=32 + 6 * 16,
    addition_time_embed_dim=16,
)

#: fully-distilled LCM shape: guidance embedded via time_cond_proj
TINY_LCM = dataclasses.replace(TINY_SD, time_cond_proj_dim=16)


def _unet_fixture(cfg, seed=7):
    model = UNet2DConditionModel(cfg)
    kwargs = {}
    if cfg.addition_embed_type == "text_time":
        kwargs["added_cond"] = {"text_embeds": jnp.zeros((1, 32)),
                                "time_ids": jnp.zeros((1, 6))}
    if cfg.time_cond_proj_dim:
        kwargs["timestep_cond"] = jnp.zeros((1, cfg.time_cond_proj_dim))
    params = jax.jit(lambda k, *a: model.init(k, *a, **kwargs))(
        jax.random.key(0), jnp.zeros((1, 16, 16, cfg.in_channels)),
        jnp.zeros((1,)), jnp.zeros((1, 77, cfg.cross_attention_dim)))["params"]
    params = randomize_params(params, seed)
    sd = flax_params_to_diffusers_sd(params, "unet")
    return model, params, sd


@pytest.mark.parametrize("cfg", [TINY_SD, TINY_XL, TINY_LCM],
                         ids=["sd", "xl", "lcm"])
def test_unet_full_model_gate(cfg):
    model, params, sd = _unet_fixture(cfg)
    # the port must reproduce the tree bit-exactly (inverse-mapping sanity)
    ported = port_unet(sd, cfg)
    for (pa, va), (_, vb) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(ported)):
        np.testing.assert_array_equal(np.asarray(va), vb,
                                      err_msg=jax.tree_util.keystr(pa))
    psnr = verify.torch_parity_unet(sd, model, ported, text_embed_dim=32)
    assert psnr >= 35.0


def test_unet_gate_trips_on_swapped_transformer_blocks():
    """XL up-block attention has depth 2: swapping its two transformer
    blocks (identical shapes — undetectable by element counts) must fail
    the 35 dB gate."""
    model, params, sd = _unet_fixture(TINY_XL)
    bad = dict(sd)
    prefix_a = "up_blocks.0.attentions.0.transformer_blocks.0."
    prefix_b = "up_blocks.0.attentions.0.transformer_blocks.1."
    for k in list(sd):
        if k.startswith(prefix_a):
            bad[prefix_b + k[len(prefix_a):]] = sd[k]
        elif k.startswith(prefix_b):
            bad[prefix_a + k[len(prefix_b):]] = sd[k]
    ported_bad = port_unet(bad, TINY_XL)
    with pytest.raises(AssertionError, match="dB below"):
        verify.torch_parity_unet(sd, model, ported_bad, text_embed_dim=32)


def test_vae_full_model_gates():
    cfg = VAEConfig(block_out_channels=(8, 16, 16), layers_per_block=1,
                    norm_num_groups=4)
    dec = VAEDecoder(cfg)
    dp = randomize_params(jax.jit(dec.init)(
        jax.random.key(0), jnp.zeros((1, 8, 8, 4)))["params"], 11, scale=0.1)
    enc = VAEEncoder(cfg)
    ep = randomize_params(jax.jit(enc.init)(
        jax.random.key(1), jnp.zeros((1, 32, 32, 3)))["params"], 12, scale=0.1)
    sd = {**flax_params_to_diffusers_sd(dp, "vae_decoder"),
          **flax_params_to_diffusers_sd(ep, "vae_encoder")}
    # inverse-mapping sanity through the real ports
    dp2 = port_vae_decoder(sd, cfg)
    ep2 = port_vae_encoder(sd, cfg)
    for a, b in ((dp, dp2), (ep, ep2)):
        for (pa, va), (_, vb) in zip(
                jax.tree_util.tree_leaves_with_path(a),
                jax.tree_util.tree_leaves_with_path(b)):
            np.testing.assert_array_equal(np.asarray(va), vb,
                                          err_msg=jax.tree_util.keystr(pa))
    assert verify.torch_parity_vae_decoder(sd, dec, dp2, hw=8) >= 35.0
    assert verify.torch_parity_vae_encoder(sd, enc, ep2, hw=32) >= 35.0

    # mis-wire: swap the decoder mid-block resnets (same shapes)
    bad = dict(sd)
    for k in list(sd):
        if k.startswith("decoder.mid_block.resnets.0."):
            bad["decoder.mid_block.resnets.1." + k[28:]] = sd[k]
        elif k.startswith("decoder.mid_block.resnets.1."):
            bad["decoder.mid_block.resnets.0." + k[28:]] = sd[k]
    with pytest.raises(AssertionError, match="dB below"):
        verify.torch_parity_vae_decoder(sd, dec, port_vae_decoder(bad, cfg),
                                        hw=8)


def test_controlnet_full_model_gate():
    cfg = TINY_SD
    model = ControlNetModel(cfg)
    params = jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, cfg.cross_attention_dim)),
        jnp.zeros((1, 128, 128, 3)))["params"]
    params = randomize_params(params, 21, scale=0.1)
    sd = flax_params_to_diffusers_sd(params, "controlnet")
    ported = port_controlnet(sd, cfg)
    for (pa, va), (_, vb) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(ported)):
        np.testing.assert_array_equal(np.asarray(va), vb,
                                      err_msg=jax.tree_util.keystr(pa))
    assert verify.torch_parity_controlnet(sd, model, ported) >= 35.0


MM_CFG = MMDiTConfig(patch_size=2, in_channels=16, out_channels=16, depth=3,
                     hidden_size=32, num_heads=4, context_dim=64,
                     pooled_dim=40, pos_embed_max_size=16)


@pytest.mark.parametrize("qk_norm", [False, True], ids=["sd3", "sd35"])
def test_mmdit_full_model_gate(qk_norm):
    cfg = dataclasses.replace(MM_CFG, qk_norm=qk_norm)
    model = MMDiT(cfg)
    params = jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, 16, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 10, 64)), jnp.zeros((1, 40)))["params"]
    params = randomize_params(params, 31)
    sd = mmdit_params_to_diffusers_sd(params)
    ported = port_mmdit(sd, cfg)
    for (pa, va), (_, vb) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(ported)):
        np.testing.assert_array_equal(np.asarray(va), vb,
                                      err_msg=jax.tree_util.keystr(pa))
    assert verify.torch_parity_mmdit(sd, model, ported) >= 35.0


def test_mmdit_gate_trips_on_swapped_blocks():
    model = MMDiT(MM_CFG)
    params = jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, 16, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 10, 64)), jnp.zeros((1, 40)))["params"]
    params = randomize_params(params, 32)
    sd = mmdit_params_to_diffusers_sd(params)
    bad = dict(sd)
    for k in list(sd):  # swap blocks 0 and 1 (identical shapes)
        if k.startswith("transformer_blocks.0."):
            bad["transformer_blocks.1." + k[21:]] = sd[k]
        elif k.startswith("transformer_blocks.1."):
            bad["transformer_blocks.0." + k[21:]] = sd[k]
    with pytest.raises(AssertionError, match="dB below"):
        verify.torch_parity_mmdit(sd, model, port_mmdit(bad, MM_CFG))


def test_sd3_controlnet_full_model_gate():
    cn_cfg = SD3ControlNetConfig(mmdit=MM_CFG, num_layers=2)
    model = SD3ControlNetModel(cn_cfg)
    params = jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, 16, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 10, 64)), jnp.zeros((1, 40)),
        jnp.zeros((1, 16, 16, 16)))["params"]
    params = randomize_params(params, 41)
    sd = mmdit_params_to_diffusers_sd(params)
    ported = port_sd3_controlnet(sd, cn_cfg)
    for (pa, va), (_, vb) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(ported)):
        np.testing.assert_array_equal(np.asarray(va), vb,
                                      err_msg=jax.tree_util.keystr(pa))
    assert verify.torch_parity_sd3_controlnet(sd, model, ported) >= 35.0
