"""Port models against the Flax modules, on the CPU in float32.

Each tiny JAX model from tests/helpers.py gets distinct weights
(``randomize_params``), which ``convert.from_jax`` carries into the port
module with ``load_state_dict(strict=True)``; the same numpy inputs go
through both.  Tolerance: rtol = atol = 1e-4.  The full-size SD-2.1 configs
are checked for layout only (keys and shapes, from ``jax.eval_shape``).
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
from ml_stable_diffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from ml_stable_diffusion_tpu.models.unet import UNet2DConditionModel as JaxUNet
from ml_stable_diffusion_tpu.models.unet import get_timestep_embedding as jax_temb
from ml_stable_diffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
from ml_stable_diffusion_tpu.models.vae import VAEDecoder as JaxVAEDecoder

from ml_stable_diffusion_torch.convert.from_jax import (
    clip_text_state_dict,
    unet_state_dict,
    vae_decoder_state_dict,
)
from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from ml_stable_diffusion_torch.models.unet import (
    UNet2DConditionModel,
    UNetConfig,
    get_timestep_embedding,
)
from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEDecoder

from helpers import randomize_params
from torch_helpers import tiny_text_encoder, tiny_unet, tiny_vae, traced

TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _port(cls, cfg_cls, jax_model):
    return cls(cfg_cls(**dataclasses.asdict(jax_model.config)))


def test_clip_text_encoder_matches_flax():
    model, params = traced(tiny_text_encoder)
    params = randomize_params(params, seed=5)
    port = _port(CLIPTextEncoder, CLIPTextConfig, model)
    port.load_state_dict(clip_text_state_dict(_np_tree(params)), strict=True)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 998, size=(2, 77)).astype(np.int32)
    ids[0, 9:] = 999  # EOS + padding
    ids[1, 40] = 999
    ref = jax.jit(model.apply)({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long())
    for key in ("last_hidden_state", "penultimate_hidden_state", "pooled_output"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("t", [[0.0, 999.0], [1.0, 501.0]])
def test_timestep_embedding_matches_flax(t):
    ref = jax_temb(jnp.asarray(t, jnp.float32), 320)
    got = get_timestep_embedding(torch.tensor(t), 320)
    # the sin/cos arguments reach 999 rad, where one float32 ulp is 6e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_unet_matches_flax():
    model, params = traced(tiny_unet)
    params = randomize_params(params, seed=6)
    port = _port(UNet2DConditionModel, UNetConfig, model)
    port.load_state_dict(unet_state_dict(_np_tree(params)), strict=True)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.asarray([981.0, 21.0], np.float32)
    ctx = rng.randn(2, 77, 48).astype(np.float32)
    ref = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x),
                                          jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                   torch.from_numpy(ctx)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_vae_decoder_matches_flax():
    (dec, params), _ = traced(tiny_vae)
    params = randomize_params(params, seed=7)
    port = _port(VAEDecoder, VAEConfig, dec)
    port.load_state_dict(vae_decoder_state_dict(_np_tree(params)), strict=True)
    z = np.random.RandomState(2).randn(1, 8, 8, 4).astype(np.float32)
    ref = np.asarray(jax.jit(dec.apply)({"params": params}, jnp.asarray(z)))
    with torch.no_grad():
        got = port(torch.from_numpy(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def _layout(jax_model, init_args, convert):
    """(key -> shape) of the converted state dict of the full-size model,
    from abstract shapes: kernels HWIO -> OIHW, dense kernels transposed."""
    shapes = jax.eval_shape(lambda k: jax_model.init(k, *init_args),
                            jax.random.key(0))["params"]
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(shapes):
        # convert a one-element stand-in of this leaf alone to learn its key
        tree = np.zeros((1,) * len(s.shape), np.float32)
        for p in reversed(path):
            tree = {p.key: tree}
        (key,) = convert(tree)
        shape = tuple(s.shape)
        if path[-1].key == "kernel":
            shape = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape[::-1]
        out[key] = shape
    return out


@pytest.mark.parametrize("kind", ["unet", "vae_decoder", "clip"])
def test_full_size_layout_loads(kind):
    """The SD-2.1 configs: every converted key exists in the port module
    with the converted shape, and nothing is missing (what a strict load
    checks), without materializing the weights."""
    if kind == "unet":
        jm = JaxUNet(JaxUNetConfig.sd21())
        args = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 1024)))
        layout = _layout(jm, args, unet_state_dict)
        with torch.device("meta"):
            port = UNet2DConditionModel(UNetConfig.sd21())
    elif kind == "vae_decoder":
        jm = JaxVAEDecoder(JaxVAEConfig.sd())
        layout = _layout(jm, (jnp.zeros((1, 8, 8, 4)),), vae_decoder_state_dict)
        with torch.device("meta"):
            port = VAEDecoder(VAEConfig.sd())
    else:
        jm = JaxCLIP(JaxCLIPConfig.sd2())
        layout = _layout(jm, (jnp.zeros((1, 77), jnp.int32),), clip_text_state_dict)
        with torch.device("meta"):
            port = CLIPTextEncoder(CLIPTextConfig.sd2())
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert layout == want
