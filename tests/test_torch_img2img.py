"""The port's SD pipeline against the JAX pipeline beyond DPM++ txt2img, on
the CPU: every scheduler, img2img, inpainting (legacy 4-channel and a
9-channel UNet), LCM with a guidance-embedded UNet, a list of seeds with a
stochastic scheduler, and the SD-1.5 head layout.

Tiny models of tests/helpers.py with seeded N(0, 0.2) weights, the same
inputs and ``rng="numpy"`` (the port rejects "jax"): latents within atol
1e-3 and uint8 images within 1, as tests/test_torch_pipeline.py holds
txt2img.  The ``pndm_img2img`` golden was drawn with the JAX RNG, so img2img
is compared live.  Also the VAE encoder against the Flax encoder (moments
within atol 1e-4), ``sample_diagonal_gaussian`` (the same clamp; within
rtol 1e-6, since XLA's and PyTorch's float32 ``exp`` differ by one ulp on
about a tenth of inputs), and the JAX pipeline's ValueErrors.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.models.unet import UNet2DConditionModel as JaxUNet
from ml_stable_diffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from ml_stable_diffusion_tpu.models.vae import sample_diagonal_gaussian as jax_sample
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig

from ml_stable_diffusion_torch.models.unet import UNetConfig
from ml_stable_diffusion_torch.models.vae import sample_diagonal_gaussian
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration
from ml_stable_diffusion_torch.schedulers import SCHEDULER_MAP

from helpers import CTX_DIM
from torch_helpers import pipelines, tiny_unet, traced

HW = (64, 64)
SEED = 21


def _image(seed=0, n=1):
    return np.random.RandomState(seed).uniform(-1, 1, (n, *HW, 3)).astype(np.float32)


#: the left half repainted, with a soft seam two pixels wide
_MASK = np.zeros(HW, np.float32)
_MASK[:, :31] = 1.0
_MASK[:, 31:33] = 0.5


def _unet(in_channels=4, heads=(2, 2), channels=(16, 32), time_cond_proj_dim=None):
    """A tiny Flax SD UNet with these settings and its params' shapes
    (``pipelines`` seeds every weight)."""
    if time_cond_proj_dim:
        return traced(tiny_unet, time_cond_proj_dim=time_cond_proj_dim)
    model, _ = traced(tiny_unet)
    cfg = dataclasses.replace(model.config, in_channels=in_channels,
                              num_attention_heads=heads, block_out_channels=channels)
    model = JaxUNet(cfg)
    params = jax.eval_shape(model.init, jax.random.key(1), jnp.zeros((1, 8, 8, in_channels)),
                            jnp.zeros((1,)), jnp.zeros((1, 77, CTX_DIM)))["params"]
    return model, params


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return pipelines(tmp_path_factory.mktemp("tok"), weight_seed=SEED, encoder=True)


def _compare(jax_pipe, port_pipe, **kw):
    args = dict(prompt="a cat", negative_prompt="blurry", step_count=2, seed=5,
                guidance_scale=7.5, disable_safety=True, rng="numpy")
    args.update(kw)
    ref = jax_pipe.generate_images(JaxConfig(**args), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**args), image_hw=HW)
    n = args.get("image_count", 1)
    assert got.latents.shape == (n, 8, 8, 4) and np.isfinite(got.latents).all()
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)
    ref_images = np.stack([np.asarray(im) for im in ref.images])
    assert np.abs(got.images.astype(int) - ref_images.astype(int)).max() <= 1
    return got


@pytest.mark.parametrize("scheduler", sorted(SCHEDULER_MAP))
def test_txt2img_every_scheduler_matches_jax(pair, scheduler):
    _compare(*pair, scheduler=scheduler)


@pytest.mark.parametrize("case", [
    # the pndm_img2img golden's case: PNDM, strength 0.5
    dict(scheduler="PNDM", strength=0.5, step_count=4),
    dict(scheduler="EulerAncestral", strength=0.75, step_count=4, rng="torch",
         encoder_scale_factor=0.2),
])
def test_img2img_matches_jax(pair, case):
    _compare(*pair, starting_image=_image(), **case)


def test_img2img_from_a_pil_image_matches_jax(pair):
    from PIL import Image

    pixels = ((_image(1)[0] + 1) * 127.5).round().astype(np.uint8)
    _compare(*pair, starting_image=Image.fromarray(pixels), strength=0.5,
             scheduler="PNDM", step_count=4)


@pytest.mark.parametrize("scheduler", ["PNDM", "LMS"])
def test_legacy_inpainting_matches_jax(pair, scheduler):
    got = _compare(*pair, starting_image=_image(2), mask_image=_MASK, strength=0.75,
                   step_count=4, scheduler=scheduler)
    assert got.images.shape == (1, *HW, 3)


def test_list_of_seeds_with_euler_ancestral_matches_jax(pair):
    """Each image's initial and per-step noise from its own seed's stream."""
    _compare(*pair, prompt=["a cat", "a dog"], seed=[5, 6], image_count=2,
             scheduler="EulerAncestral", step_count=3, rng="nvidia")


@pytest.fixture(scope="module")
def unet9_pair(tmp_path_factory):
    return pipelines(tmp_path_factory.mktemp("tok9"), weight_seed=SEED + 10,
                     unet=_unet(in_channels=9), encoder=True)


def test_nine_channel_inpainting_matches_jax(unet9_pair):
    _compare(*unet9_pair, starting_image=_image(4), mask_image=_MASK[None, :, :, None],
             step_count=3, scheduler="PNDM")


def test_lcm_with_guidance_embedded_unet_matches_jax(tmp_path):
    """A guidance-embedded UNet runs without CFG, w = guidance - 1 its
    input, and a list of seeds gives each image its own per-step noise."""
    jax_pipe, port_pipe = pipelines(tmp_path, weight_seed=SEED + 20,
                                    unet=_unet(time_cond_proj_dim=16))
    assert port_pipe.unet.time_embedding.cond_proj.weight.shape == (16, 16)
    _compare(jax_pipe, port_pipe, scheduler="LCM", step_count=4, guidance_scale=7.5,
             seed=[8, 9], image_count=2, prompt=["a cat", "a dog"])


def test_sd15_head_layout_matches_jax(tmp_path):
    """Eight heads in every block, the head width growing with the block."""
    jax_pipe, port_pipe = pipelines(tmp_path, weight_seed=SEED + 30,
                                    unet=_unet(heads=(8, 8)))
    assert port_pipe.unet.config.num_attention_heads == (8, 8)
    _compare(jax_pipe, port_pipe, step_count=2)


def test_sd15_config_is_the_jax_one():
    assert dataclasses.asdict(UNetConfig.sd15()) == dataclasses.asdict(JaxUNetConfig.sd15())


@pytest.mark.parametrize("which,kw,match", [
    ("pair", dict(mask_image=_MASK), "mask_image requires starting_image"),
    ("unet9", dict(), "9-channel inpainting UNet"),
    ("unet9", dict(starting_image=_image()), "9-channel inpainting UNet"),
])
def test_value_errors_as_in_jax(pair, unet9_pair, which, kw, match):
    jax_pipe, port_pipe = pair if which == "pair" else unet9_pair
    args = dict(prompt="a cat", step_count=2, seed=1, rng="numpy", **kw)
    with pytest.raises(ValueError, match=match):
        jax_pipe.generate_images(JaxConfig(**args), image_hw=HW)
    with pytest.raises(ValueError, match=match):
        port_pipe.generate_images(PipelineConfiguration(**args), image_hw=HW)


def test_img2img_without_an_encoder_raises(pair):
    port_pipe = copy.copy(pair[1])
    port_pipe.vae_encoder = None
    cfg = PipelineConfiguration(prompt="a cat", step_count=2, starting_image=_image())
    with pytest.raises(ValueError, match="vae_encoder"):
        port_pipe.generate_images(cfg, image_hw=HW)


def test_vae_encoder_matches_flax(pair):
    jax_pipe, port_pipe = pair
    x = _image(5, n=2)
    ref = np.asarray(jax_pipe.vae_encoder.apply({"params": jax_pipe.vae_encoder_params},
                                                jnp.asarray(x)))
    with torch.no_grad():
        got = port_pipe.vae_encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-4)


def test_sample_diagonal_gaussian_matches_jax():
    rng = np.random.RandomState(6)
    moments = (rng.randn(2, 8, 8, 8) * 20).astype(np.float32)  # clamps both ends
    noise = rng.randn(2, 8, 8, 4).astype(np.float32)
    ref = np.asarray(jax_sample(jnp.asarray(moments), jnp.asarray(noise)))
    got = sample_diagonal_gaussian(torch.from_numpy(moments).permute(0, 3, 1, 2),
                                   torch.from_numpy(noise).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-6, atol=0)


def test_img2img_at_strength_one_matches_jax(pair):
    """Strength 1 keeps the whole plan, but z0 still enters through
    ``add_noise`` at the first step: not txt2img."""
    got = _compare(*pair, starting_image=_image(6), strength=1.0, step_count=3,
                   scheduler="DDIM")
    txt = pair[1].generate_images(PipelineConfiguration(
        prompt="a cat", negative_prompt="blurry", step_count=3, seed=5, scheduler="DDIM"),
        image_hw=HW)
    assert not np.allclose(got.latents, txt.latents)
