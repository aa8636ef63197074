"""The port's safety checker against the JAX package's, on the CPU in
float32: the ViT tower's scores and flags on the tiny configuration of
tests/test_controlnet_safety.py (``TINY_SAFETY``) with seeded weights
loaded strictly through ``convert.from_jax.safety_checker_state_dict``
(scores within 1e-5); the device resize against PIL's (within one uint8
level); ``check_images`` and the pipeline's flags and blanking against the
JAX ones; the tower on the plain attention path whatever the dispatch
says; and ``load_pipeline_from_artifacts`` on a JAX-written bundle with a
safety checker and a ControlNet.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.convert.artifacts import save_module
from ml_stable_diffusion_tpu.convert.load import (
    load_pipeline_from_artifacts as jax_load_pipeline_from_artifacts,
)
from ml_stable_diffusion_tpu.models.controlnet import ControlNetModel as JaxControlNet
from ml_stable_diffusion_tpu.models.safety import SafetyChecker as JaxSafetyChecker
from ml_stable_diffusion_tpu.models.safety import SafetyCheckerConfig as JaxSafetyConfig
from ml_stable_diffusion_tpu.models.safety import check_images as jax_check_images
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig

from ml_stable_diffusion_torch.convert.load import load_pipeline_from_artifacts
from ml_stable_diffusion_torch.models.controlnet import ControlNetModel
from ml_stable_diffusion_torch.models.safety import SafetyChecker, check_images, resize_uint8
from ml_stable_diffusion_torch.ops import flash_attention as flash_module
from ml_stable_diffusion_torch.ops.attention import set_attention_implementation
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

from helpers import CTX_DIM, randomize_params, tiny_tokenizer
from torch_helpers import pipelines, port_safety_checker, tiny_unet, traced

HW = (64, 64)
TINY_SAFETY = JaxSafetyConfig(image_size=32, patch_size=8, hidden_size=32,
                              intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=2, projection_dim=16,
                              num_concepts=3, num_special_care=2)


def _checker(seed=101, thresholds=None):
    """The tiny Flax checker, seeded N(0, 0.2) weights; ``thresholds``
    overrides both threshold banks."""
    model = JaxSafetyChecker(TINY_SAFETY)
    # the seeded weights replace the init's: its shapes are enough
    params = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    params = dict(randomize_params(params, seed))
    if thresholds is not None:
        for key in ("concept_embeds_weights", "special_care_embeds_weights"):
            params[key] = jnp.full_like(params[key], thresholds)
    return model, params


def _images(n=2, size=64, seed=3):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("adjustment", [-0.3, 0.0, 0.3])
def test_safety_checker_matches_flax(adjustment):
    model, params = _checker()
    port = port_safety_checker(model, params)
    x = np.random.RandomState(1).rand(4, 32, 32, 3).astype(np.float32)
    ref = model.apply({"params": params}, jnp.asarray(x), adjustment=adjustment)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), adjustment)
    for key in ("concept_scores", "special_scores", "image_embeds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=0, atol=1e-5,
                                   err_msg=key)
    np.testing.assert_array_equal(got["has_nsfw"].numpy(), np.asarray(ref["has_nsfw"]))


@pytest.mark.parametrize("size,out", [(64, 32), (512, 224), (100, 224)])
def test_resize_matches_pil(size, out):
    """Uniform noise, the hardest input for the intermediate rounding: at
    most one uint8 level from PIL, on under 1 % of the values."""
    ims = _images(2, size, seed=size)
    want = np.stack([np.asarray(Image.fromarray(im).resize((out, out), Image.BICUBIC))
                     for im in ims]).astype(int)
    got = (resize_uint8(torch.from_numpy(ims), out) * 255).round().permute(0, 2, 3, 1)
    diff = np.abs(got.numpy().astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def _red_and_noise():
    """A checker with no special-care hits (their thresholds at 10) and
    concept thresholds raised halfway between the top scores of a red image
    and a noise image, and those images."""
    model, params = _checker()
    params["special_care_embeds_weights"] = jnp.full_like(params["special_care_embeds_weights"],
                                                          10.0)
    ims = _images()
    ims[0] = (255, 0, 0)
    with torch.no_grad():
        scores = port_safety_checker(model, params)(resize_uint8(torch.from_numpy(ims), 32))
    top = scores["concept_scores"].max(dim=1).values.numpy()
    assert abs(top[0] - top[1]) > 0.05  # far apart against the resize's one level
    params["concept_embeds_weights"] = params["concept_embeds_weights"] + float(top.mean())
    return model, params, ims


def test_check_images_flags_and_blanks_as_in_jax():
    model, params, ims = _red_and_noise()
    ref_images, ref_flags = jax_check_images(model, params, [Image.fromarray(im) for im in ims])
    got_images, got_flags = check_images(port_safety_checker(model, params), ims)
    assert got_flags == ref_flags and sorted(got_flags) == [False, True]
    np.testing.assert_array_equal(got_images, np.stack([np.asarray(im) for im in ref_images]))
    flags = np.asarray(got_flags)
    np.testing.assert_array_equal(got_images[flags], 0)
    np.testing.assert_array_equal(got_images[~flags], ims[~flags])


def test_check_images_applies_its_adjustment():
    """``check_images`` takes ``adjustment`` and, as the JAX function does,
    does not pass it to the model: the flags of both packages are the
    unadjusted ones, equal, where the model given the adjustment flags
    both images."""
    model, params, ims = _red_and_noise()
    pil = [Image.fromarray(im) for im in ims]
    batch = np.stack([np.asarray(im.resize((32, 32), Image.BICUBIC), np.float32) / 255.0
                      for im in pil])
    adjusted = [bool(f) for f in np.asarray(
        model.apply({"params": params}, jnp.asarray(batch), adjustment=1.0)["has_nsfw"])]
    assert adjusted == [True, True]
    want = jax_check_images(model, params, pil, adjustment=1.0)[1]
    assert sorted(want) == [False, True]
    assert check_images(port_safety_checker(model, params), ims, adjustment=1.0)[1] == want


def test_safety_checker_stays_on_the_plain_path(monkeypatch):
    """Its f32 D = 16 heads here (D = 64 at full size) never reach the
    flash kernel's entry, whatever the dispatch default."""
    model, params = _checker()
    port = port_safety_checker(model, params)

    def refuse(*args, **kwargs):
        raise AssertionError("the safety checker reached the flash path")

    monkeypatch.setattr(flash_module, "flash_attention", refuse)
    set_attention_implementation("flash")
    try:
        flags = check_images(port, _images())[1]
    finally:
        set_attention_implementation("auto")
    assert len(flags) == 2


@pytest.mark.parametrize("flagged", [False, True])
def test_pipeline_safety_checker_matches_jax(tmp_path, flagged):
    """Thresholds of -10 flag every image, +10 none; ``disable_safety``
    skips the checker."""
    jax_pipe, port_pipe = pipelines(tmp_path, weight_seed=102,
                                    safety_checker=_checker(103, -10.0 if flagged else 10.0))
    kw = dict(prompt="a cat", step_count=2, seed=4, rng="numpy", image_count=2,
              scheduler="DPMSolverMultistep")
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW)
    assert got.nsfw_flags == ref.nsfw_flags == [flagged, flagged]
    ref_images = np.stack([np.asarray(im) for im in ref.images])
    assert np.abs(got.images.astype(int) - ref_images.astype(int)).max() <= 1
    assert (got.images.max() == 0) == flagged
    off = port_pipe.generate_images(PipelineConfiguration(**kw, disable_safety=True),
                                    image_hw=HW)
    assert off.nsfw_flags == [False, False] and off.images.max() > 0


def test_load_pipeline_with_safety_checker_and_controlnet(tmp_path):
    """A JAX-written SD bundle with a safety checker and a ControlNet: the
    port's loader builds both, and generates the JAX loader's latents and
    flags."""
    (tmp_path / "src").mkdir()
    jax_pipe, _ = pipelines(tmp_path / "src", weight_seed=104)
    root = tmp_path / "bundle"
    root.mkdir()
    tiny_tokenizer(root)
    cn = JaxControlNet(traced(tiny_unet)[0].config)
    cn_params = randomize_params(jax.eval_shape(
        cn.init, jax.random.key(5), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, CTX_DIM)), jnp.zeros((1, 64, 64, 3)))["params"], 105)
    safety, safety_params = _checker(106)
    for name, model, params in (
            ("TextEncoder", jax_pipe.text_encoder, jax_pipe.text_encoder_params),
            ("Unet", jax_pipe.unet, jax_pipe.unet_params),
            ("VAEDecoder", jax_pipe.vae_decoder, jax_pipe.vae_decoder_params),
            ("SafetyChecker", safety, safety_params),
            ("ControlNet-canny", cn, cn_params)):
        save_module(root, params, model.config, name=name)
    (root / "bundle.json").write_text(json.dumps({"family": "StableDiffusionPipeline",
                                                  "controlnets": ["ControlNet-canny"]}))
    cond = np.random.RandomState(7).rand(1, 64, 64, 3).astype(np.float32)
    kw = dict(prompt="a cat", step_count=2, seed=5, rng="numpy", scheduler="DPMSolverMultistep",
              controlnet_inputs=[cond])
    want = jax_load_pipeline_from_artifacts(root, compute_dtype=jnp.float32)
    want = want.generate_images(JaxConfig(**kw), image_hw=HW)
    pipe = load_pipeline_from_artifacts(root, compute_dtype=torch.float32, device="cpu")
    assert isinstance(pipe.safety_checker, SafetyChecker)
    assert [type(net) for net in pipe.controlnets] == [ControlNetModel]
    got = pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW)
    np.testing.assert_allclose(got.latents, want.latents, atol=1e-3)
    assert got.nsfw_flags == want.nsfw_flags
