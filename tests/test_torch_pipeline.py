"""The port's txt2img pipeline against the JAX pipeline, on the CPU.

A tiny generation (3 steps of DPM++ 2M, CFG on, rng="numpy") through both
``generate_images`` on the same weights: latents within atol 1e-3, uint8
images within 1.  Also: importing the port pulls in no JAX, and features not
ported yet raise.
"""

import subprocess
import sys

import numpy as np
import pytest

from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig

from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

from torch_helpers import pipelines

HW = (64, 64)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return pipelines(tmp_path_factory.mktemp("tok"), weight_seed=11)


@pytest.mark.parametrize("case", [
    dict(prompt="a cat", negative_prompt="blurry", seed=93),
    dict(prompt=["a cat", "a dog"], seed=[5, 6], image_count=2, rng="nvidia"),
])
def test_generate_images_matches_jax(pair, case):
    jax_pipe, port_pipe = pair
    kw = dict(step_count=3, scheduler="DPMSolverMultistep", guidance_scale=7.5,
              disable_safety=True, rng="numpy")
    kw.update(case)
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW)
    n = kw.get("image_count", 1)
    assert got.latents.shape == (n, 8, 8, 4)
    assert got.images.shape == (n, 64, 64, 3) and got.images.dtype == np.uint8
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)
    ref_images = np.stack([np.asarray(im) for im in ref.images])
    diff = np.abs(got.images.astype(int) - ref_images.astype(int))
    assert diff.max() <= 1
    assert got.seconds_per_step > 0


def test_guidance_off_matches_jax(pair):
    jax_pipe, port_pipe = pair
    kw = dict(prompt="a cat", step_count=2, scheduler="DPMSolverMultistep",
              guidance_scale=1.0, seed=3, disable_safety=True, rng="torch")
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW)
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)


@pytest.mark.parametrize("kw,match", [
    (dict(scheduler="PNDM"), "scheduler"),
    (dict(starting_image=np.zeros((1, 64, 64, 3), np.float32)), "img2img"),
    (dict(prompt="a (cat:1.5)"), "prompt weight"),
    (dict(deepcache_interval=2), "DeepCache"),
    (dict(strength=0.5), "img2img strength"),
    (dict(refiner_start=0.5), "SDXL refiner"),
    (dict(crops_coords_top_left=(8, 8)), "micro-conditioning"),
    (dict(timestep_shift=1.0), "rectified-flow"),
    (dict(ip_adapter_scale=0.5), "IP-Adapter"),
])
def test_unported_features_raise(pair, kw, match):
    _, port_pipe = pair
    args = dict(prompt="a cat", step_count=2, scheduler="DPMSolverMultistep")
    args.update(kw)
    with pytest.raises(NotImplementedError, match=match):
        port_pipe.generate_images(PipelineConfiguration(**args), image_hw=HW)


def test_unported_fields_at_their_defaults_pass(pair):
    """Empty or default-valued unported fields, in any sequence type, are
    not a request for their feature."""
    _, port_pipe = pair
    cfg = PipelineConfiguration(prompt="a cat", step_count=1, scheduler="DPMSolverMultistep",
                                controlnet_inputs=[], crops_coords_top_left=[0, 0])
    assert port_pipe.generate_images(cfg, image_hw=HW).images.shape == (1, 64, 64, 3)


def test_rng_jax_is_rejected(pair):
    _, port_pipe = pair
    cfg = PipelineConfiguration(prompt="a cat", step_count=2,
                                scheduler="DPMSolverMultistep", rng="jax")
    with pytest.raises(ValueError, match="jax.random"):
        port_pipe.generate_images(cfg, image_hw=HW)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, pkgutil, importlib, ml_stable_diffusion_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'ml_dtypes', 'ml_stable_diffusion_tpu')]\n"
        "assert not bad, bad\n"
        "need = {'models.mmdit', 'pipelines.sd3', 'schedulers.flow', 'ops.flash_attention',\n"
        "        'pipelines.sdxl', 'ops.groupnorm', 'ops.palettized', 'compress.palettize',\n"
        "        'compress.mixed_bit', 'convert.artifacts', 'convert.native_io',\n"
        "        'convert.load', 'convert.report'}\n"
        "assert {p.__name__ + '.' + m for m in need} <= set(sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
