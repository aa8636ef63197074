"""The staged path (``reduce_memory``) and ``offload_params_to_host``, on
the CPU.

The staged generation against the default one, bit for bit, for SD
(txt2img and img2img), SDXL with the refiner and SD3 with T5, with the
weights offloaded (each module packed into one host buffer, each tensor a
view of it) and without; against the JAX staged generation on tiny SD
within the pipeline tests' atol 1e-3; and each stage's module set against
the JAX ``_stage_bundle`` keys for SD and SDXL (as JAX
tests/test_pipeline_sd.py:155 and test_pipeline_sdxl.py:148 check them).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import copy

import numpy as np
import pytest

from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig

from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

from torch_helpers import (
    pipelines,
    port_sd3_pipeline,
    port_sd_pipeline,
    port_sdxl_pipeline,
    sdxl_pipelines,
)

HW = (64, 64)


def _kw(**kw):
    args = dict(prompt="a cat", negative_prompt="blurry", step_count=3, seed=21,
                scheduler="DPMSolverMultistep", guidance_scale=6.0, disable_safety=True,
                rng="numpy")
    args.update(kw)
    return args


CASES = {
    "sd": (port_sd_pipeline, {}),
    "sd-img2img": (port_sd_pipeline, dict(
        starting_image=np.random.default_rng(4).uniform(-1, 1, (1, *HW, 3)).astype(np.float32),
        strength=0.7)),
    "sdxl-refiner": (port_sdxl_pipeline, dict(refiner_start=0.6)),
    "sd3-t5": (port_sd3_pipeline, dict(scheduler="DiscreteFlow", prompt="a photo of the cat")),
}


@pytest.mark.parametrize("offload", [True, False], ids=["offloaded", "in-place"])
@pytest.mark.parametrize("case", list(CASES))
def test_staged_generation_matches_default(case, offload, tmp_path):
    build, kw = CASES[case]
    pipe = build(tmp_path)
    cfg = PipelineConfiguration(**_kw(**kw))
    ref = pipe.generate_images(cfg, image_hw=HW)
    if offload:
        pipe.offload_params_to_host()
        w = next(pipe.unet.parameters())
        pack = pipe._host_weights[id(pipe.unet)]
        assert w.untyped_storage().data_ptr() == pack.flat.untyped_storage().data_ptr()
    got = pipe.generate_images(PipelineConfiguration(**_kw(**kw, reduce_memory=True)),
                               image_hw=HW)
    np.testing.assert_array_equal(got.latents, ref.latents)
    np.testing.assert_array_equal(got.images, ref.images)
    stages = [name for name, _, _ in pipe.stage_transfers]
    phases = [p for _, _, p in pipe._denoise_phases(cfg, 3 if case != "sd-img2img" else 2)]
    assert stages == (["encode", *phases, "decode"] if offload else [])
    if offload:
        # an offloaded pipeline without reduce_memory moves every module in
        np.testing.assert_array_equal(pipe.generate_images(cfg, image_hw=HW).latents,
                                      ref.latents)
        assert [name for name, _, _ in pipe.stage_transfers] == ["all", "decode"]
        assert len(pipe._programs) == 0


def test_staged_handler_stops_as_the_eager_loop(tmp_path):
    """A progress handler under reduce_memory: the per-step loop inside the
    stages, stopped after step 2 as the eager loop stops."""
    pipe = port_sdxl_pipeline(tmp_path)
    pipe.offload_params_to_host()
    seen = {}

    def handler(tag):
        def fn(progress):
            seen.setdefault(tag, []).append(progress.step)
            return progress.step < 2
        return fn

    kw = _kw(step_count=4, refiner_start=0.25)
    got = pipe.generate_images(PipelineConfiguration(**kw, reduce_memory=True),
                               progress_handler=handler("staged"), image_hw=HW)
    ref = pipe.generate_images(PipelineConfiguration(**kw), progress_handler=handler("eager"),
                               image_hw=HW)
    assert seen["staged"] == seen["eager"] == [1, 2]
    np.testing.assert_array_equal(got.latents, ref.latents)


@pytest.fixture(scope="module")
def sd_pair(tmp_path_factory):
    return pipelines(tmp_path_factory.mktemp("tok"), weight_seed=61, encoder=True)


def test_staged_generation_matches_jax_staged(sd_pair):
    jax_pipe, port_pipe = (copy.copy(p) for p in sd_pair)
    jax_pipe._programs = {}
    jax_pipe.offload_params_to_host()
    port_pipe.offload_params_to_host()
    kw = _kw(reduce_memory=True)
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW)
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)


def _keys_and_modules(port, jax, stage, **kw):
    got = port._stage_bundle(stage, **kw)
    assert set(got) == set(jax._stage_bundle(stage, **kw)), stage
    return got


def test_stage_bundles_are_the_jax_ones(sd_pair, tmp_path):
    jax_pipe, port_pipe = sd_pair
    enc = _keys_and_modules(port_pipe, jax_pipe, "encode")
    assert enc == {"text_encoder": [port_pipe.text_encoder]}
    assert _keys_and_modules(port_pipe, jax_pipe, "encode", img2img=True)["vae_encoder"] == \
        [port_pipe.vae_encoder]
    den = _keys_and_modules(port_pipe, jax_pipe, "unet")
    assert den == {"unet": [port_pipe.unet], "controlnets": []}
    jax_xl, port_xl = sdxl_pipelines(tmp_path, refiner=True)
    assert _keys_and_modules(port_xl, jax_xl, "encode") == {
        "text_encoder": [port_xl.text_encoder], "text_encoder2": [port_xl.text_encoder2]}
    assert _keys_and_modules(port_xl, jax_xl, "unet")["unet"] == [port_xl.unet]
    ref = _keys_and_modules(port_xl, jax_xl, "refiner")
    assert ref == {"refiner": [port_xl.refiner_unet], "controlnets": []}


@pytest.mark.parametrize("offload", [True, False], ids=["offloaded", "in-place"])
def test_staged_palettized_program_mode_matches_unstaged(offload, tmp_path):
    """SDXL with its refiner, the base UNet, the refiner and CLIP-G served
    palettized in program mode: each stage gathers only its own modules'
    palettized weights (the JAX stage bundle's ``palettized`` side), and the
    staged latents equal the unstaged program mode's bit for bit; between
    calls the parameters are empty again, and offloaded indices wait in host
    memory."""
    import torch

    from ml_stable_diffusion_torch.compress.palettize import palettize_tree

    pipe = port_sdxl_pipeline(tmp_path)
    for key, module in (("unet", pipe.unet), ("refiner", pipe.refiner_unet),
                        ("text_encoder2", pipe.text_encoder2)):
        tree, _ = palettize_tree(module, 4, min_size=256)
        pipe.install_palettized(key, tree, dtype=torch.float32, mode="program")
    kw = _kw(refiner_start=0.6)
    ref = pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW)
    gathered = []
    real = pipe._materialize_palettized

    def spy(modules=None):
        gathered.append({m for m, _, _ in pipe._palettized_modules(modules)})
        return real(modules)

    if offload:
        pipe.offload_params_to_host()
        pal = next(iter(pipe.palettized_side["unet"][0].values()))
        assert pal.indices.device.type == "cpu"
    pipe._materialize_palettized = spy
    got = pipe.generate_images(PipelineConfiguration(**kw, reduce_memory=True), image_hw=HW)
    np.testing.assert_array_equal(got.latents, ref.latents)
    np.testing.assert_array_equal(got.images, ref.images)
    stage_sets = [s for s in gathered if s]
    assert stage_sets == [{pipe.text_encoder2}, {pipe.unet}, {pipe.refiner_unet}]
    key = next(iter(pipe.palettized_side["unet"][0]))
    assert pipe.unet.get_parameter(key).numel() == 0
