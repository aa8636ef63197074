"""W8A8 serving through the port's pipelines (``enable_w8a8``) against
the JAX package's, on the CPU.

- tiny SD, SDXL and SD3 generations with ``enable_w8a8(min_size=1)``
  against the JAX pipelines' within atol 1e-3 (the pipeline tests'; an
  activation one rounding step away moves a layer's output by one scale
  step), the quantized layer sets equal after name translation;
- the caller's module untouched; staged W8A8 bit-equal to unstaged, the
  int8 buffers moving with the base UNet's stage; the W8A8 + DeepCache +
  batching serving preset (the JAX tests/test_serving.py:193).

The ops, names, calibration and recipe: tests/test_torch_w8a8.py.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import numpy as np
import pytest
import torch

from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig

from ml_stable_diffusion_torch.compress import w8a8
from ml_stable_diffusion_torch.ops import int8
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

from torch_helpers import (
    pipelines,
    port_sd_pipeline,
    port_sdxl_pipeline,
    sd3_pipelines,
    sdxl_pipelines,
)

HW = (64, 64)


def _gen_kw(**kw):
    args = dict(prompt="a cat", negative_prompt="blurry", step_count=3, seed=21,
                scheduler="DDIM", guidance_scale=6.0, disable_safety=True, rng="numpy")
    args.update(kw)
    return args


GENERATIONS = {
    "sd": (lambda tmp: pipelines(tmp, weight_seed=3), {}),
    "sdxl": (lambda tmp: sdxl_pipelines(tmp), {}),
    "sd3": (sd3_pipelines, dict(scheduler="DiscreteFlow")),
}


@pytest.mark.parametrize("family", list(GENERATIONS))
def test_w8a8_generation_matches_jax(family, tmp_path):
    build, kw = GENERATIONS[family]
    jax_pipe, port_pipe = build(tmp_path)
    jax_pipe.enable_w8a8(min_size=1)
    port_pipe.enable_w8a8(min_size=1)
    assert set(w8a8.jax_keys(port_pipe.int8_weights, port_pipe.unet)) == set(jax_pipe.int8_weights)
    ref = jax_pipe.generate_images(JaxConfig(**_gen_kw(**kw)), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**_gen_kw(**kw)), image_hw=HW)
    assert np.isfinite(got.latents).all()
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)


def test_enable_w8a8_leaves_the_callers_module(tmp_path):
    """The pipeline swaps layers on its own copy of the tree: the module
    handed in keeps every float layer and byte; the pipeline's holds int8
    buffers in their place, and its programs were dropped."""
    pipe = port_sd_pipeline(tmp_path)
    unet = pipe.unet
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    types = {k: type(m) for k, m in unet.named_modules()}
    pipe.generate_images(PipelineConfiguration(**_gen_kw()), image_hw=HW)
    pipe.enable_w8a8(min_size=1, include_convs=True)
    assert pipe.unet is not unet and len(pipe.programs) == 0
    assert {k: type(m) for k, m in unet.named_modules()} == types
    assert all(torch.equal(v, unet.state_dict()[k]) for k, v in before.items())
    served = dict(pipe.unet.named_modules())
    assert any(isinstance(served[k], int8.Int8Conv2d) for k in pipe.int8_weights)
    assert not any("to_out.0" in k or "upsamplers.0" in k for k in pipe.int8_weights)
    for k, (wq, _) in pipe.int8_weights.items():
        assert wq is served[k].weight_q and not hasattr(served[k], "weight")


def test_staged_w8a8_bit_equal_to_unstaged(tmp_path):
    """SDXL with its refiner, W8A8 on the base UNet: the staged generation
    with offloaded weights equals the default one bit for bit, and the int8
    buffers move with the base stage only."""
    pipe = port_sdxl_pipeline(tmp_path)
    pipe.enable_w8a8(min_size=1)
    cfg = _gen_kw(refiner_start=0.6)
    ref = pipe.generate_images(PipelineConfiguration(**cfg), image_hw=HW)
    pipe.offload_params_to_host()
    wq = next(iter(pipe.int8_weights.values()))[0]
    assert wq.device.type == "cpu"
    got = pipe.generate_images(PipelineConfiguration(**cfg, reduce_memory=True), image_hw=HW)
    np.testing.assert_array_equal(got.latents, ref.latents)
    stages = dict((n, b) for n, b, _ in pipe.stage_transfers)
    int8_bytes = sum(t.numel() * t.element_size() for m in pipe.unet.modules()
                     if isinstance(m, int8.Int8Linear) for t in m.buffers())
    assert stages["unet"] >= int8_bytes > 0
    assert not any(isinstance(m, int8.Int8Linear) for m in pipe.refiner_unet.modules())


def test_serving_preset_w8a8_deepcache_batching(tmp_path):
    """The JAX max-throughput preset (tests/test_serving.py:193): W8A8,
    DeepCache at interval 2 and four requests coalesced into one merged
    program, each finite and the batch equal to the pipeline's merged
    generation."""
    from ml_stable_diffusion_torch.serving import GenerationServer, ServeConfig

    pipe = port_sd_pipeline(tmp_path)
    pipe.enable_w8a8(min_size=1)
    sc = ServeConfig(image_hw=HW, step_count=4, scheduler="DDIM", deepcache_interval=2)
    server = GenerationServer(pipe, [sc], max_batch=4, batch_window_s=0.5)
    try:
        server.precompile(batch_sizes=(4,))
        cfgs = [PipelineConfiguration(prompt=p, seed=10 + i, step_count=4, scheduler="DDIM",
                                      deepcache_interval=2, disable_safety=True, rng="numpy")
                for i, p in enumerate(["a cat", "a dog", "a fox", "a bee"])]
        results = [f.result(timeout=300) for f in [server.submit(c, image_hw=HW) for c in cfgs]]
        assert server.batches_run == 1
        for r in results:
            assert np.isfinite(r.latents).all()
        merged = pipe.generate_images(dataclasses.replace(
            cfgs[0], prompt=[c.prompt for c in cfgs], seed=[c.seed for c in cfgs],
            negative_prompt=[c.negative_prompt for c in cfgs], image_count=4), image_hw=HW)
        np.testing.assert_array_equal(np.concatenate([r.latents for r in results]),
                                      merged.latents)
    finally:
        server.shutdown()
