"""One program per generation (pipelines/program.py), on the CPU.

Here a program's body runs uncaptured on its static buffers, so these tests
hold what the card's graphs rest on: the body gives the eager loop's
latents bit for bit; the key is the JAX key field for field, and any field
or input shape that the body bakes gets a program of its own; the body asks
the host for no value; and the cache is emptied wherever weights are
rebound, while an in-place LoRA merge reaches a cached program.  The
pipelines are the port's own tiny modules (no JAX compile); only the key
test reads the JAX source.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import ast
import copy
import inspect
import textwrap

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ml_stable_diffusion_tpu.pipelines.sd import StableDiffusionPipeline as JaxPipeline

from ml_stable_diffusion_torch.convert.lora import LoRAAdapter, LoRAModule
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration
from ml_stable_diffusion_torch.pipelines.program import JAX_KEY_FIELDS, jax_key

from torch_helpers import port_sd3_pipeline, port_sd_pipeline, port_sdxl_pipeline

HW = (64, 64)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    from test_torch_ip_adapter import VISION, _adapter

    from ml_stable_diffusion_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder

    out = {"sd": port_sd_pipeline(tmp_path_factory.mktemp("sd"), seed=5, controlnets=1),
           "ip": port_sd_pipeline(tmp_path_factory.mktemp("ip"), seed=15, encoder=False),
           "sdxl": port_sdxl_pipeline(tmp_path_factory.mktemp("xl"), seed=25),
           "sd3": port_sd3_pipeline(tmp_path_factory.mktemp("sd3"), seed=35)}
    vision = CLIPVisionEncoder(CLIPVisionConfig(**VISION)).eval()
    out["ip"].load_ip_adapter(_adapter("base", out["ip"].unet.config, 3), vision)
    return out


def _image(seed, hw=HW):
    return np.random.default_rng(seed).uniform(-1, 1, (1, *hw, 3)).astype(np.float32)


def _cfg(**kw):
    args = dict(prompt="a cat", negative_prompt="blurry", step_count=3, seed=11,
                scheduler="DPMSolverMultistep", guidance_scale=6.0, disable_safety=True,
                rng="numpy")
    args.update(kw)
    return PipelineConfiguration(**args)


def _left_mask():
    m = np.zeros((*HW, 1), np.float32)
    m[:, : HW[1] // 2] = 1.0
    return m


CASES = {
    "sd-dpm": ("sd", {}),
    "sd-pndm": ("sd", dict(scheduler="PNDM")),
    "sd-euler-a": ("sd", dict(scheduler="EulerAncestral")),
    "sd-img2img-inpaint": ("sd", dict(starting_image=_image(3), mask_image=_left_mask(),
                                      strength=0.75)),
    "sd-controlnet": ("sd", dict(controlnet_inputs=[(_image(4) > 0).astype(np.float32)])),
    "sd-deepcache": ("sd", dict(step_count=4, deepcache_interval=2)),
    "sd-serial-cfg": ("sd", dict(unet_batch_one=True)),
    "sd-ip-adapter": ("ip", dict(ip_adapter_image=np.random.default_rng(5).uniform(
        0, 1, (16, 16, 3)).astype(np.float32), ip_adapter_scale=0.7)),
    "sdxl-refiner": ("sdxl", dict(refiner_start=0.6)),
    "sd3-t5": ("sd3", dict(scheduler="DiscreteFlow", prompt="a photo of the cat")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_program_matches_eager_loop_bit_for_bit(pipes, case):
    """The program's body on its static buffers against the eager loop:
    the same latents and images, bit for bit; the program is built once and
    reused by a second request with another prompt and seed."""
    pipe = copy.copy(pipes[CASES[case][0]])
    cfg = _cfg(**CASES[case][1])
    pipe.execution = "eager"
    eager = pipe.generate_images(cfg, image_hw=HW)
    assert len(pipe._programs) == 0
    pipe.execution = "program"
    got = pipe.generate_images(cfg, image_hw=HW)
    np.testing.assert_array_equal(got.latents, eager.latents)
    np.testing.assert_array_equal(got.images, eager.images)
    assert len(pipe._programs) == 2  # the generation's and the decode's
    other = pipe.generate_images(_cfg(**{**CASES[case][1], "seed": 12, "prompt": "a dog"}),
                                 image_hw=HW)
    assert len(pipe._programs) == 2 and pipe._programs.built == 2
    assert np.abs(other.latents - got.latents).max() > 0


def test_key_fields_are_the_jax_key():
    """``JAX_KEY_FIELDS`` is the JAX generate_images key as its source
    spells it, and ``jax_key`` computes what those expressions compute."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(JaxPipeline.generate_images)))
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "key")
    fields = tuple(ast.unparse(e) for e in node.value.elts)
    assert fields == JAX_KEY_FIELDS
    cfg = _cfg(ip_adapter_scale=0.61234, timestep_spacing="trailing", deepcache_interval=2,
               use_denoised_intermediates=True, attention_implementation="plain")

    class Family:
        def _conditioning_cache_key(self, cfg):
            return ("sdxl-like", cfg.guidance_scale)

    ns = dict(cfg=cfg, N=3, h=8, w=16, guidance_on=True, n_ctrl=2, img2img=True,
              inpaint=False, ip_on=True, strength=0.456789, self=Family())
    want = tuple(eval(f, {"round": round}, ns) for f in fields)
    assert jax_key(cfg, 3, 8, 16, True, 2, True, False, True, 0.456789,
                   Family()._conditioning_cache_key(cfg)) == want


def test_each_key_field_and_window_count_gets_its_program(pipes):
    """Configurations that differ in a field the body bakes, or in an input
    shape (the prompt's 77-token windows, the batch), get programs of their
    own; the prompt and seed do not."""
    pipe = copy.copy(pipes["sd"])
    base = dict(step_count=3)
    pipe.generate_images(_cfg(**base), image_hw=HW)
    n = len(pipe._programs)
    pipe.generate_images(_cfg(**base, prompt="another cat", seed=3), image_hw=HW)
    assert len(pipe._programs) == n
    changes = [dict(scheduler="DDIM"), dict(step_count=4), dict(guidance_scale=1.0),
               dict(guidance_scale=4.0), dict(unet_batch_one=True),
               dict(timestep_spacing="trailing"), dict(timestep_shift=2.0),
               dict(use_denoised_intermediates=True), dict(deepcache_interval=2),
               dict(prompt="a " * 100),  # two windows
               dict(prompt="a (cat:1.3)"),  # prompt weights
               dict(starting_image=_image(7), strength=0.5),
               dict(starting_image=_image(7), strength=0.75),
               dict(starting_image=_image(7), strength=0.75, encoder_scale_factor=0.2),
               dict(starting_image=_image(7), strength=0.75, mask_image=_left_mask()),
               dict(controlnet_inputs=[np.ones((1, *HW, 3), np.float32)])]
    for change in changes:
        pipe.generate_images(_cfg(**{**base, **change}), image_hw=HW)
        assert len(pipe._programs) == n + 1, change
        n = len(pipe._programs)
    # a new decode program too: another latent shape, or attention forced
    # plain (the dispatch in effect is baked into the decode's graph)
    for other in (dict(image_count=2), dict(hw=(64, 128)),
                  dict(attention_implementation="plain")):
        hw = other.pop("hw", HW)
        pipe.generate_images(_cfg(**base, **other), image_hw=hw)
        assert len(pipe._programs) == n + 2, other
        n = len(pipe._programs)


class _NoHostReads(TorchDispatchMode):
    """Raise on any op that reads a tensor's value on the host (a device
    to host copy and a wait inside a captured program)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("the body read a tensor's value on the host")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["sd-img2img-inpaint", "sd-controlnet", "sd-ip-adapter",
                                  "sd-euler-a", "sdxl-refiner", "sd3-t5"])
def test_body_reads_no_value_on_the_host(pipes, case):
    pipe = pipes[CASES[case][0]]
    cfg = _cfg(**CASES[case][1])
    gen = pipe._plan_generation(cfg, HW, None)
    inputs = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
              for k, v in pipe._host_inputs(gen).items()}
    with torch.inference_mode(), _NoHostReads():
        latents = pipe._body(gen, inputs)
    assert latents.shape == (1, pipe.latent_channels, 8, 8)


def _ti_and_ip(pipe):
    from test_torch_ip_adapter import VISION, _adapter

    from ml_stable_diffusion_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder

    rows = np.random.default_rng(1).normal(size=(2, pipe.text_encoder.config.hidden_size))
    return [("load_textual_inversion", lambda: pipe.load_textual_inversion(
                rows.astype(np.float32), token="<cat-toy>")),
            ("load_ip_adapter", lambda: pipe.load_ip_adapter(
                _adapter("base", pipe.unet.config, 9),
                CLIPVisionEncoder(CLIPVisionConfig(**VISION)).eval())),
            ("install_palettized", lambda: pipe.install_palettized(
                "unet", {k: v.clone() for k, v in pipe.unet.state_dict().items()}))]


def test_cache_is_emptied_where_weights_are_rebound(tmp_path):
    pipe = port_sd_pipeline(tmp_path, seed=45, encoder=False)
    for name, rebind in _ti_and_ip(pipe):
        pipe.generate_images(_cfg(), image_hw=HW)
        assert len(pipe._programs) == 2
        rebind()
        assert len(pipe._programs) == 0, name
    # a module moved or replaced behind the pipeline's back: the next call
    # finds other addresses and builds anew
    ref = pipe.generate_images(_cfg(), image_hw=HW)
    prog = next(iter(pipe._programs.programs.values()))
    pipe.vae_decoder = copy.deepcopy(pipe.vae_decoder)
    got = pipe.generate_images(_cfg(), image_hw=HW)
    assert prog not in pipe._programs.programs.values()
    np.testing.assert_array_equal(got.images, ref.images)


def test_lora_merge_reaches_the_cached_program(tmp_path):
    """``apply_lora`` and ``clear_loras`` write the weights in place: the
    cached program gives the merged result, then the original one."""
    pipe = port_sd_pipeline(tmp_path, seed=55, encoder=False)
    rng = np.random.default_rng(2)
    path = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"
    adapter = LoRAAdapter({("unet", path): LoRAModule(
        rng.normal(size=(4, 16)).astype(np.float32),
        rng.normal(size=(16, 4)).astype(np.float32), 4.0)}, name="tiny")
    before = pipe.generate_images(_cfg(), image_hw=HW)
    prog = dict(pipe._programs.programs)
    pipe.apply_lora(adapter, scale=0.8)
    merged = pipe.generate_images(_cfg(), image_hw=HW)
    assert dict(pipe._programs.programs) == prog  # no program rebuilt
    pipe.execution = "eager"
    np.testing.assert_array_equal(merged.latents, pipe.generate_images(_cfg(),
                                                                       image_hw=HW).latents)
    assert np.abs(merged.latents - before.latents).max() > 1e-4
    pipe.execution = "program"
    pipe.clear_loras()
    np.testing.assert_array_equal(pipe.generate_images(_cfg(), image_hw=HW).latents,
                                  before.latents)
