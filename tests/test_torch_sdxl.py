"""The port's SDXL pieces against the JAX package's, on the CPU in float32.

- The tiny SDXL UNet (tests/helpers.py ``tiny_unet(xl=True)``, text_time
  added conditioning) with seeded N(0, 0.2) weights, loaded strictly into
  the port under each GroupNorm setting (plain, ``fused_groupnorm``,
  ``lowmem_groupnorm``), against Flax under the same setting: rtol = atol =
  1e-4, as tests/test_torch_models.py.  The full-size SDXL base and refiner
  layouts load strictly (keys and shapes, from ``jax.eval_shape``).
- The tiny SDXL pipeline (CLIP-L and a projected CLIP-G, base and refiner
  UNets, the tiny VAE) against the JAX ``StableDiffusionXLPipeline``: 3 steps
  of DPM++ 2M with rng="numpy", with the refiner taking over at
  ``refiner_start=0.6`` and without a refiner: latents within atol 1e-3 and
  uint8 images within 1, as for the SD-2.1 and SD3 pipelines.
- force_zeros_for_empty_prompt, the time ids of both phases, the phase
  split, the features of ROADMAP item 12 through both phases, and the
  field that still raises.
- The SDXL branch of ``load_pipeline_from_artifacts``: a JAX-written bundle
  with both UNets palettized (8 bits) generates the JAX loader's latents
  (atol 1e-3, as above).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.models.unet import UNet2DConditionModel as JaxUNet
from ml_stable_diffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig
from ml_stable_diffusion_tpu.pipelines.sdxl import StableDiffusionXLPipeline as JaxSDXL

from ml_stable_diffusion_torch.convert.from_jax import (
    clip_text_state_dict,
    unet_state_dict,
    vae_decoder_state_dict,
)
from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from ml_stable_diffusion_torch.models.unet import (
    ResnetBlock2D,
    UNet2DConditionModel,
    UNetConfig,
)
from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEDecoder
from ml_stable_diffusion_torch.ops.groupnorm import group_norm_silu_cuda
from ml_stable_diffusion_torch.pipelines import (
    PipelineConfiguration,
    StableDiffusionXLPipeline,
)
from ml_stable_diffusion_torch.tokenizer import CLIPTokenizer

from helpers import CTX_DIM, randomize_params, tiny_tokenizer
from torch_helpers import _load, tiny_text_encoder, tiny_unet, tiny_vae, traced

HW = (64, 64)
XL_CTX = 2 * CTX_DIM  # CLIP-L and CLIP-G penultimate states
POOLED = 32  # the tiny CLIP-G's projection
TOL = dict(rtol=1e-4, atol=1e-4)
GN_FLAGS = {"plain": {}, "fused": {"fused_groupnorm": True},
            "lowmem": {"lowmem_groupnorm": True}}


def _tiny_refiner():
    """tests/test_pipeline_sdxl.py's refiner: 5 time ids, the CLIP-G context;
    its params' shapes (every caller seeds its own weights)."""
    model, _ = traced(tiny_unet, xl=True)
    cfg = dataclasses.replace(model.config, cross_attention_dim=CTX_DIM,
                              projection_class_embeddings_input_dim=POOLED + 5 * 8)
    model = JaxUNet(cfg)
    added = {"text_embeds": jnp.zeros((1, POOLED)), "time_ids": jnp.zeros((1, 5))}
    params = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                                                 jnp.zeros((1, 77, CTX_DIM)), added_cond=added),
                            jax.random.key(1))["params"]
    return model, params


@pytest.mark.parametrize("gn", list(GN_FLAGS))
def test_sdxl_unet_matches_flax(gn):
    model, params = traced(tiny_unet, cross_dim=XL_CTX, xl=True)
    params = randomize_params(params, seed=21)
    jax_model = JaxUNet(dataclasses.replace(model.config, **GN_FLAGS[gn]))
    port = _load(UNet2DConditionModel, UNetConfig, jax_model, params, unet_state_dict)
    assert port.config.fused_groupnorm == (gn == "fused")
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.asarray([981.0, 21.0], np.float32)
    ctx = rng.randn(2, 77, XL_CTX).astype(np.float32)
    added = {"text_embeds": rng.randn(2, POOLED).astype(np.float32),
             "time_ids": np.asarray([[1024, 1024, 0, 0, 1024, 1024],
                                     [512, 768, 16, 32, 1024, 896]], np.float32)}
    ref = np.asarray(jax.jit(jax_model.apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        added_cond={k: jnp.asarray(v) for k, v in added.items()}))
    # the GroupNorm kernel takes contiguous NCHW only: every resnet input is
    seen, resnets = [], [m for m in port.modules() if isinstance(m, ResnetBlock2D)]
    for m in resnets:
        m.register_forward_pre_hook(lambda mod, inp: seen.append(inp[0].is_contiguous()))
    before = group_norm_silu_cuda.launches
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(t),
                   torch.from_numpy(ctx), {k: torch.from_numpy(v) for k, v in added.items()})
    assert group_norm_silu_cuda.launches == before
    assert len(seen) == len(resnets) and all(seen)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, **TOL)


def test_sdxl_unet_needs_added_cond():
    model, _ = traced(tiny_unet, cross_dim=XL_CTX, xl=True)
    port = UNet2DConditionModel(UNetConfig(**dataclasses.asdict(model.config)))
    with pytest.raises(ValueError, match="added_cond"):
        port(torch.zeros(1, 4, 8, 8), torch.tensor(1.0), torch.zeros(1, 77, XL_CTX))


@pytest.mark.parametrize("name,n_ids,ctx", [("sdxl", 6, 2048), ("sdxl_refiner", 5, 1280)])
def test_full_size_sdxl_layout_loads(name, n_ids, ctx):
    """Every converted key of the full-size SDXL base / refiner exists in the
    port module with the converted shape, and nothing is missing: the
    add_embedding, the 10-deep (base) and 4-deep (refiner) transformer stacks,
    the DownBlock2D first blocks."""
    cfg = getattr(JaxUNetConfig, name)()
    added = {"text_embeds": jnp.zeros((1, 1280)), "time_ids": jnp.zeros((1, n_ids))}
    jm = JaxUNet(cfg)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                                              jnp.zeros((1, 77, ctx)), added_cond=added),
                            jax.random.key(0))["params"]
    layout = {}
    for path, s in jax.tree_util.tree_leaves_with_path(shapes):
        tree = np.zeros((1,) * len(s.shape), np.float32)
        for p in reversed(path):
            tree = {p.key: tree}
        (key,) = unet_state_dict(tree)
        shape = tuple(s.shape)
        if path[-1].key == "kernel":
            shape = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape[::-1]
        layout[key] = shape
    with torch.device("meta"):
        port = UNet2DConditionModel(getattr(UNetConfig, name)())
    assert layout == {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert dataclasses.asdict(port.config) == dataclasses.asdict(cfg)


# -- the pipeline ---------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tok1, tok2 = tmp_path_factory.mktemp("l"), tmp_path_factory.mktemp("g")
    (te1, p1), (te2, p2) = traced(tiny_text_encoder), traced(tiny_text_encoder,
                                                             use_projection=True)
    unet, up = traced(tiny_unet, cross_dim=XL_CTX, xl=True)
    ref_unet, rp = _tiny_refiner()
    (dec, dp), _ = traced(tiny_vae)
    p1, p2, up, rp, dp = (randomize_params(p, seed) for p, seed in
                          ((p1, 41), (p2, 42), (up, 43), (rp, 44), (dp, 45)))
    jax_pipe = JaxSDXL(tokenizer=tiny_tokenizer(tok1), tokenizer2=tiny_tokenizer(tok2),
                       text_encoder=(te1, p1), text_encoder2=(te2, p2), unet=(unet, up),
                       refiner_unet=(ref_unet, rp), vae_decoder=(dec, dp))
    modules = dict(
        tokenizer=CLIPTokenizer.from_pretrained_dir(tok1),
        tokenizer2=CLIPTokenizer.from_pretrained_dir(tok2),
        text_encoder=_load(CLIPTextEncoder, CLIPTextConfig, te1, p1, clip_text_state_dict),
        text_encoder2=_load(CLIPTextEncoder, CLIPTextConfig, te2, p2, clip_text_state_dict),
        unet=_load(UNet2DConditionModel, UNetConfig, unet, up, unet_state_dict),
        vae_decoder=_load(VAEDecoder, VAEConfig, dec, dp, vae_decoder_state_dict),
        device="cpu")
    refiner = _load(UNet2DConditionModel, UNetConfig, ref_unet, rp, unet_state_dict)
    port_pipes = {"base": StableDiffusionXLPipeline(**modules),
                  "refiner": StableDiffusionXLPipeline(**modules, refiner_unet=refiner)}
    return jax_pipe, port_pipes


def _kw(**kw):
    out = dict(prompt="a cat", negative_prompt="blurry", step_count=3, guidance_scale=5.0,
               seed=7, scheduler="DPMSolverMultistep", disable_safety=True, rng="numpy")
    out.update(kw)
    return out


@pytest.mark.parametrize("port_key,case", [
    # base 1 step, refiner 2 steps; the empty negative is zeroed
    ("refiner", dict(refiner_start=0.6, negative_prompt="")),
    # no refiner: the JAX pipeline's refiner_start=1.0 leaves it all to the base
    ("base", dict(refiner_start=1.0, original_size=(512, 768), crops_coords_top_left=(8, 16))),
])
def test_generate_images_matches_jax(pair, port_key, case):
    jax_pipe, port_pipes = pair
    kw = _kw(**case)
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW)
    if port_key == "base":
        kw.pop("refiner_start")
    got = port_pipes[port_key].generate_images(PipelineConfiguration(**kw), image_hw=HW)
    assert got.latents.shape == (1, 8, 8, 4) and np.isfinite(got.latents).all()
    assert got.images.shape == (1, 64, 64, 3) and got.images.dtype == np.uint8
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)
    ref_images = np.stack([np.asarray(im) for im in ref.images])
    assert np.abs(got.images.astype(int) - ref_images.astype(int)).max() <= 1


@pytest.mark.parametrize("negative", ["", "dog"])
def test_text_conditioning_matches_jax(pair, negative):
    """Context (2, 77, 96), the refiner's context2 (2, 77, 48) and the pooled
    vector; an empty negative zeroes the negative context and pooled rows but
    not context2, as the JAX pipeline does."""
    jax_pipe, port_pipes = pair
    kw = _kw(negative_prompt=negative)
    tokens = jax_pipe._tokenize(JaxConfig(**kw))
    ref = jax_pipe._encode_text(JaxConfig(**kw), {k: jnp.asarray(v) for k, v in tokens.items()},
                                jax_pipe._params_bundle())
    port = port_pipes["refiner"]
    got_tokens = port._tokenize(PipelineConfiguration(**kw))
    assert got_tokens["zero_negative"] == (negative == "")
    for key in ("ids", "ids2"):
        np.testing.assert_array_equal(got_tokens[key], tokens[key])
    with torch.no_grad():
        got = port._encode_text(got_tokens)
    shapes = {"context": (2, 77, XL_CTX), "context2": (2, 77, CTX_DIM), "pooled": (2, POOLED)}
    for key, shape in shapes.items():
        assert tuple(got[key].shape) == shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=1e-4,
                                   err_msg=key)
    zeroed = negative == ""
    assert (np.abs(got["context"][0].numpy()).max() == 0) == zeroed
    assert (np.abs(got["pooled"][0].numpy()).max() == 0) == zeroed
    assert np.abs(got["context2"][0].numpy()).max() > 0


@pytest.mark.parametrize("case", [
    dict(),
    dict(original_size=(512, 640), target_size=(768, 1024), crops_coords_top_left=(16, 32),
         aesthetic_score=6.5, negative_aesthetic_score=2.0, image_count=2),
])
def test_time_ids_match_jax(pair, case):
    jax_pipe, port_pipes = pair
    port = port_pipes["refiner"]
    kw = _kw(**case)
    N = kw.get("image_count", 1)
    jcfg, pcfg = JaxConfig(**kw), PipelineConfiguration(**kw)
    tokens = jax_pipe._tokenize(jcfg)
    jtext = jax_pipe._encode_text(jcfg, {k: jnp.asarray(v) for k, v in tokens.items()},
                                  jax_pipe._params_bundle())
    with torch.no_grad():
        ptext = port._encode_text(port._tokenize(pcfg))
    for phase, caller, n_ids in (("unet", jax_pipe._call_unet, 6),
                                 ("refiner", jax_pipe._call_refiner, 5)):
        ref = jax_pipe._phase_conditioning(jcfg, jtext, N, caller)
        got = port._phase_conditioning(pcfg, ptext, N, phase)
        for r, g in zip(ref[:2], got[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
        for r, g in zip(ref[2:], got[2:]):
            assert tuple(g["time_ids"].shape) == (N, n_ids)
            for key in ("time_ids", "text_embeds"):
                np.testing.assert_allclose(g[key].numpy(), np.asarray(r[key]), atol=1e-4)


@pytest.mark.parametrize("refiner_start,steps", [(0.8, 20), (0.6, 3), (0.1, 4), (0.0, 5),
                                                 (1.0, 5), (1.5, 4)])
def test_denoise_phases_match_jax(pair, refiner_start, steps):
    jax_pipe, port_pipes = pair
    kinds = {jax_pipe._call_unet: "unet", jax_pipe._call_refiner: "refiner"}
    cfg = _kw(refiner_start=refiner_start)
    ref = [(lo, hi, kinds[c]) for lo, hi, c in
           jax_pipe._denoise_phases(JaxConfig(**cfg), steps)]
    assert port_pipes["refiner"]._denoise_phases(PipelineConfiguration(**cfg), steps) == ref
    assert port_pipes["base"]._denoise_phases(PipelineConfiguration(**cfg), steps) == [
        (0, steps, "unet")]


@pytest.mark.parametrize("kw", [
    dict(prompt="a (cat:1.5) [sat]"),
    # the negative spans two windows of CLIP-L and of CLIP-G
    dict(negative_prompt="a " * 80),
    # four windows (360 tokens cut to 300), weighted
    dict(prompt="(" + "cat dog " * 60 + ":1.2)"),
    dict(use_denoised_intermediates=True),
    dict(deepcache_interval=2),
    dict(unet_batch_one=True),
])
def test_features_match_jax(pair, kw):
    """Base and refiner (4 + 1 of 5 steps): dual-encoder prompt weights and
    long prompts, denoised previews (a no-op without a handler), DeepCache
    (each phase restarts with a full pass) and serial CFG."""
    jax_pipe, port_pipes = pair
    args = _kw(step_count=5, refiner_start=0.8, **kw)
    ref = jax_pipe.generate_images(JaxConfig(**args), image_hw=HW)
    got = port_pipes["refiner"].generate_images(PipelineConfiguration(**args), image_hw=HW)
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)


def test_sdxl_pipeline_constants_are_the_jax_ones():
    assert StableDiffusionXLPipeline.default_latent_scale == JaxSDXL.default_latent_scale


def test_load_pipeline_from_jax_sdxl_bundle(pair, tmp_path):
    import json

    from ml_stable_diffusion_tpu.compress.palettize import palettize_tree
    from ml_stable_diffusion_tpu.convert.artifacts import save_module
    from ml_stable_diffusion_tpu.convert.load import (
        load_pipeline_from_artifacts as jax_load_pipeline_from_artifacts,
    )

    from ml_stable_diffusion_torch.convert.load import load_pipeline_from_artifacts

    jax_pipe, _ = pair
    tiny_tokenizer(tmp_path)
    (tmp_path / "tokenizer_2").mkdir()
    tiny_tokenizer(tmp_path / "tokenizer_2")
    # both loaders pad the second tokenizer with "!", as SDXL's CLIP-G does
    vocab = json.loads((tmp_path / "tokenizer_2" / "vocab.json").read_text())
    vocab["!"] = len(vocab)
    (tmp_path / "tokenizer_2" / "vocab.json").write_text(json.dumps(vocab))
    for name, model, params in (
            ("TextEncoder", jax_pipe.text_encoder, jax_pipe.text_encoder_params),
            ("TextEncoder2", jax_pipe.text_encoder2, jax_pipe.text_encoder2_params),
            ("Unet", jax_pipe.unet, palettize_tree(jax_pipe.unet_params, 8, min_size=128)[0]),
            ("RefinerUnet", jax_pipe.refiner_unet,
             palettize_tree(jax_pipe.refiner_unet_params, 8, min_size=128)[0]),
            ("VAEDecoder", jax_pipe.vae_decoder, jax_pipe.vae_decoder_params)):
        save_module(tmp_path, params, model.config, name=name)
    (tmp_path / "bundle.json").write_text(json.dumps({"family": "StableDiffusionXLPipeline"}))
    kw = _kw(refiner_start=0.6)
    want = jax_load_pipeline_from_artifacts(tmp_path, compute_dtype=jnp.float32)
    want = want.generate_images(JaxConfig(**kw), image_hw=HW).latents
    pipe = load_pipeline_from_artifacts(tmp_path, compute_dtype=torch.float32, device="cpu")
    assert isinstance(pipe, StableDiffusionXLPipeline) and pipe.refiner_unet is not None
    got = pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW).latents
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("case", [
    # strength 0.5 of 6 steps: 3 steps, the refiner taking the last of them
    dict(refiner_start=0.6, strength=0.5, step_count=6),
    # inpainting through both phases: the known region re-noised after each
    dict(refiner_start=0.5, strength=0.8, step_count=5, mask=True),
])
def test_img2img_with_refiner_matches_jax(pair, case):
    """img2img and inpainting through the inherited ``generate_images``: the
    base -> refiner cut splits the strength-sliced plan as the JAX
    ``_denoise_phases`` does."""
    import copy

    from torch_helpers import port_vae_encoder

    jax_pipe, port_pipes = pair
    _, (enc, ep) = traced(tiny_vae)
    ep = randomize_params(ep, 46)
    jax_pipe = copy.copy(jax_pipe)
    jax_pipe.vae_encoder, jax_pipe.vae_encoder_params = enc, ep
    port_pipe = copy.copy(port_pipes["refiner"])
    port_pipe.vae_encoder = port_vae_encoder(enc, ep)
    case = dict(case)
    extra = {}
    if case.pop("mask", False):
        mask = np.zeros((64, 64), np.float32)
        mask[16:48, 16:48] = 1.0
        extra["mask_image"] = mask
    image = np.random.RandomState(9).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    kw = _kw(starting_image=image, **case, **extra)
    steps = jax_pipe._make_scheduler(JaxConfig(**kw)).set_timesteps(
        kw["step_count"], strength=kw["strength"]).num_steps
    assert port_pipe._denoise_phases(PipelineConfiguration(**kw), steps) == [
        (lo, hi, "unet" if c == jax_pipe._call_unet else "refiner")
        for lo, hi, c in jax_pipe._denoise_phases(JaxConfig(**kw), steps)]
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW)
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)
    ref_images = np.stack([np.asarray(im) for im in ref.images])
    assert np.abs(got.images.astype(int) - ref_images.astype(int)).max() <= 1


def test_controlnet_runs_in_the_refiner_phase_as_in_jax(pair):
    """Both pipelines run their ControlNets in every phase with that phase's
    conditioning: a base SDXL net beside a refiner gets the refiner's 5 time
    ids (and its narrower context) and fails in both, at its added
    embedding."""
    import copy

    from ml_stable_diffusion_tpu.models.controlnet import ControlNetModel as JaxControlNet

    from torch_helpers import port_controlnet

    jax_pipe, port_pipes = pair
    cfg = dataclasses.replace(tiny_unet(cross_dim=XL_CTX, xl=True)[0].config, up_block_types=())
    net = JaxControlNet(cfg)
    added = {"text_embeds": jnp.zeros((1, POOLED)), "time_ids": jnp.zeros((1, 6))}
    params = jax.jit(lambda k: net.init(k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                                        jnp.zeros((1, 77, XL_CTX)), jnp.zeros((1, 64, 64, 3)),
                                        added_cond=added))(jax.random.key(5))["params"]
    jax_pipe, port_pipe = copy.copy(jax_pipe), copy.copy(port_pipes["refiner"])
    jax_pipe._programs = {}
    jax_pipe.controlnets = [(net, params)]
    port_pipe.controlnets = [port_controlnet(net, params)]
    kw = _kw(refiner_start=0.6, controlnet_inputs=[np.zeros((1, 64, 64, 3), np.float32)])
    with pytest.raises(Exception, match="add_embedding/linear_1"):
        jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW)
    with pytest.raises(RuntimeError, match="shapes cannot be multiplied .1x72 and 80x64."):
        port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW)
