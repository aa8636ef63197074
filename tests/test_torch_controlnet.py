"""The port's ControlNet against the JAX package's, on the CPU in float32.

- ``ControlNetModel`` (the tiny SD one, and an SDXL ``text_time`` one) with
  seeded N(0, 0.2) weights loaded strictly through
  ``convert.from_jax.controlnet_state_dict``: every residual within 1e-5 of
  its peak; the full-size SD-1.5 and SDXL layouts load strictly.
- The UNet with ControlNet residuals, and the DeepCache shallow pass with
  them, against Flax.
- The SD pipeline with one and two nets (also with DeepCache and with
  serial CFG) and a 9-channel inpainting UNet with one, and the SDXL
  pipeline with an SDXL net, against the JAX pipelines: latents within
  atol 1e-3; each generation moved by its nets.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.models.controlnet import ControlNetModel as JaxControlNet
from ml_stable_diffusion_tpu.models.unet import UNet2DConditionModel as JaxUNet
from ml_stable_diffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig
from ml_stable_diffusion_tpu.pipelines.sdxl import StableDiffusionXLPipeline as JaxSDXL

from ml_stable_diffusion_torch.convert.from_jax import (
    clip_text_state_dict,
    controlnet_state_dict,
    unet_state_dict,
    vae_decoder_state_dict,
)
from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from ml_stable_diffusion_torch.models.controlnet import ControlNetModel
from ml_stable_diffusion_torch.models.unet import (
    FeedForward,
    ResnetBlock2D,
    UNet2DConditionModel,
    UNetConfig,
)
from ml_stable_diffusion_torch.ops.activations import gelu_erf
from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEDecoder
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration, StableDiffusionXLPipeline
from ml_stable_diffusion_torch.tokenizer import CLIPTokenizer

from helpers import CTX_DIM, randomize_params, tiny_tokenizer
from torch_helpers import (
    _load,
    pipelines,
    port_controlnet,
    tiny_text_encoder,
    tiny_unet,
    tiny_vae,
    traced,
)

HW = (64, 64)
XL_CTX = 2 * CTX_DIM
POOLED = 32


def _controlnet(seed, xl=False, cross_dim=CTX_DIM):
    """A tiny Flax ControlNet on the tiny UNet's config (SDXL: ``text_time``,
    no up blocks), seeded N(0, 0.2) weights."""
    cfg = traced(tiny_unet, cross_dim=cross_dim, xl=xl)[0].config
    if xl:
        cfg = dataclasses.replace(cfg, up_block_types=())
    model = JaxControlNet(cfg)
    kw = {}
    if xl:
        kw["added_cond"] = {"text_embeds": jnp.zeros((1, POOLED)), "time_ids": jnp.zeros((1, 6))}
    # the seeded weights replace the init's: its shapes are enough
    params = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                                                 jnp.zeros((1, 77, cross_dim)),
                                                 jnp.zeros((1, 64, 64, 3)), **kw),
                            jax.random.key(5))["params"]
    return model, randomize_params(params, seed)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def _close_to_peak(got, ref, rel=1e-5):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("xl", [False, True])
def test_controlnet_matches_flax(xl):
    cross = XL_CTX if xl else CTX_DIM
    model, params = _controlnet(61, xl, cross)
    port = port_controlnet(model, params)
    assert isinstance(port, ControlNetModel)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.asarray([981.0, 21.0], np.float32)
    ctx = rng.randn(2, 77, cross).astype(np.float32)
    cond = rng.rand(2, 64, 64, 3).astype(np.float32)
    added = None
    if xl:
        added = {"text_embeds": rng.randn(2, POOLED).astype(np.float32),
                 "time_ids": np.asarray([[1024, 1024, 0, 0, 1024, 1024],
                                         [512, 768, 16, 32, 1024, 896]], np.float32)}
    kw = {} if added is None else {"added_cond": {k: jnp.asarray(v) for k, v in added.items()}}
    ref_down, ref_mid = jax.jit(lambda p, *a: model.apply(
        {"params": p}, *a, conditioning_scale=0.7, **kw))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(cond))
    pkw = {} if added is None else {"added_cond": {k: torch.from_numpy(v)
                                                   for k, v in added.items()}}
    with torch.no_grad():
        down, mid = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                         torch.from_numpy(ctx), torch.from_numpy(cond).permute(0, 3, 1, 2),
                         0.7, **pkw)
    assert len(down) == len(ref_down) == 4
    for got, ref in zip(down, ref_down):
        assert got.dtype == torch.float32
        _close_to_peak(_nhwc(got), np.asarray(ref))
    _close_to_peak(_nhwc(mid), np.asarray(ref_mid))


@pytest.mark.parametrize("name,cond_dim,added", [("sd15", 768, None), ("sdxl", 2048, 6)])
def test_full_size_controlnet_layout_loads(name, cond_dim, added):
    """Every converted key of the full-size SD-1.5 (control_v11p_sd15_canny)
    and SDXL (controlnet-canny-sdxl-1.0) ControlNets exists in the port
    module with the converted shape, and nothing is missing."""
    cfg = getattr(JaxUNetConfig, name)()
    jm = JaxControlNet(cfg)
    kw = {}
    if added:
        kw["added_cond"] = {"text_embeds": jnp.zeros((1, 1280)),
                            "time_ids": jnp.zeros((1, added))}
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                                              jnp.zeros((1, 77, cond_dim)),
                                              jnp.zeros((1, 64, 64, 3)), **kw),
                            jax.random.key(0))["params"]
    layout = {}
    for path, s in jax.tree_util.tree_leaves_with_path(shapes):
        tree = np.zeros((1,) * len(s.shape), np.float32)
        for p in reversed(path):
            tree = {p.key: tree}
        (key,) = controlnet_state_dict(tree)
        shape = tuple(s.shape)
        if path[-1].key == "kernel":
            shape = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape[::-1]
        layout[key] = shape
    with torch.device("meta"):
        port = ControlNetModel(getattr(UNetConfig, name)())
    assert layout == {k: tuple(v.shape) for k, v in port.state_dict().items()}


def test_controlnet_groupnorm_is_plain_as_in_jax():
    """The JAX ControlNet builds its resnets without ``fused_gn`` and its
    transformers with the exact GELU, whatever the config says: so does
    the port's, next to a UNet that runs the GroupNorm kernel."""
    cfg = dataclasses.replace(UNetConfig.sdxl(), fused_groupnorm=True, fast_gelu=True)
    with torch.device("meta"):
        net, unet = ControlNetModel(cfg), UNet2DConditionModel(cfg)
    gn = {m.gn for m in net.modules() if isinstance(m, ResnetBlock2D)}
    assert gn == {"plain"}
    assert {m.gn for m in unet.modules() if isinstance(m, ResnetBlock2D)} == {"fused"}
    assert {m.gelu for m in net.modules() if isinstance(m, FeedForward)} == {gelu_erf}


@pytest.mark.parametrize("shallow", [False, True])
def test_unet_with_residuals_matches_flax(shallow):
    """Random residuals (float32, as a ControlNet gives them) into every skip
    and the mid block; on the DeepCache shallow pass the first skips take
    theirs and the mid residual is dropped."""
    model, params = traced(tiny_unet)
    params = randomize_params(params, 62)
    port = _load(UNet2DConditionModel, UNetConfig, model, params, unet_state_dict)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.asarray([500.0, 20.0], np.float32)
    ctx = rng.randn(2, 77, CTX_DIM).astype(np.float32)
    down = [rng.randn(2, *s).astype(np.float32)
            for s in ((8, 8, 16), (8, 8, 16), (4, 4, 16), (4, 4, 32))]
    mid = rng.randn(2, 4, 4, 32).astype(np.float32)
    feat = rng.randn(2, 8, 8, 32).astype(np.float32)  # up block 0's output
    kw = dict(down_block_residuals=[jnp.asarray(d) for d in down],
              mid_block_residual=jnp.asarray(mid))
    if shallow:
        kw["deep_feature"] = jnp.asarray(feat)
    ref = np.asarray(jax.jit(lambda p, *a, **k: model.apply({"params": p}, *a, **k))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), **kw))

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    pkw = dict(down_block_residuals=[nchw(d) for d in down], mid_block_residual=nchw(mid))
    if shallow:
        pkw["deep_feature"] = nchw(feat)
    with torch.no_grad():
        got = port(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), **pkw)
        plain = port(nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                     **({"deep_feature": nchw(feat)} if shallow else {}))
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-4, atol=1e-4)
    assert np.abs(_nhwc(got) - _nhwc(plain)).max() > 1e-3  # the residuals moved it


# -- the SD pipeline -----------------------------------------------------------

@pytest.fixture(scope="module")
def sd_pairs(tmp_path_factory):
    """{nets: (JAX pipeline, port pipeline)} with one and two tiny nets."""
    nets = [_controlnet(71), _controlnet(72)]
    return {n: pipelines(tmp_path_factory.mktemp(f"cn{n}"), weight_seed=70,
                         controlnets=nets[:n]) for n in (1, 2)}


def _cond(seed):
    return np.random.RandomState(seed).rand(1, 64, 64, 3).astype(np.float32)


@pytest.mark.parametrize("nets,kw", [
    (1, dict()),
    (2, dict()),
    (1, dict(deepcache_interval=2)),
    (1, dict(unet_batch_one=True)),
])
def test_sd_pipeline_with_controlnets_matches_jax(sd_pairs, nets, kw):
    jax_pipe, port_pipe = sd_pairs[nets]
    args = dict(prompt="a cat", negative_prompt="blurry", step_count=3,
                scheduler="DPMSolverMultistep", seed=9, disable_safety=True, rng="numpy",
                controlnet_inputs=[_cond(80 + i) for i in range(nets)], **kw)
    ref = jax_pipe.generate_images(JaxConfig(**args), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**args), image_hw=HW)
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)
    args["controlnet_inputs"] = []
    without = port_pipe.generate_images(PipelineConfiguration(**args), image_hw=HW)
    assert np.abs(got.latents - without.latents).max() > 1e-2


def test_controlnet_count_mismatch_raises_as_in_jax(sd_pairs):
    jax_pipe, port_pipe = sd_pairs[2]
    args = dict(prompt="a cat", step_count=2, rng="numpy", controlnet_inputs=[_cond(1)])
    with pytest.raises(ValueError, match="controlnet_inputs count") as ref:
        jax_pipe.generate_images(JaxConfig(**args), image_hw=HW)
    with pytest.raises(ValueError, match="controlnet_inputs count") as got:
        port_pipe.generate_images(PipelineConfiguration(**args), image_hw=HW)
    assert str(got.value) == str(ref.value)


def test_nine_channel_unet_with_controlnet_matches_jax(tmp_path):
    """A 9-channel inpainting UNet: the ControlNet sees the 4-channel
    latents."""
    model, _ = traced(tiny_unet)
    unet = JaxUNet(dataclasses.replace(model.config, in_channels=9))
    # pipelines() seeds every weight: the init's shapes are enough
    unet_p = jax.eval_shape(unet.init, jax.random.key(1), jnp.zeros((1, 8, 8, 9)),
                            jnp.zeros((1,)), jnp.zeros((1, 77, CTX_DIM)))["params"]
    jax_pipe, port_pipe = pipelines(tmp_path, weight_seed=73, unet=(unet, unet_p), encoder=True,
                                    controlnets=[_controlnet(74)])
    mask = np.zeros((64, 64), np.float32)
    mask[:, :32] = 1.0
    args = dict(prompt="a cat", step_count=3, scheduler="PNDM", seed=4, rng="numpy",
                disable_safety=True, starting_image=_cond(5) * 2 - 1, mask_image=mask,
                controlnet_inputs=[_cond(6)])
    ref = jax_pipe.generate_images(JaxConfig(**args), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**args), image_hw=HW)
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)


# -- the SDXL pipeline -----------------------------------------------------------

def test_sdxl_pipeline_with_controlnet_matches_jax(tmp_path):
    """The base UNet with an SDXL (text_time) net: the net takes the base
    phase's added conditioning; a weighted two-window prompt beside it."""
    tok1, tok2 = tmp_path / "l", tmp_path / "g"
    tok1.mkdir()
    tok2.mkdir()
    (te1, p1), (te2, p2) = traced(tiny_text_encoder), traced(tiny_text_encoder,
                                                             use_projection=True)
    unet, up = traced(tiny_unet, cross_dim=XL_CTX, xl=True)
    (dec, dp), _ = traced(tiny_vae)
    p1, p2, up, dp = (randomize_params(p, s) for p, s in ((p1, 81), (p2, 82), (up, 83), (dp, 84)))
    net = _controlnet(85, xl=True, cross_dim=XL_CTX)
    jax_pipe = JaxSDXL(tokenizer=tiny_tokenizer(tok1), tokenizer2=tiny_tokenizer(tok2),
                       text_encoder=(te1, p1), text_encoder2=(te2, p2), unet=(unet, up),
                       vae_decoder=(dec, dp), controlnets=[net])
    port_pipe = StableDiffusionXLPipeline(
        tokenizer=CLIPTokenizer.from_pretrained_dir(tok1),
        tokenizer2=CLIPTokenizer.from_pretrained_dir(tok2),
        text_encoder=_load(CLIPTextEncoder, CLIPTextConfig, te1, p1, clip_text_state_dict),
        text_encoder2=_load(CLIPTextEncoder, CLIPTextConfig, te2, p2, clip_text_state_dict),
        unet=_load(UNet2DConditionModel, UNetConfig, unet, up, unet_state_dict),
        vae_decoder=_load(VAEDecoder, VAEConfig, dec, dp, vae_decoder_state_dict),
        controlnets=[port_controlnet(*net)], device="cpu")
    args = dict(prompt="a (cat:1.3) " + "dog " * 40, negative_prompt="blurry", step_count=3,
                guidance_scale=5.0, seed=7, scheduler="DPMSolverMultistep", rng="numpy",
                disable_safety=True, refiner_start=1.0, controlnet_inputs=[_cond(86)])
    ref = jax_pipe.generate_images(JaxConfig(**args), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**args), image_hw=HW)
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)
    args["controlnet_inputs"] = []
    without = port_pipe.generate_images(PipelineConfiguration(**args), image_hw=HW)
    assert np.abs(got.latents - without.latents).max() > 1e-2
