"""The port's IP-Adapter against the JAX package's, on the CPU.

- ``cross_attention_paths`` equal to the JAX enumeration (down, up, mid
  last) for the SD-2.1, SD-1.5, SDXL and tiny configs; the h94 index check;
  the checkpoint formats (.safetensors, torch .bin, a dict) read alike;
  ``resampler_geometry`` equal to JAX's;
- the tiny ``CLIPVisionEncoder`` (through ``clip_vision_state_dict`` and
  through a transformers-layout directory), ``IPImageProjection`` and
  ``IPResampler`` against Flax in float32: atol 1e-5;
- the UNet with IP tokens against Flax (rtol = atol = 1e-4), and the
  identities of tests/test_ip_adapter.py: scale 0 gives the output without
  tokens bit for bit, zero tokens within 1e-6, tokens at scale 1 move it;
- tiny SD generations with a BASE and a PLUS adapter against the JAX
  pipeline (atol 1e-3 on the latents) over batched CFG, serial CFG, legacy
  inpainting, a ControlNet (which takes no tokens) and DeepCache, a PIL
  reference image among them;
- SDXL with a refiner: the tokens reach the base phase only, in both
  packages; SD3 refuses an IP-Adapter in both.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.convert import ip_adapter as JI
from ml_stable_diffusion_tpu.models.clip_vision import CLIPVisionConfig as JaxVisionConfig
from ml_stable_diffusion_tpu.models.clip_vision import CLIPVisionEncoder as JaxVisionEncoder
from ml_stable_diffusion_tpu.models.ip_adapter import IPImageProjection as JaxProjection
from ml_stable_diffusion_tpu.models.ip_adapter import IPResampler as JaxResampler
from ml_stable_diffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig

from ml_stable_diffusion_torch.convert import ip_adapter as PI
from ml_stable_diffusion_torch.convert.clip_vision import load_clip_vision
from ml_stable_diffusion_torch.convert.from_jax import clip_vision_state_dict, unet_state_dict
from ml_stable_diffusion_torch.convert.native_io import save_file
from ml_stable_diffusion_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
from ml_stable_diffusion_torch.models.ip_adapter import IPImageProjection, IPResampler
from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

import test_torch_controlnet as cnt
import test_torch_sdxl as xlt
from helpers import CTX_DIM, randomize_params
from test_ip_adapter import _plus_image_proj
from torch_helpers import pipelines, sd3_pipelines, sdxl_pipelines, tiny_unet, traced

HW = (64, 64)
VISION = dict(image_size=16, patch_size=8, hidden_size=16, intermediate_size=32,
              num_hidden_layers=2, num_attention_heads=2, projection_dim=8)
TOL = dict(rtol=1e-5, atol=1e-5)
#: the tiny Flax UNet, initialised once for the module
_tiny_unet = functools.cache(functools.partial(traced, tiny_unet))


def _port_names(paths):
    """JAX attn2 param paths -> the port's module names."""
    out = []
    for path in paths:
        tree = {"to_q": {"kernel": np.zeros((1, 1), np.float32)}}
        for k in reversed(path):
            tree = {k: tree}
        (key,) = unet_state_dict(tree)
        out.append(key[: -len(".to_q.weight")])
    return out


@pytest.mark.parametrize("name", ["sd21", "sd15", "sdxl", "tiny"])
def test_cross_attention_paths_match_jax(name):
    if name == "tiny":
        cfg = _tiny_unet()[0].config
    else:
        cfg = getattr(JaxUNetConfig, name)()
    port_cfg = UNetConfig(**{k: getattr(cfg, k) for k in UNetConfig.__dataclass_fields__})
    got = PI.cross_attention_paths(port_cfg)
    assert got == _port_names(JI.cross_attention_paths(cfg))
    assert got[-1].startswith("mid_block.attentions.0.")
    with torch.device("meta"):
        unet = UNet2DConditionModel(port_cfg)
    attn2 = [n for n, _ in unet.named_modules() if n.endswith(".attn2")]
    assert sorted(got) == sorted(attn2)


def _ip_layers(cfg, seed, scale=0.3):
    """Synthetic h94 ``ip_adapter`` group for a UNet config."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        unet = UNet2DConditionModel(cfg)
    out = {}
    for i, name in enumerate(PI.cross_attention_paths(cfg)):
        width = unet.get_submodule(name).to_q.weight.shape[0]
        for kv in ("to_k_ip", "to_v_ip"):
            out[f"{2 * i + 1}.{kv}.weight"] = (
                rng.normal(size=(width, cfg.cross_attention_dim)) * scale).astype(np.float32)
    return out


def test_port_ip_adapter_maps_as_jax_and_checks_indices():
    model, _ = _tiny_unet()
    cfg = UNetConfig(**{k: getattr(model.config, k) for k in UNetConfig.__dataclass_fields__})
    layers = _ip_layers(cfg, 1)
    got = PI.port_ip_adapter(cfg, {k: torch.from_numpy(v) for k, v in layers.items()})
    ref = JI.port_ip_adapter(model.config, layers)
    assert list(got) == _port_names(list(ref))
    for name, path in zip(got, ref):
        for kv in ("to_k_ip", "to_v_ip"):
            np.testing.assert_array_equal(got[name][kv].numpy(), ref[path][kv]["kernel"].T)
    few = {k: v for k, v in layers.items() if k.startswith("1.")}
    for mod, c in ((PI, cfg), (JI, model.config)):
        with pytest.raises(ValueError, match="wrong base model"):
            mod.port_ip_adapter(c, few)


def _base_image_proj(seed, embed_dim=8, cross=CTX_DIM, tokens=2):
    rng = np.random.default_rng(seed)
    return {"proj.weight": rng.normal(size=(tokens * cross, embed_dim)).astype(np.float32),
            "proj.bias": rng.normal(size=(tokens * cross,)).astype(np.float32) * 0.1,
            "norm.weight": 1.0 + rng.normal(size=(cross,)).astype(np.float32) * 0.1,
            "norm.bias": rng.normal(size=(cross,)).astype(np.float32) * 0.1}


@pytest.mark.parametrize("fmt", ["safetensors", "bin", "dict"])
def test_checkpoint_formats_read_as_jax(fmt, tmp_path):
    groups = {"image_proj": _base_image_proj(2), "ip_adapter": {
        "1.to_k_ip.weight": np.ones((16, CTX_DIM), np.float32),
        "1.to_v_ip.weight": np.zeros((16, CTX_DIM), np.float32)}}
    source = groups
    if fmt == "safetensors":
        source = tmp_path / "ip.safetensors"
        save_file({f"{g}.{k}": v for g, d in groups.items() for k, v in d.items()}, source)
    elif fmt == "bin":
        source = tmp_path / "ip.bin"
        torch.save({g: {k: torch.from_numpy(v) for k, v in d.items()}
                    for g, d in groups.items()}, source)
    got, ref = PI.load_ip_adapter_state(source), JI.load_ip_adapter_state(source)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            np.testing.assert_array_equal(g[k].numpy(), r[k])
    for mod in (PI, JI):
        with pytest.raises(ValueError, match="projection layout"):
            mod.load_ip_adapter_state({"image_proj": {"weird": np.zeros((4, 8), np.float32)},
                                       "ip_adapter": {}})


def test_resampler_geometry_matches_jax():
    g = _plus_image_proj(np.random.default_rng(3))
    assert PI.resampler_geometry({k: torch.from_numpy(v) for k, v in g.items()}) == \
        JI.resampler_geometry(g)


def _tiny_vision(seed=5):
    model = JaxVisionEncoder(JaxVisionConfig(**VISION))
    shapes = jax.eval_shape(model.init, jax.random.key(seed), jnp.zeros((1, 16, 16, 3)))
    params = randomize_params(shapes["params"], seed + 1, scale=0.3)
    port = CLIPVisionEncoder(CLIPVisionConfig(**VISION))
    port.load_state_dict(clip_vision_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return (model, params), port.eval()


def test_clip_vision_encoder_matches_flax(tmp_path):
    """Every output, through the Flax-tree converter and through a
    transformers-layout directory (nested ``vision_config``, the outer
    ``projection_dim``, a ``position_ids`` buffer) read by both loaders."""
    import json

    from ml_stable_diffusion_tpu.convert.clip_vision import load_clip_vision as jax_load

    (model, params), port = _tiny_vision()
    images = np.random.default_rng(0).uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    ref = jax.jit(model.apply)({"params": params}, jnp.asarray(images))
    sd = dict(port.state_dict())
    sd["vision_model.embeddings.position_ids"] = torch.arange(5)[None]
    save_file(sd, tmp_path / "model.safetensors")
    (tmp_path / "config.json").write_text(json.dumps(
        {"projection_dim": 8, "vision_config": dict(VISION, projection_dim=99,
                                                    hidden_act="gelu")}))
    loaded = load_clip_vision(tmp_path, device="cpu")
    jax_model, jax_params = jax_load(tmp_path)
    ref_dir = jax.jit(jax_model.apply)({"params": jax_params}, jnp.asarray(images))
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    with torch.no_grad():
        for enc in (port, loaded):
            got = enc(x)
            assert tuple(got["penultimate"].shape) == (2, 5, 16)
            for key in ("image_embeds", "pooled_output", "penultimate"):
                np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), **TOL)
                np.testing.assert_allclose(got[key].numpy(), np.asarray(ref_dir[key]), **TOL)


@pytest.mark.parametrize("kind", ["base", "plus"])
def test_projections_match_flax(kind):
    """The h94 ``image_proj`` group loaded strictly into the port module and
    ported by the JAX converter: the same tokens."""
    rng = np.random.default_rng(7)
    if kind == "base":
        sd = _base_image_proj(8)
        flax = JaxProjection(CTX_DIM, 2)
        params = JI.port_ip_image_projection(sd)
        port = IPImageProjection(8, CTX_DIM, 2)
        x = rng.normal(size=(3, 8)).astype(np.float32)
    else:
        sd = _plus_image_proj(rng, embed_dim=16, out_dim=CTX_DIM)
        sd = {k: v + rng.normal(size=v.shape).astype(np.float32) * 0.1 for k, v in sd.items()}
        geom = JI.resampler_geometry(sd)
        flax, params = JaxResampler(**geom), JI.port_ip_resampler(sd)
        port = IPResampler(**geom, embedding_dim=16)
        x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    ref = flax.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_unet_with_ip_tokens_matches_flax_and_its_identities():
    model, _ = _tiny_unet()
    x = np.random.default_rng(0).normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.asarray([11.0, 500.0], np.float32)
    ctx = np.random.default_rng(1).normal(size=(2, 77, CTX_DIM)).astype(np.float32)
    ip = np.random.default_rng(2).normal(size=(2, 4, CTX_DIM)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: model.init(k, x, t, ctx, ip_context=ip), jax.random.key(3))
    params = randomize_params(shapes["params"], 4)
    ref = jax.jit(lambda p: model.apply({"params": p}, x, t, ctx, ip_context=ip,
                                        ip_scale=0.7))(params)
    sd = unet_state_dict(jax.tree.map(np.asarray, params))
    port = UNet2DConditionModel(UNetConfig(**{k: getattr(model.config, k)
                                              for k in UNetConfig.__dataclass_fields__}))
    port.load_state_dict({k: v for k, v in sd.items() if "_ip." not in k}, strict=True)
    PI.install_ip_projections(port, {
        name: {kv: sd[f"{name}.{kv}.weight"] for kv in ("to_k_ip", "to_v_ip")}
        for name in PI.cross_attention_paths(port.config)})
    port.eval()
    assert sum(n.endswith(("to_k_ip.weight", "to_v_ip.weight")) for n in
               port.state_dict()) == 2 * len(PI.cross_attention_paths(port.config))

    def run(tokens, scale):
        with torch.no_grad():
            out = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                       torch.from_numpy(ctx), ip_context=tokens, ip_scale=scale)
        return out.permute(0, 2, 3, 1).numpy()

    ip_t = torch.from_numpy(ip)
    np.testing.assert_allclose(run(ip_t, 0.7), np.asarray(ref), rtol=1e-4, atol=1e-4)
    base = run(None, 1.0)
    np.testing.assert_array_equal(run(ip_t, 0.0), base)
    np.testing.assert_allclose(run(torch.zeros_like(ip_t), 1.0), base, atol=1e-6)
    assert np.abs(run(ip_t, 1.0) - base).max() > 1e-3


# -- the pipelines ----------------------------------------------------------------

def _adapter(kind, cfg, seed):
    cross = cfg.cross_attention_dim
    proj = (_base_image_proj(seed, cross=cross) if kind == "base" else
            _plus_image_proj(np.random.default_rng(seed), embed_dim=16, out_dim=cross))
    return {"image_proj": proj, "ip_adapter": _ip_layers(cfg, seed + 1)}


@pytest.fixture(scope="module")
def sd_pair(tmp_path_factory):
    """The tiny SD pipelines with a VAE encoder and one ControlNet, the
    tiny vision encoder, and the adapter each has loaded (none yet)."""
    jax_pipe, port_pipe = pipelines(tmp_path_factory.mktemp("ip"), weight_seed=61, encoder=True,
                                    controlnets=[cnt._controlnet(62)])
    return {"pipes": (jax_pipe, port_pipe), "vision": _tiny_vision(63), "loaded": None}


def _with_adapter(sd_pair, kind):
    jax_pipe, port_pipe = sd_pair["pipes"]
    if sd_pair["loaded"] != kind:
        (model, params), port_vision = sd_pair["vision"]
        groups = _adapter(kind, port_pipe.unet.config, 64)
        jax_pipe.load_ip_adapter(groups, (model, params))
        port_pipe.load_ip_adapter(groups, port_vision)
        sd_pair["loaded"] = kind
    return jax_pipe, port_pipe


def _image(seed):
    return np.random.default_rng(seed).uniform(0, 1, (16, 16, 3)).astype(np.float32)


CASES = {
    "cfg": dict(),
    "serial_cfg": dict(unet_batch_one=True),
    "inpaint": dict(starting_image=np.random.default_rng(5).uniform(-1, 1, (1, 64, 64, 3))
                    .astype(np.float32), mask_image=np.tile(
                        (np.arange(64) < 32).astype(np.float32), (64, 1)), strength=0.8),
    "controlnet": dict(controlnet_inputs=[cnt._cond(66)]),
    "deepcache": dict(deepcache_interval=2, step_count=3),
}


@pytest.mark.parametrize("kind,case", [("base", c) for c in CASES]
                         + [("plus", c) for c in CASES if c != "deepcache"])
def test_sd_generation_with_ip_adapter_matches_jax(sd_pair, kind, case):
    jax_pipe, port_pipe = _with_adapter(sd_pair, kind)
    kw = dict(prompt="a cat", negative_prompt="blurry", step_count=2,
              scheduler="DPMSolverMultistep", guidance_scale=6.0, seed=9, rng="numpy",
              disable_safety=True, ip_adapter_image=_image(65), ip_adapter_scale=0.8)
    kw.update(CASES[case])
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW).latents
    got = port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW).latents
    np.testing.assert_allclose(got, ref, atol=1e-3)
    if case != "cfg":
        return
    # the image moves the latents; at scale 0 they are the ones without it
    without = dict(kw, ip_adapter_image=None)
    plain = port_pipe.generate_images(PipelineConfiguration(**without), image_hw=HW).latents
    assert np.abs(got - plain).max() > 1e-4
    zero = port_pipe.generate_images(PipelineConfiguration(**dict(kw, ip_adapter_scale=0.0)),
                                     image_hw=HW).latents
    np.testing.assert_array_equal(zero, plain)
    # a PIL reference image, resized to the encoder's size by both
    from PIL import Image

    pil = Image.fromarray((_image(67).repeat(4, 0).repeat(4, 1) * 255).astype(np.uint8))
    kw["ip_adapter_image"] = pil
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW).latents
    got = port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW).latents
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_sdxl_ip_tokens_reach_the_base_phase_only_as_in_jax(tmp_path):
    """With a refiner, both packages give the tokens to the base UNet's
    calls and none to the refiner's (which has no IP projections): the
    same latents."""
    jax_pipe, port_pipe = sdxl_pipelines(tmp_path, refiner=True)
    (model, params), port_vision = _tiny_vision(71)
    groups = _adapter("base", port_pipe.unet.config, 72)
    jax_pipe.load_ip_adapter(groups, (model, params))
    port_pipe.load_ip_adapter(groups, port_vision)
    assert not any(n.endswith("to_k_ip") for n, _ in port_pipe.refiner_unet.named_modules())
    kw = dict(prompt="a cat", negative_prompt="blurry", step_count=3, guidance_scale=5.0,
              seed=7, scheduler="DPMSolverMultistep", disable_safety=True, rng="numpy",
              refiner_start=0.6, ip_adapter_image=_image(73))
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW).latents
    got = port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW).latents
    np.testing.assert_allclose(got, ref, atol=1e-3)
    # and tokens handed to the refiner itself fail in its cross attention
    refiner = port_pipe.refiner_unet
    with pytest.raises(ValueError, match="to_k_ip"):
        refiner(torch.zeros(1, 4, 8, 8), torch.tensor(1.0), torch.zeros(1, 77, CTX_DIM),
                {"text_embeds": torch.zeros(1, xlt.POOLED), "time_ids": torch.zeros(1, 5)},
                ip_context=torch.zeros(1, 4, CTX_DIM))


def test_sd3_refuses_ip_adapter_as_jax(tmp_path):
    jax_pipe, port_pipe = sd3_pipelines(tmp_path)
    groups = {"image_proj": _base_image_proj(1), "ip_adapter": {}}
    for pipe in (jax_pipe, port_pipe):
        with pytest.raises(ValueError, match="UNet denoisers"):
            pipe.load_ip_adapter(groups, None)
