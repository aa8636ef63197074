"""The port's SD3 txt2img pipeline against the JAX
``StableDiffusion3Pipeline``, on the CPU.

Tiny CLIP-L (unprojected pooled output) and CLIP-G (projected), a tiny MMDiT
and the 16-channel tiny VAE of tests/test_pipeline_sd3.py, all with seeded
N(0, 0.2) weights, go through both ``generate_images`` with rng="numpy":
latents within atol 1e-3 and uint8 images within 1, as for the SD-2.1
pipeline (tests/test_torch_pipeline.py).  Also: the context assembly (two
penultimate states, zero channel pad, zero T5 block, pooled concat), the
scheduler rule (DiscreteFlow only, "PNDM" mapping to it),
``timestep_shift``, and the T5 and SD3 ControlNet parts against the JAX
pipeline's (their generations: tests/test_torch_controlnet_sd3.py).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.models.mmdit import MMDiT as JaxMMDiT
from ml_stable_diffusion_tpu.models.mmdit import MMDiTConfig as JaxMMDiTConfig
from ml_stable_diffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
from ml_stable_diffusion_tpu.models.vae import VAEDecoder as JaxVAEDecoder
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig
from ml_stable_diffusion_tpu.pipelines.sd3 import StableDiffusion3Pipeline as JaxSD3

from ml_stable_diffusion_torch.convert.from_jax import (
    clip_text_state_dict,
    mmdit_state_dict,
    vae_decoder_state_dict,
)
from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from ml_stable_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEDecoder
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration, StableDiffusion3Pipeline
from ml_stable_diffusion_torch.tokenizer import CLIPTokenizer

from helpers import CTX_DIM, randomize_params, tiny_tokenizer
from torch_helpers import _load, tiny_text_encoder, traced

HW = (64, 64)
T5_LEN = 16
MM_CTX = 128  # 2 * CTX_DIM zero-padded
POOLED = CTX_DIM + 32  # CLIP-L unprojected + CLIP-G projected


def _tiny_mmdit():
    cfg = JaxMMDiTConfig(patch_size=2, in_channels=16, out_channels=16, depth=2,
                         hidden_size=32, num_heads=4, context_dim=MM_CTX, pooled_dim=POOLED,
                         pos_embed_max_size=16)
    model = JaxMMDiT(cfg)
    # every caller seeds its own weights: the init's shapes are enough
    params = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 8, 8, 16)),
                            jnp.zeros((1,)), jnp.zeros((1, 10, MM_CTX)),
                            jnp.zeros((1, POOLED)))["params"]
    return model, params


def _tiny_vae16():
    """tests/test_pipeline_sd3.py's 16-channel decoder without quant convs."""
    cfg = JaxVAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                       norm_num_groups=4, latent_channels=16, use_quant_conv=False)
    dec = JaxVAEDecoder(cfg)
    return dec, jax.eval_shape(dec.init, jax.random.key(2), jnp.zeros((1, 8, 8, 16)))["params"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tok1, tok2 = tmp_path_factory.mktemp("l"), tmp_path_factory.mktemp("g")
    (te1, p1), (te2, p2) = traced(tiny_text_encoder), traced(tiny_text_encoder,
                                                             use_projection=True)
    mm, mp = _tiny_mmdit()
    dec, dp = _tiny_vae16()
    p1, p2, mp, dp = (randomize_params(p, seed) for p, seed in
                      ((p1, 31), (p2, 32), (mp, 33), (dp, 34)))
    jax_pipe = JaxSD3(tokenizer=tiny_tokenizer(tok1), tokenizer2=tiny_tokenizer(tok2),
                      text_encoder=(te1, p1), text_encoder2=(te2, p2), mmdit=(mm, mp),
                      vae_decoder=(dec, dp), t5_sequence_length=T5_LEN)
    port_pipe = StableDiffusion3Pipeline(
        tokenizer=CLIPTokenizer.from_pretrained_dir(tok1),
        tokenizer2=CLIPTokenizer.from_pretrained_dir(tok2),
        text_encoder=_load(CLIPTextEncoder, CLIPTextConfig, te1, p1, clip_text_state_dict),
        text_encoder2=_load(CLIPTextEncoder, CLIPTextConfig, te2, p2, clip_text_state_dict),
        mmdit=_load(MMDiT, MMDiTConfig, mm, mp, mmdit_state_dict),
        vae_decoder=_load(VAEDecoder, VAEConfig, dec, dp, vae_decoder_state_dict),
        t5_sequence_length=T5_LEN, device="cpu")
    return jax_pipe, port_pipe


def _kw(**kw):
    out = dict(prompt="a cat", negative_prompt="blurry", step_count=3, guidance_scale=4.5,
               seed=7, disable_safety=True, rng="numpy")
    out.update(kw)
    return out


@pytest.mark.parametrize("case", [
    dict(),
    dict(prompt=["a cat", "a dog"], seed=[5, 6], image_count=2, rng="nvidia",
         timestep_shift=1.0),
    dict(guidance_scale=1.0, rng="torch"),
])
def test_generate_images_matches_jax(pair, case):
    jax_pipe, port_pipe = pair
    kw = _kw(**case)
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW)
    n = kw.get("image_count", 1)
    assert got.latents.shape == (n, 8, 8, 16) and np.isfinite(got.latents).all()
    assert got.images.shape == (n, 64, 64, 3) and got.images.dtype == np.uint8
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)
    ref_images = np.stack([np.asarray(im) for im in ref.images])
    assert np.abs(got.images.astype(int) - ref_images.astype(int)).max() <= 1


def test_context_assembly_matches_jax(pair):
    jax_pipe, port_pipe = pair
    cfg = _kw()
    tokens = jax_pipe._tokenize(JaxConfig(**cfg))
    ref = jax_pipe._encode_text(JaxConfig(**cfg), {k: jnp.asarray(v) for k, v in tokens.items()},
                                jax_pipe._params_bundle())
    got_tokens = port_pipe._tokenize(PipelineConfiguration(**cfg))
    for key in ("ids", "ids2"):
        np.testing.assert_array_equal(got_tokens[key], tokens[key])
    with torch.no_grad():
        got = port_pipe._encode_text(got_tokens)
    ctx = got["context"].numpy()
    assert ctx.shape == (2, 77 + T5_LEN, MM_CTX)
    assert got["pooled"].shape == (2, POOLED)
    np.testing.assert_array_equal(ctx[:, :77, 2 * CTX_DIM:], 0.0)  # channel pad
    np.testing.assert_array_equal(ctx[:, 77:], 0.0)  # the zero T5 block
    assert np.abs(ctx[:, :77, :2 * CTX_DIM]).min(axis=(0, 1)).max() > 0
    np.testing.assert_allclose(ctx, np.asarray(ref["context"]), atol=1e-4)
    np.testing.assert_allclose(got["pooled"].numpy(), np.asarray(ref["pooled"]), atol=1e-4)


def test_scheduler_rule(pair):
    """"PNDM", the configuration default, runs DiscreteFlow; any other
    scheduler raises ValueError, as in the JAX pipeline."""
    jax_pipe, port_pipe = pair
    kw = _kw(step_count=2, scheduler="PNDM")
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW)
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)
    for name in ("DPMSolverMultistep", "DDIM"):
        with pytest.raises(ValueError, match="DiscreteFlow"):
            port_pipe.generate_images(PipelineConfiguration(**_kw(scheduler=name)),
                                      image_hw=HW)


def test_timestep_shift_is_read(pair):
    _, port_pipe = pair
    a, b = (port_pipe.generate_images(PipelineConfiguration(**_kw(step_count=2,
                                                                  timestep_shift=s)),
                                      image_hw=HW)
            for s in (3.0, 1.0))
    assert np.abs(a.latents - b.latents).max() > 1e-6


def test_unported_parts_raise(pair):
    """The T5 encoder and tokenizer and SD3 ControlNets are ported
    (test_t5_and_controlnet_parts_match_jax below); what still raises is
    what the JAX pipeline refuses: ControlNets without a ``vae_encoder``,
    with the JAX ``ValueError`` and its message."""
    jax_pipe, port_pipe = pair
    with pytest.raises(ValueError, match="pass vae_encoder") as ref:
        JaxSD3(tokenizer=jax_pipe.tokenizer, tokenizer2=jax_pipe.tokenizer2,
               text_encoder=(jax_pipe.text_encoder, jax_pipe.text_encoder_params),
               text_encoder2=(jax_pipe.text_encoder2, jax_pipe.text_encoder2_params),
               mmdit=(jax_pipe.unet, jax_pipe.unet_params),
               vae_decoder=(jax_pipe.vae_decoder, jax_pipe.vae_decoder_params),
               controlnets=[object()])
    with pytest.raises(ValueError, match="pass vae_encoder") as got:
        StableDiffusion3Pipeline(
            tokenizer=port_pipe.tokenizer, tokenizer2=port_pipe.tokenizer2,
            text_encoder=port_pipe.text_encoder, text_encoder2=port_pipe.text_encoder2,
            mmdit=port_pipe.unet, vae_decoder=port_pipe.vae_decoder,
            controlnets=[object()], device="cpu")
    assert str(got.value) == str(ref.value)


@pytest.fixture(scope="module")
def t5_parts(tmp_path_factory):
    """A tiny T5 (d_model = the MMDiT's context width) with seeded weights,
    both packages' tokenizers on tests/test_native_t5.py's unigram file."""
    from ml_stable_diffusion_tpu.models.t5 import T5Config as JaxT5Config
    from ml_stable_diffusion_tpu.models.t5 import T5Encoder as JaxT5Encoder
    from ml_stable_diffusion_tpu.tokenizer.t5 import T5Tokenizer as JaxT5Tokenizer

    from ml_stable_diffusion_torch.convert.from_jax import t5_state_dict
    from ml_stable_diffusion_torch.models.t5 import T5Config, T5Encoder
    from ml_stable_diffusion_torch.tokenizer.t5 import T5Tokenizer

    from test_native_t5 import _unigram_json

    tok_json = _unigram_json(tmp_path_factory.mktemp("t5tok"))
    cfg = dict(vocab_size=256, d_model=MM_CTX, d_kv=16, d_ff=64, num_layers=2, num_heads=4)
    t5 = JaxT5Encoder(JaxT5Config(**cfg))
    ids = jnp.ones((1, T5_LEN), jnp.int32)
    params = randomize_params(jax.eval_shape(t5.init, jax.random.key(6), ids, ids)["params"], 37)
    port = T5Encoder(T5Config(**cfg))
    port.load_state_dict(t5_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return ((t5, params), JaxT5Tokenizer(tok_json)), (port.eval(), T5Tokenizer(tok_json))


@pytest.mark.parametrize("part", ["t5_tokenizer", "t5_encoder", "controlnets"])
def test_t5_and_controlnet_parts_match_jax(pair, t5_parts, part):
    """Each part the port used to refuse, against the JAX pipeline's: the T5
    ids and mask at t5_sequence_length (equal), the context with T5 states
    as its last T5_LEN rows (atol 1e-4), and the control latents each net
    gets, VAE-encoded once (``(mean - shift) * scale`` or, for a
    ``force_zeros`` net, ``mean * scale``; atol 1e-5)."""
    import copy

    jax_pipe, port_pipe = (copy.copy(p) for p in pair)
    cfg = _kw(prompt="hello world, a cat", negative_prompt="the horse")
    if part != "controlnets":
        (jax_pipe.t5_encoder, jax_pipe.t5_encoder_params), jax_pipe.t5_tokenizer = t5_parts[0]
        port_pipe.t5_encoder, port_pipe.t5_tokenizer = t5_parts[1]
        tokens = jax_pipe._tokenize(JaxConfig(**cfg))
        got_tokens = port_pipe._tokenize(PipelineConfiguration(**cfg))
        assert set(got_tokens) == set(tokens) == {"ids", "ids2", "ids_t5", "mask_t5"}
        for key in tokens:
            np.testing.assert_array_equal(got_tokens[key], tokens[key])
        if part == "t5_tokenizer":
            assert tokens["mask_t5"].sum(axis=1).min() > 1
            return
        ref = jax_pipe._encode_text(JaxConfig(**cfg),
                                    {k: jnp.asarray(v) for k, v in tokens.items()},
                                    jax_pipe._params_bundle())["context"]
        with torch.no_grad():
            got = port_pipe._encode_text(got_tokens)["context"].numpy()
        assert got.shape == (2, 77 + T5_LEN, MM_CTX) and np.abs(got[:, 77:]).max() > 0
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4)
        return
    from ml_stable_diffusion_tpu.models.controlnet_sd3 import SD3ControlNetConfig as JaxCNConfig
    from ml_stable_diffusion_tpu.models.vae import VAEEncoder as JaxVAEEncoder

    from ml_stable_diffusion_torch.models.controlnet_sd3 import SD3ControlNetConfig

    from torch_helpers import port_vae_encoder

    vcfg = JaxVAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                        norm_num_groups=4, latent_channels=16, use_quant_conv=False)
    enc = JaxVAEEncoder(vcfg)
    ep = randomize_params(jax.eval_shape(enc.init, jax.random.key(5), jnp.zeros((1, 64, 64, 3)))[
        "params"], 38)
    # only the nets' configurations are read when the inputs are prepared
    jax_pipe.controlnets = [(type("Net", (), {"config": JaxCNConfig(
        force_zeros_for_pooled_projection=fz)}), None) for fz in (True, False)]
    port_pipe.controlnets = [type("Net", (), {"config": SD3ControlNetConfig(
        force_zeros_for_pooled_projection=fz)}) for fz in (True, False)]
    jax_pipe.vae_encoder, port_pipe.vae_encoder = enc, port_vae_encoder(enc, ep)
    images = np.random.RandomState(9).uniform(0, 1, (2, 1, 64, 64, 3)).astype(np.float32)
    cfg = JaxConfig(**_kw(encoder_scale_factor=1.25))
    ref = jax_pipe._prepare_control_inputs({"vae_encoder": ep}, cfg, list(images))
    with torch.no_grad():
        got = port_pipe._prepare_control_inputs(
            PipelineConfiguration(**_kw(encoder_scale_factor=1.25)),
            [torch.from_numpy(im).permute(0, 3, 1, 2) for im in images])
    for g, r in zip(got, ref):
        assert g.shape == (1, 16, 8, 8)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), atol=1e-5)
    assert np.abs(np.asarray(ref[0]) - np.asarray(ref[1])).max() > 0


def test_deepcache_raises_value_error_as_in_jax(pair):
    """The MMDiT has no shallow/deep split: both pipelines refuse DeepCache
    with ValueError."""
    jax_pipe, port_pipe = pair
    kw = _kw(step_count=2, deepcache_interval=2)
    with pytest.raises(ValueError, match="deepcache_interval") as ref:
        jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW)
    with pytest.raises(ValueError, match="deepcache_interval") as got:
        port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW)
    assert str(got.value) == str(ref.value)


def test_sd3_pipeline_constants_are_the_jax_ones():
    assert (StableDiffusion3Pipeline.default_latent_scale,
            StableDiffusion3Pipeline.default_latent_shift,
            StableDiffusion3Pipeline.latent_channels) == (
        JaxSD3.default_latent_scale, JaxSD3.default_latent_shift, JaxSD3.latent_channels)


def test_img2img_matches_jax(pair):
    """img2img through DiscreteFlow strength with a 16-channel encoder:
    ``z0 = sample * scale`` (no shift, as the JAX SD3 pipeline encodes)."""
    import copy

    from ml_stable_diffusion_tpu.models.vae import VAEEncoder as JaxVAEEncoder

    from torch_helpers import port_vae_encoder

    cfg = JaxVAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                       norm_num_groups=4, latent_channels=16, use_quant_conv=False)
    enc = JaxVAEEncoder(cfg)
    ep = randomize_params(jax.eval_shape(enc.init, jax.random.key(5), jnp.zeros((1, 64, 64, 3)))[
        "params"], 35)
    jax_pipe, port_pipe = (copy.copy(p) for p in pair)
    jax_pipe.vae_encoder, jax_pipe.vae_encoder_params = enc, ep
    port_pipe.vae_encoder = port_vae_encoder(enc, ep)
    image = np.random.RandomState(8).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    kw = _kw(step_count=4, starting_image=image, strength=0.6)
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW)
    assert got.latents.shape == (1, 8, 8, 16) and np.isfinite(got.latents).all()
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)
    ref_images = np.stack([np.asarray(im) for im in ref.images])
    assert np.abs(got.images.astype(int) - ref_images.astype(int)).max() <= 1
