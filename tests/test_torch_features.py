"""The port's SD-family features against the JAX package's, on the CPU:
prompt weights and long prompts, progress callbacks with previews and
early stop, DeepCache and its guards, and the multilingual projection.

Tiny models of tests/helpers.py with seeded N(0, 0.2) weights, the same
inputs and ``rng="numpy"``: pipeline latents within atol 1e-3, as
tests/test_torch_pipeline.py holds txt2img; the host-side pieces (the
prompt parser, the windows and weights, the multilingual rows) equal; the
UNet's DeepCache outputs against Flax within 1e-4, and its shallow pass on
a feature from a full pass on the same inputs equal to that pass bit for
bit.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.models.multilingual import MultilingualProjection as JaxProjection
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig
from ml_stable_diffusion_tpu.pipelines.sd import _tokenize_chunked as jax_tokenize_chunked
from ml_stable_diffusion_tpu.pipelines.sd import apply_prompt_weights as jax_apply_prompt_weights
from ml_stable_diffusion_tpu.tokenizer import prompt_weights as jax_pw
from ml_stable_diffusion_tpu.utils.latent_preview import latent_to_rgb_preview as jax_preview

from ml_stable_diffusion_torch.convert.from_jax import unet_state_dict
from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration
from ml_stable_diffusion_torch.pipelines.sd import _tokenize_chunked, apply_prompt_weights
from ml_stable_diffusion_torch.tokenizer import CLIPTokenizer
from ml_stable_diffusion_torch.tokenizer import prompt_weights as port_pw
from ml_stable_diffusion_torch.utils.latent_preview import latent_to_rgb_preview

from helpers import CTX_DIM, fake_multilingual_embedder, randomize_params, tiny_tokenizer
from torch_helpers import _load, pipelines, port_multilingual, tiny_unet, traced

HW = (64, 64)
WORDS = ["cat", "dog", "fox", "owl", "bat", "elk", "hen", "ram"]


def _words(n, start=0):
    return " ".join(WORDS[(start + i) % len(WORDS)] for i in range(n))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return pipelines(tmp_path_factory.mktemp("tok"), weight_seed=90, encoder=True)


def _args(**kw):
    out = dict(prompt="a cat", negative_prompt="blurry", step_count=4, seed=11,
               guidance_scale=7.5, scheduler="DPMSolverMultistep", disable_safety=True,
               rng="numpy")
    out.update(kw)
    return out


def _compare(pair, **kw):
    jax_pipe, port_pipe = pair
    ref = jax_pipe.generate_images(JaxConfig(**_args(**kw)), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**_args(**kw)), image_hw=HW)
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)
    return got


# -- prompt weights and long prompts ---------------------------------------------

#: tests/test_prompt_weights.py's parser cases
@pytest.mark.parametrize("text", [
    "a cat", "a (cat)", "((cat))", "a (cat:1.5) dog", "[cat]", "(a [cat] b)",
    r"\(literal\)", "(unclosed", "a:b", "", "((cat:1.5):2)", "a (cat:1.5) [[dog]] (x:0.5"])
def test_parse_prompt_attention_matches_jax(text):
    assert port_pw.parse_prompt_attention(text) == jax_pw.parse_prompt_attention(text)


@pytest.mark.parametrize("text,max_chunks", [
    ("a (cat:1.5) sat", 4),
    (_words(40), 4),                   # two windows
    ("(" + _words(100) + ":0.8)", 4),  # four windows, all weighted
    (_words(200), 3),                  # cut at three windows
])
def test_weighted_token_chunks_match_jax(tmp_path, text, max_chunks):
    tok = tiny_tokenizer(tmp_path)
    port_tok = CLIPTokenizer.from_pretrained_dir(tmp_path)
    ids, w, aw = port_pw.weighted_token_chunks(port_tok, text, 77, max_chunks)
    ref_ids, ref_w, ref_aw = jax_pw.weighted_token_chunks(tok, text, 77, max_chunks)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(w, ref_w)
    assert aw == ref_aw
    if text == "a (cat:1.5) sat":  # one window: the plain row, weights aside
        np.testing.assert_array_equal(ids[0], port_tok.tokenize("a cat sat", 77)[0])


def test_tokenize_chunked_matches_jax(tmp_path):
    """A batch of one- and three-window prompts: the shorter padded with
    BOS+EOS windows of weight 1."""
    tok = tiny_tokenizer(tmp_path)
    texts = ["dog", "a [cat]", _words(60), "(" + _words(20) + ")"]
    got = _tokenize_chunked(CLIPTokenizer.from_pretrained_dir(tmp_path), texts)
    ref = jax_tokenize_chunked(tok, texts)
    assert got[0].shape == (4, 3, 77)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_apply_prompt_weights_matches_jax():
    rng = np.random.RandomState(0)
    ctx = (rng.randn(2, 154, 6) + 0.3).astype(np.float32)
    w = np.ones((2, 154), np.float32)
    w[0, 2:9] = 1.7
    w[1, 80:90] = 0.6
    got = apply_prompt_weights(torch.from_numpy(ctx), torch.from_numpy(w)).numpy()
    ref = np.asarray(jax_apply_prompt_weights(jnp.asarray(ctx), jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.mean(axis=(1, 2)), ctx.mean(axis=(1, 2)), rtol=1e-5)


@pytest.mark.parametrize("kw,plain", [
    (dict(prompt=_words(40)), None),                                 # 2 windows
    (dict(prompt="(" + _words(100) + ":1.2) [" + _words(5, 3) + "]"),  # 4 windows, weighted
     _words(100) + " " + _words(5, 3)),
    (dict(prompt=["a (cat:1.4)", _words(60)], negative_prompt="dog", image_count=2,
          seed=[3, 4]), None),                                       # 1 and 3 windows
])
def test_long_and_weighted_prompts_match_jax(pair, kw, plain):
    got = _compare(pair, **kw)
    if plain is not None:  # the weights move the result
        without = pair[1].generate_images(PipelineConfiguration(**_args(**dict(kw, prompt=plain))),
                                          image_hw=HW)
        assert np.abs(got.latents - without.latents).max() > 1e-3


def test_unweighted_prompt_is_bit_identical(pair):
    """``(cat:1.0)`` carries no weight: the same ids and no weights input,
    so the latents equal the plain prompt's bit for bit, as in JAX."""
    _, port_pipe = pair
    a, b = (port_pipe.generate_images(PipelineConfiguration(**_args(prompt=p, step_count=2)),
                                      image_hw=HW).latents
            for p in ("a cat sat", "a (cat:1.0) sat"))
    np.testing.assert_array_equal(a, b)


# -- progress callbacks --------------------------------------------------------------

def _recorder(stop_after=None):
    seen = []

    def handler(progress):
        seen.append(progress)
        return None if stop_after is None or progress.step < stop_after else False

    return seen, handler


@pytest.mark.parametrize("denoised,stop_after", [(True, None), (False, 2)])
def test_progress_handler_matches_jax(pair, denoised, stop_after):
    """Steps 1..n of the plan's n, the latents NHWC after each step, the
    denoised previews; a handler returning False stops both pipelines after
    the same step, the latents decoded as they are then."""
    jax_pipe, port_pipe = pair
    kw = _args(use_denoised_intermediates=denoised, scheduler="PNDM")
    ref_seen, ref_handler = _recorder(stop_after)
    got_seen, got_handler = _recorder(stop_after)
    ref = jax_pipe.generate_images(JaxConfig(**kw), progress_handler=ref_handler, image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**kw), progress_handler=got_handler,
                                    image_hw=HW)
    n = 5  # PNDM: 4 steps, 5 UNet calls
    want_steps = list(range(1, (stop_after or n) + 1))
    assert [p.step for p in got_seen] == [p.step for p in ref_seen] == want_steps
    assert {p.step_count for p in got_seen} == {p.step_count for p in ref_seen} == {n}
    for g, r in zip(got_seen, ref_seen):
        assert g.latents.shape == (1, 8, 8, 4)
        np.testing.assert_allclose(g.latents, r.latents, atol=1e-3)
        assert (g.denoised is None) == (r.denoised is None) == (not denoised)
        if denoised:
            np.testing.assert_allclose(g.denoised, r.denoised, atol=1e-3)
        preview = latent_to_rgb_preview(g.latents)
        assert preview.shape == (1, 8, 8, 3)
        np.testing.assert_allclose(preview, jax_preview(r.latents), atol=1e-3)
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)
    np.testing.assert_allclose(got.latents, got_seen[-1].latents, atol=0)
    assert got.seconds_per_step > 0
    last_images = got_seen[-1].current_images
    ref_images = np.stack([np.asarray(im) for im in ref_seen[-1].current_images])
    assert last_images.shape == (1, 64, 64, 3) and last_images.dtype == np.uint8
    assert np.abs(last_images.astype(int) - ref_images.astype(int)).max() <= 1


# -- DeepCache ----------------------------------------------------------------------

@pytest.mark.parametrize("dc", [2, 3])
def test_deepcache_matches_jax(pair, dc):
    """PNDM 6 steps (7 UNet calls): full passes at calls 0, dc, 2 dc, ..."""
    got = _compare(pair, deepcache_interval=dc, step_count=6, scheduler="PNDM")
    exact = pair[1].generate_images(PipelineConfiguration(**_args(step_count=6,
                                                                  scheduler="PNDM")),
                                    image_hw=HW)
    assert np.abs(got.latents - exact.latents).max() > 1e-4


def _image():
    return np.random.RandomState(2).uniform(-1, 1, (1, *HW, 3)).astype(np.float32)


@pytest.mark.parametrize("kw,handler", [
    # PNDM plans 4 calls for 3 steps: gated on the 3
    (dict(deepcache_interval=3, step_count=3, scheduler="PNDM"), False),
    (dict(deepcache_interval=2, unet_batch_one=True), False),
    (dict(deepcache_interval=2), True),
    # strength 0.1 of 20 steps runs 2 of them
    (dict(deepcache_interval=2, step_count=20, strength=0.1, starting_image=_image()), False),
])
def test_deepcache_guards_match_jax(pair, kw, handler):
    jax_pipe, port_pipe = pair
    extra = {"progress_handler": (lambda p: None)} if handler else {}
    with pytest.raises(ValueError, match="deepcache_interval") as ref:
        jax_pipe.generate_images(JaxConfig(**_args(**kw)), image_hw=HW, **extra)
    with pytest.raises(ValueError, match="deepcache_interval") as got:
        port_pipe.generate_images(PipelineConfiguration(**_args(**kw)), image_hw=HW, **extra)
    assert str(got.value) == str(ref.value)


@pytest.fixture(scope="module")
def unet_pair():
    model, params = traced(tiny_unet)
    params = randomize_params(params, 91)
    return model, params, _load(UNet2DConditionModel, UNetConfig, model, params,
                                unet_state_dict)


def _unet_inputs(seed=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 8, 8, 4).astype(np.float32), np.asarray([700.0, 30.0], np.float32),
            rng.randn(2, 77, CTX_DIM).astype(np.float32))


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_deep_feature_matches_flax(unet_pair):
    """The full pass's output and deep feature, and the shallow pass on a
    feature from other inputs (the DeepCache approximation)."""
    model, params, port = unet_pair
    x, t, ctx = _unet_inputs()
    full = jax.jit(lambda *a: model.apply({"params": params}, *a, return_deep_feature=True))
    cached = jax.jit(lambda *a, f: model.apply({"params": params}, *a, deep_feature=f))
    ref_out, ref_feat = full(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    x2, t2, _ = _unet_inputs(5)
    ref_shallow = cached(jnp.asarray(x2), jnp.asarray(t2), jnp.asarray(ctx), f=ref_feat)
    with torch.no_grad():
        out, feat = port(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         return_deep_feature=True)
        shallow = port(_nchw(x2), torch.from_numpy(t2), torch.from_numpy(ctx),
                       deep_feature=feat)
    assert feat.shape == (2, 32, 8, 8)
    for g, r in ((out, ref_out), (feat, ref_feat), (shallow, ref_shallow)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)


def test_shallow_pass_on_its_own_feature_is_the_full_forward(unet_pair):
    _, _, port = unet_pair
    x, t, ctx = (torch.from_numpy(a) for a in _unet_inputs())
    x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        plain = port(x, t, ctx)
        out, feat = port(x, t, ctx, return_deep_feature=True)
        shallow = port(x, t, ctx, deep_feature=feat)
    assert torch.equal(out, plain) and torch.equal(shallow, plain)
    with pytest.raises(ValueError, match="exclude"):
        port(x, t, ctx, deep_feature=feat, return_deep_feature=True)


# -- the multilingual projection ----------------------------------------------------

def _projection(seed=93):
    model = JaxProjection(CTX_DIM)
    params = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 4, 512)))["params"]
    return model, randomize_params(params, seed, scale=0.05)


def test_multilingual_projection_matches_flax():
    model, params = _projection()
    x = np.random.RandomState(1).randn(2, 256, 512).astype(np.float32)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port_multilingual(params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ml_pair(tmp_path_factory):
    model, params = _projection()
    return pipelines(tmp_path_factory.mktemp("ml"), weight_seed=94,
                     multilingual=(model, params, fake_multilingual_embedder))


def test_multilingual_generation_matches_jax(ml_pair):
    """The projected rows (256 a prompt) replace CLIP's context."""
    jax_pipe, port_pipe = ml_pair
    kw = _args(prompt="un chat sur un toit", negative_prompt="flou")
    tokens = port_pipe._tokenize(PipelineConfiguration(**kw))
    np.testing.assert_array_equal(tokens["ml_embeds"],
                                  jax_pipe._tokenize(JaxConfig(**kw))["ml_embeds"])
    assert tokens["ml_embeds"].shape == (2, 256, 512)
    _compare(ml_pair, prompt="un chat sur un toit", negative_prompt="flou")


def test_multilingual_rows_cut_and_width_checked(ml_pair):
    """Rows past 256 are cut; a width other than 512 raises as in JAX."""
    jax_pipe, port_pipe = ml_pair
    rng = np.random.RandomState(5)
    long_rows = rng.randn(300, 512).astype(np.float32)
    for pipe in (jax_pipe, port_pipe):
        pipe.multilingual_encoder = pipe.multilingual_encoder[:-1] + (lambda t: long_rows,)
    kw = _args()
    got = port_pipe._tokenize(PipelineConfiguration(**kw))["ml_embeds"]
    np.testing.assert_array_equal(got, jax_pipe._tokenize(JaxConfig(**kw))["ml_embeds"])
    np.testing.assert_array_equal(got[0], long_rows[:256])
    for pipe in (jax_pipe, port_pipe):
        pipe.multilingual_encoder = pipe.multilingual_encoder[:-1] + (
            lambda t: np.zeros((4, 100), np.float32),)
    with pytest.raises(ValueError, match="embed_fn") as ref:
        jax_pipe._tokenize(JaxConfig(**kw))
    with pytest.raises(ValueError, match="embed_fn") as err:
        port_pipe._tokenize(PipelineConfiguration(**kw))
    assert str(err.value) == str(ref.value)
    for pipe in (jax_pipe, port_pipe):
        pipe.multilingual_encoder = pipe.multilingual_encoder[:-1] + (fake_multilingual_embedder,)
