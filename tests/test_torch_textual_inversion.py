"""The port's textual inversion against the JAX package's, on the CPU.

- every load format (a1111 .pt, ``emb_params`` and SDXL ``clip_l``/``clip_g``
  safetensors, the diffusers ``{token: tensor}`` form, a dict, an array):
  the same vectors bit for bit and the same token name;
- placeholder expansion: the port tokenizer's ids equal to the JAX
  tokenizer's, case-insensitive and longest first, weighted prompts (the
  prompt-weight windows) included;
- the grown token table in float32 and bfloat16, equal to the JAX one;
- a tiny SD generation with a placeholder against the JAX pipeline (atol
  1e-3), and the word-equivalence witness (a placeholder whose vectors are
  a word's rows gives the latents of that word, bit for bit);
- SDXL and SD3: vectors needed for both CLIP encoders, the tokenizations of
  both equal to JAX's (SD3's T5 sees the placeholder's text as it is).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import numpy as np
import pytest
import torch

from ml_stable_diffusion_tpu.convert import textual_inversion as JT
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig
from ml_stable_diffusion_tpu.tokenizer.prompt_weights import (
    weighted_token_chunks as jax_weighted_token_chunks,
)

from ml_stable_diffusion_torch.convert import textual_inversion as PT
from ml_stable_diffusion_torch.convert.from_jax import clip_text_state_dict
from ml_stable_diffusion_torch.convert.native_io import save_file
from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration
from ml_stable_diffusion_torch.tokenizer import CLIPTokenizer
from ml_stable_diffusion_torch.tokenizer.prompt_weights import weighted_token_chunks

from helpers import CTX_DIM, VOCAB, tiny_tokenizer
from torch_helpers import _load, pipelines, sd3_pipelines, sdxl_pipelines, tiny_text_encoder

HW = (64, 64)


def _rows(n=3, dim=CTX_DIM, seed=0):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)


def _source(fmt, tmp_path):
    """The same vectors (and, for SDXL, CLIP-G's) in format ``fmt``."""
    arr, g = _rows(), _rows(dim=64, seed=1)
    if fmt == "emb_params":
        save_file({"emb_params": arr}, tmp_path / "emb.safetensors")
        return tmp_path / "emb.safetensors"
    if fmt == "dual":
        save_file({"clip_l": arr, "clip_g": g}, tmp_path / "dual.safetensors")
        return tmp_path / "dual.safetensors"
    if fmt == "diffusers":
        save_file({"<thing>": arr}, tmp_path / "diff.safetensors")
        return tmp_path / "diff.safetensors"
    if fmt == "a1111":
        torch.save({"string_to_param": {"*": torch.from_numpy(arr)}, "name": "<style>"},
                   tmp_path / "a1111.pt")
        return tmp_path / "a1111.pt"
    if fmt == "dict":
        return {"clip_l": arr, "clip_g": g}
    return arr[0]  # one vector, promoted to (1, d)


@pytest.mark.parametrize("fmt", ["emb_params", "dual", "diffusers", "a1111", "dict", "array"])
def test_load_formats_match_jax(fmt, tmp_path):
    source = _source(fmt, tmp_path)
    got, got_name = PT.load_ti_embedding(source)
    ref, ref_name = JT.load_ti_embedding(source)
    assert got_name == ref_name and set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], ref[key])


def test_bad_layouts_are_refused():
    arr = _rows()
    for mod in (PT, JT):
        with pytest.raises(ValueError, match="differ"):
            mod.load_ti_embedding({"clip_l": arr, "clip_g": arr[:2]})
        with pytest.raises(ValueError, match="unrecognized"):
            mod.load_ti_embedding({"a": arr, "b": arr})
        with pytest.raises(ValueError, match=r"\(n, dim\)"):
            mod.load_ti_embedding(np.zeros((1, 2, 3), np.float32))


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """Both packages' tiny tokenizers with the same placeholders: one that
    prefixes another, registered shortest first."""
    d = tmp_path_factory.mktemp("tok")
    jax_tok = tiny_tokenizer(d)
    port_tok = CLIPTokenizer.from_pretrained_dir(d)
    for tok in (jax_tok, port_tok):
        tok.add_placeholder("<thing>", [VOCAB, VOCAB + 1, VOCAB + 2])
        tok.add_placeholder("<thing>x", [VOCAB + 3])
    return jax_tok, port_tok


@pytest.mark.parametrize("prompt", ["a <THING> cat", "<thing>x", "a <thing>x and <thing> dog",
                                    "cats<thing>dogs", "a cat"])
def test_placeholder_ids_match_jax(tokenizers, prompt):
    jax_tok, port_tok = tokenizers
    assert port_tok.encode(prompt) == jax_tok.encode(prompt)
    np.testing.assert_array_equal(port_tok.tokenize(prompt)[0], jax_tok.tokenize(prompt)[0])
    assert port_tok.added_placeholders == jax_tok.added_placeholders


@pytest.mark.parametrize("prompt", ["a (<thing>:1.3) cat", "[<thing>x] " + "cat " * 80])
def test_placeholders_expand_in_weighted_windows_as_in_jax(tokenizers, prompt):
    jax_tok, port_tok = tokenizers
    got, ref = weighted_token_chunks(port_tok, prompt), jax_weighted_token_chunks(jax_tok, prompt)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    assert VOCAB + 3 in got[0] or VOCAB in got[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extended_table_matches_jax(dtype):
    """The grown table against the JAX one grown in leaves of the same
    dtype: the rows rounded to it once, the rest as it was."""
    import jax

    model, params = tiny_text_encoder()
    rows = _rows(2)
    port = _load(CLIPTextEncoder, CLIPTextConfig, model, params, clip_text_state_dict)
    port = port.to(getattr(torch, dtype))
    PT.extend_token_embedding(port, rows)
    jax_model, jax_params = JT.extend_token_embedding(
        model, jax.tree.map(lambda a: a.astype(dtype), params), rows)
    assert port.config == CLIPTextConfig(**dataclasses.asdict(jax_model.config))
    assert port.config.vocab_size == VOCAB + 2
    table = port.text_model.embeddings.token_embedding.weight
    assert table.dtype == getattr(torch, dtype) and tuple(table.shape) == (VOCAB + 2, CTX_DIM)
    want = np.array(jax_params["token_embedding"]["embedding"], np.float32)
    assert torch.equal(table.float(), torch.from_numpy(want))
    with pytest.raises(ValueError, match="hidden size"):
        PT.extend_token_embedding(port, rows[:, :10])


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return pipelines(tmp_path_factory.mktemp("sd"), weight_seed=21)


def _kw(prompt):
    return dict(prompt=prompt, negative_prompt="blurry", step_count=2,
                scheduler="DPMSolverMultistep", guidance_scale=7.5, seed=9,
                disable_safety=True, rng="numpy")


def test_sd_generation_with_placeholder_matches_jax(pair, tmp_path):
    """A file embedding under its default token ``<style>`` in both
    pipelines: the same ids, the same record, latents within 1e-3."""
    jax_pipe, port_pipe = pair
    path = tmp_path / "style.safetensors"
    save_file({"emb_params": _rows(2, seed=5) * 0.5}, path)
    ids = port_pipe.load_textual_inversion(path)
    assert ids == jax_pipe.load_textual_inversion(path) == [VOCAB, VOCAB + 1]
    assert port_pipe.textual_inversions == jax_pipe.textual_inversions == [("<style>", 2)]
    kw = _kw("a <style> cat")
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW).latents
    got = port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW).latents
    np.testing.assert_allclose(got, ref, atol=1e-3)
    plain = port_pipe.generate_images(PipelineConfiguration(**_kw("a cat")), image_hw=HW)
    assert np.abs(got - plain.latents).max() > 1e-4
    with pytest.raises(ValueError, match="token="):
        port_pipe.load_textual_inversion(_rows(1))


def test_word_equivalence_witness(pair):
    """A placeholder whose vectors are the embedding rows of a word's tokens
    gives the latents of that word bit for bit; a prompt without it is
    untouched by the grown table."""
    _, port_pipe = pair
    before = port_pipe.generate_images(PipelineConfiguration(**_kw("a cat")), image_hw=HW)
    word_ids = port_pipe.tokenizer.encode("dog")  # a letters vocabulary: 3 tokens
    table = port_pipe.text_encoder.text_model.embeddings.token_embedding.weight
    rows = table[torch.tensor(word_ids)].detach().numpy()
    port_pipe.load_textual_inversion(rows, token="<pup>")
    a = port_pipe.generate_images(PipelineConfiguration(**_kw("a <pup> on mars")), image_hw=HW)
    b = port_pipe.generate_images(PipelineConfiguration(**_kw("a dog on mars")), image_hw=HW)
    np.testing.assert_array_equal(a.latents, b.latents)
    after = port_pipe.generate_images(PipelineConfiguration(**_kw("a cat")), image_hw=HW)
    np.testing.assert_array_equal(before.latents, after.latents)


@pytest.mark.parametrize("family", ["sdxl", "sd3"])
def test_dual_encoders_need_both_vectors(family, tmp_path):
    """A CLIP-L-only embedding is refused by both packages; a ``clip_l`` /
    ``clip_g`` one grows both tables (the same rows as JAX's) and both
    tokenizations match the JAX pipeline's."""
    jax_pipe, port_pipe = (sdxl_pipelines if family == "sdxl" else sd3_pipelines)(tmp_path)
    for pipe in (jax_pipe, port_pipe):
        with pytest.raises(ValueError, match="clip_g"):
            pipe.load_textual_inversion(_rows(1), token="<x>")
    dual = {"clip_l": _rows(2, seed=3), "clip_g": _rows(2, seed=4)}
    assert port_pipe.load_textual_inversion(dual, token="<y>") == \
        jax_pipe.load_textual_inversion(dual, token="<y>") == [VOCAB, VOCAB + 1]
    for enc, params in ((port_pipe.text_encoder, jax_pipe.text_encoder_params),
                        (port_pipe.text_encoder2, jax_pipe.text_encoder2_params)):
        assert enc.config.vocab_size == VOCAB + 2
        want = np.asarray(params["token_embedding"]["embedding"])
        np.testing.assert_array_equal(
            enc.text_model.embeddings.token_embedding.weight.detach().numpy(), want)
    kw = dict(prompt="a <Y> cat", negative_prompt="<y>", disable_safety=True)
    got, ref = port_pipe._tokenize(PipelineConfiguration(**kw)), jax_pipe._tokenize(JaxConfig(**kw))
    for key in ("ids", "ids2"):
        np.testing.assert_array_equal(got[key], ref[key])
        assert VOCAB + 1 in got[key]
