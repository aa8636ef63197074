"""The port's T5 tokenizer and T5 encoder against the JAX package's, on the
CPU.

Tokenizer: the port parses ``tokenizer.json`` itself (no ``tokenizers``);
its ids and masks must equal the JAX ``T5Tokenizer``'s exactly, with and
without the JAX native fast path, on tests/test_native_t5.py's synthetic
unigram file and on a second one with the SpmConverter normalizer
``Sequence[Precompiled, Strip(right), Replace(" {2,}", "▁")]`` whose
``precompiled_charsmap`` is a darts-clone blob built here (the JAX tokenizer
loading it shows ``tokenizers`` accepts it).

Encoder: a tiny ``transformers.T5EncoderModel`` state dict loads strictly
into the port and, through ``port_t5_encoder``, into the Flax module; with
ragged masks the unmasked rows agree to 1e-5 in float32, and within a
stated bf16 tolerance with the port's bf16 weights (its bias table float32)
against Flax ``dtype=bfloat16`` on float32 params.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import base64
import json
import random
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import transformers

from ml_stable_diffusion_tpu.convert.t5 import port_t5_encoder
from ml_stable_diffusion_tpu.models.t5 import T5Config as JaxT5Config
from ml_stable_diffusion_tpu.models.t5 import T5Encoder as JaxT5Encoder
from ml_stable_diffusion_tpu.models.t5 import relative_position_buckets as jax_buckets
from ml_stable_diffusion_tpu.tokenizer.t5 import T5Tokenizer as JaxT5Tokenizer

from ml_stable_diffusion_torch.convert.from_jax import t5_state_dict
from ml_stable_diffusion_torch.models.t5 import (
    T5Config,
    T5Encoder,
    hf_state_dict,
    relative_position_buckets,
)
from ml_stable_diffusion_torch.tokenizer.t5 import T5Tokenizer, graphemes

from test_native_t5 import PROMPTS, _unigram_json
from test_torch_models import _layout


def darts_charsmap(mapping: dict[str, str]) -> str:
    """{source: replacement} -> a base64 ``precompiled_charsmap``: a u32
    trie size, a darts-clone double array over the sources' UTF-8 bytes (a
    node's children at ``base ^ label``, its value under label 0 with bit
    31 set, unique bases), then the NUL-terminated replacements."""
    normalized, root = b"", {}
    for src, dst in mapping.items():
        node = root
        for b in src.encode():
            node = node.setdefault(b, {})
        node[None] = len(normalized)
        normalized += dst.encode() + b"\0"
    units, bases, queue = {0: 0}, set(), [(0, root)]
    while queue:
        pos, node = queue.pop(0)
        labels = [0 if k is None else k for k in node]
        base = 1
        while base in bases or any(base ^ c in units or base ^ c == 0 for c in labels):
            base += 1
        bases.add(base)
        units[pos] |= (pos ^ base) << 10  # the offset, below 2**21 here
        for k, child in node.items():
            if k is None:
                units[pos] |= 1 << 8  # has a leaf
                units[base] = child | (1 << 31)
            else:
                units[base ^ k] = k  # the label
                queue.append((base ^ k, child))
    size = (max(units) | 0xFF) + 1
    blob = struct.pack(f"<I{size}I", 4 * size, *(units.get(i, 0) for i in range(size)))
    return base64.b64encode(blob + normalized).decode()


#: fullwidth A, the ideographic space, the fi ligature, fullwidth X; "ab"
#: is never reached (a lookup takes the shortest match, "a")
CHARSMAP = {"Ａ": "A", "　": " ", "ﬁ": "fi", "Ｘ": "X", "a": "a", "ab": "Y"}
SPM_NORMALIZER = {"type": "Sequence", "normalizers": [
    {"type": "Precompiled", "precompiled_charsmap": darts_charsmap(CHARSMAP)},
    {"type": "Strip", "strip_left": False, "strip_right": True},
    {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "▁"}]}

TEXTS = PROMPTS + [
    "café au lait", "naïve ñandú 漢字", "~", "a ~~ b", "~é~", "double  space",
    "triple   space", " lead", "trail ", "  both  ", "end</s>now", "</s>", "a </s> b",
    "<pad><unk>", "tab\tchar", "new\nline", "Ａ photo ﬁx", "Ｘ　Ａ́b", "é",
    "\U0001F600 cat", "ab abc",
]


@pytest.fixture(scope="module", params=["plain", "precompiled"])
def tokenizer_json(request, tmp_path_factory):
    path = _unigram_json(tmp_path_factory.mktemp(f"t5-{request.param}"),
                         extra_pieces=("A", "fi", "X", "Y", "▁A", "▁▁"))
    if request.param == "precompiled":
        spec = json.loads(path.read_text())
        spec["normalizer"] = SPM_NORMALIZER
        path.write_text(json.dumps(spec))
    return path


@pytest.mark.parametrize("prefer_native", [True, False])
def test_tokenizer_ids_and_mask_equal_jax(tokenizer_json, prefer_native):
    ref = JaxT5Tokenizer(tokenizer_json, prefer_native=prefer_native)
    port = T5Tokenizer(tokenizer_json)
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text), text
        for max_length in (77, 6):  # 6 truncates most texts so EOS survives
            got, want = port.tokenize(text, max_length), ref.tokenize(text, max_length)
            for g, w in zip(got, want):
                assert g.dtype == np.int32 and g.shape == (max_length,)
                np.testing.assert_array_equal(g, w, err_msg=text)


def test_tokenizer_fuzz_equals_jax(tokenizer_json):
    """300 random strings over ASCII, specials, spaces, combining marks and
    uncovered characters."""
    ref = JaxT5Tokenizer(tokenizer_json, prefer_native=False)
    port = T5Tokenizer(tokenizer_json)
    alphabet = list("abcdefghlorstw  .,'!?") + [
        "</s>", "<pad>", "é", "é", "Ａ", "Ａ́", "　", "ﬁ", "~", "\t", "Ｘ", "漢",
        "\U0001F468‍\U0001F469", "\r\n", "\x1c", "가"]
    rng = random.Random(0)
    for _ in range(300):
        text = "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 20)))
        assert port.encode(text) == ref.encode(text), repr(text)


def test_tokenizer_defaults_and_truncation(tokenizer_json):
    port = T5Tokenizer(tokenizer_json)
    assert (port.eos_id, port.pad_id) == (1, 0)
    ids, mask = port.tokenize("hello world " * 20, max_length=10)
    assert ids[-1] == 1 and mask.tolist() == [1] * 10
    ids, mask = port.tokenize("", max_length=4)
    assert ids.tolist() == [1, 0, 0, 0] and mask.tolist() == [1, 0, 0, 0]


@pytest.mark.parametrize("field,value,match", [
    ("normalizer", {"type": "NFKC"}, "NFKC"),
    ("normalizer", {"type": "Sequence", "normalizers": [{"type": "Lowercase"}]}, "Lowercase"),
    ("pre_tokenizer", {"type": "ByteLevel"}, "ByteLevel"),
    ("pre_tokenizer", {"type": "Metaspace", "replacement": "▁", "add_prefix_space": False},
     "add_prefix_space"),
    ("truncation", {"max_length": 8}, "truncation"),
])
def test_tokenizer_refuses_what_it_does_not_port(tmp_path, field, value, match):
    path = _unigram_json(tmp_path)
    spec = json.loads(path.read_text())
    spec[field] = value
    path.write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=match):
        T5Tokenizer(path)


def test_graphemes_keep_marks_and_joiners_with_their_base():
    assert graphemes("éa\r\nb") == ["é", "a", "\r\n", "b"]
    assert graphemes("\U0001F468‍\U0001F469!") == ["\U0001F468‍\U0001F469", "!"]
    assert graphemes("각x") == ["각", "x"]


# -- the encoder ---------------------------------------------------------------------

TINY = dict(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=3, num_heads=4)


@pytest.fixture(scope="module")
def t5_weights():
    """(a tiny transformers T5EncoderModel's state dict, the Flax params
    ported from it)."""
    tcfg = transformers.T5Config(**TINY, feed_forward_proj="gated-gelu",
                                 is_encoder_decoder=False, use_cache=False,
                                 tie_word_embeddings=False)
    torch.manual_seed(0)
    sd = transformers.T5EncoderModel(tcfg).eval().state_dict()
    return sd, port_t5_encoder(sd, JaxT5Config(**TINY))


def _inputs():
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 500, size=(3, 19)).astype(np.int64)
    mask = np.ones((3, 19), np.int64)
    mask[1, 12:] = 0
    mask[2, 5:] = 0
    return ids, mask


def _port(sd, dtype=torch.float32):
    model = T5Encoder(T5Config(**TINY))
    model.load_state_dict(hf_state_dict(sd), strict=True)
    return model.to(dtype).eval()


@pytest.mark.parametrize("dtype,atol,rel_rms", [
    (torch.float32, 1e-5, None),
    # bf16: one bf16 step of the outputs (|x| < 4 here); the two agree bit
    # for bit on this CPU, both rounding the same f32 products
    (torch.bfloat16, 1.6e-2, 1e-3),
])
def test_encoder_matches_flax(t5_weights, dtype, atol, rel_rms):
    sd, params = t5_weights
    ids, mask = _inputs()
    model = _port(sd, dtype)
    table = model.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
    assert table.dtype == torch.float32
    assert model.encoder.block[1].layer[1].DenseReluDense.wo.weight.dtype == dtype
    flax = JaxT5Encoder(JaxT5Config(**TINY),
                        dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    ref = np.asarray(flax.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))[
        "encoder_hidden_states"]).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))["encoder_hidden_states"]
    assert got.dtype == dtype and got.shape == (3, 19, 64)
    keep = mask.astype(bool)
    got, ref = got.float().numpy()[keep], ref[keep]
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    if rel_rms is not None:
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= rel_rms


def test_t5_state_dict_carries_the_flax_params(t5_weights):
    """The Flax tree through ``convert.from_jax.t5_state_dict`` loads
    strictly and gives the HF-loaded module's outputs bit for bit."""
    sd, params = t5_weights
    ids, mask = _inputs()
    model = T5Encoder(T5Config(**TINY))
    model.load_state_dict(t5_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))["encoder_hidden_states"]
        want = _port(sd)(torch.from_numpy(ids), torch.from_numpy(mask))["encoder_hidden_states"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("S", [77, 154, 512])
def test_relative_position_buckets_equal_jax(S):
    np.testing.assert_array_equal(relative_position_buckets(S, S, 32, 128),
                                  jax_buckets(S, S, 32, 128))


def test_xxl_layout_loads():
    """``T5Config.xxl()`` is the JAX configuration, and every converted key of
    the full-size Flax encoder exists in the port's module with the
    converted shape, nothing missing, from abstract shapes only."""
    import dataclasses

    assert dataclasses.asdict(T5Config.xxl()) == dataclasses.asdict(JaxT5Config.xxl())
    ids = jnp.zeros((1, 77), jnp.int32)
    layout = _layout(JaxT5Encoder(JaxT5Config.xxl()), (ids, ids), t5_state_dict)
    with torch.device("meta"):
        port = T5Encoder(T5Config.xxl())
    assert layout == {k: tuple(v.shape) for k, v in port.state_dict().items()}
    n = sum(p.numel() for p in port.parameters())
    assert 4.7e9 < n < 4.8e9, n  # 4.76 B parameters
