"""Port tokenizer and host random sources against the JAX package.

The port's tokenizer splits words with the standard library's ``re``; the
JAX one with the ``regex`` module.  Both must give the same ids, non-ASCII
prompts included.  The host noise sources must give bit-identical arrays.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest

from ml_stable_diffusion_tpu.tokenizer import CLIPTokenizer as JaxTokenizer
from ml_stable_diffusion_tpu.utils.rng import make_random_source as jax_source

from ml_stable_diffusion_torch.tokenizer import CLIPTokenizer
from ml_stable_diffusion_torch.utils.rng import make_random_source

from test_tokenizer import NON_ASCII_PROMPTS, _byte_level_vocab_files, _toy_vocab_files

PROMPTS = NON_ASCII_PROMPTS + [
    "a photo of an astronaut riding a horse on mars",
    "Hello World, it's 4K!! they'll've 2024",
    "café ² ½ Ⅻ naïve 東京 😀 x",          # numbers outside Nd split alone
    "tabs\tand\nnewlines  and　ideographic space",
    "control\x1cseparators\x1fare not spaces",
    "&amp;lt;b&amp;gt; html",
    "",
]


@pytest.mark.parametrize("files", [_byte_level_vocab_files, _toy_vocab_files])
def test_tokenizer_ids_match_jax(files, tmp_path):
    d = files(tmp_path)
    port, ref = CLIPTokenizer.from_pretrained_dir(d), JaxTokenizer.from_pretrained_dir(d)
    for text in PROMPTS:
        ids, n = port.tokenize(text)
        ref_ids, ref_n = ref.tokenize(text)
        assert ids.tolist() == ref_ids.tolist(), text
        assert n == ref_n
        assert port.decode(ids) == ref.decode(ref_ids), text


@pytest.mark.parametrize("kind", ["numpy", "torch", "nvidia"])
def test_host_sources_match_jax(kind):
    port, ref = make_random_source(kind, 93), jax_source(kind, 93)
    for shape in [(1, 4, 8, 8), (2, 4, 64, 64)]:  # consecutive draws
        np.testing.assert_array_equal(port.normal(shape), ref.normal(shape))


def test_jax_stream_is_rejected():
    with pytest.raises(ValueError, match="jax.random"):
        make_random_source("jax", 0)
