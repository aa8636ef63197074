"""The port's native host libraries (``native/*.cpp`` through ctypes,
``ml_stable_diffusion_torch/utils/native.py``), built here with make and g++
into a temporary ``BUILD`` directory: the C++ BPE tokenizer's ids equal the
port's Python tokenizer's and the JAX native tokenizer's (loading the same
library) on a mixed corpus; the image converter equals its numpy rule; the
C++ unigram Viterbi equals the Python segmentation on tests/test_torch_t5.py's
synthetic files; the C++ safetensors header parser equals the Python parse;
and a failed build falls back to the Python paths with equal outputs."""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import json
import random

import numpy as np
import pytest
import torch

from ml_stable_diffusion_tpu.tokenizer import native as jax_native

from ml_stable_diffusion_torch.convert import native_io
from ml_stable_diffusion_torch.tokenizer import CLIPTokenizer
from ml_stable_diffusion_torch.tokenizer.native import NativeCLIPTokenizer, load_tokenizer
from ml_stable_diffusion_torch.tokenizer.t5 import T5Tokenizer
from ml_stable_diffusion_torch.utils import image, native
from ml_stable_diffusion_torch.utils.native_image import (
    denormalize_to_uint8_native,
    uint8_to_float_native,
)

from test_native_tokenizer import PROMPTS as BPE_PROMPTS
from test_native_tokenizer import vocab_dir  # noqa: F401  (fixture)
from test_torch_t5 import TEXTS as T5_TEXTS
from test_torch_t5 import tokenizer_json  # noqa: F401  (fixture)

CORPUS = BPE_PROMPTS + [
    "Ä cat's hello", "naïve café", "HeLLo WoRLD", "hello\tworld\n", "  padded  ",
    "a (weighted:1.2) hello", "123 hello 456", "x" * 600, "hello <thing> world",
    "hello <THING> world",
]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The four libraries built into a fresh directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_DIR", tmp_path_factory.mktemp("native") / "build")
        assert native.build_native() is not None
        assert native.build_seconds is not None and native.build_seconds > 0
        yield native.BUILD_DIR


@pytest.fixture
def broken(tmp_path, monkeypatch):
    """A build that fails: a fresh build directory and no sources."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path / "no-sources")
    monkeypatch.setattr(native, "build_failed", False)


def test_build_goes_to_its_build_dir(built):
    assert sorted(p.name for p in built.iterdir()) == sorted(
        f"libsdtpu_{n}.so" for n in native.LIBRARIES)


def test_bpe_ids_equal_python_and_jax_native(built, vocab_dir, monkeypatch):  # noqa: F811
    monkeypatch.setattr(jax_native, "_LIB_PATH", native.lib_path("bpe"))
    py = CLIPTokenizer.from_pretrained_dir(vocab_dir)
    nat = load_tokenizer(vocab_dir)
    ref = jax_native.NativeCLIPTokenizer(vocab_dir / "vocab.json", vocab_dir / "merges.txt")
    assert isinstance(nat, NativeCLIPTokenizer)
    for tok in (py, nat, ref):
        tok.add_placeholder("<thing>", [5, 6])
    for text in CORPUS:
        want = py.encode(text)
        assert nat.encode(text) == want, text
        assert ref.encode(text) == want[:512], text  # the JAX binding stops at 512 ids
        for a, b in zip(nat.tokenize(text), py.tokenize(text)):
            np.testing.assert_array_equal(a, b)
    ascii_plain = [t for t in CORPUS if t.isascii() and "<thing>" not in t.lower()]
    assert nat.native_calls >= len(ascii_plain)
    assert (nat.bos_id, nat.eos_id, nat.pad_id) == (py.bos_id, py.eos_id, py.pad_id)


def test_image_conversion_equals_numpy(built):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1.2, 1.2, (1, 512, 512, 3)).astype(np.float32)
    x[0, 0, :8, 0] = [-np.inf, np.inf, -1.0, 1.0, 0.0, -0.0, 2.0, np.nan]
    got = denormalize_to_uint8_native(x)
    np.testing.assert_array_equal(got, image.denormalize_to_uint8_numpy(x))
    np.testing.assert_array_equal(image.denormalize_to_uint8(x), got)
    # np.round's halves to even: the rules part on a few of a million values
    finite = np.isfinite(x)
    half_even = (np.clip(x[finite] / 2.0 + 0.5, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    assert np.abs(got[finite].astype(int) - half_even).max() <= 1
    u = rng.randint(0, 256, (7, 5), dtype=np.uint8)
    for lo, hi in ((-1.0, 1.0), (0.0, 1.0)):
        scale = np.float32(np.float32(hi) - np.float32(lo)) / np.float32(255.0)
        np.testing.assert_array_equal(uint8_to_float_native(u, lo, hi),
                                      u.astype(np.float32) * scale + np.float32(lo))


def test_unigram_ids_equal_python(built, tokenizer_json):  # noqa: F811
    nat = T5Tokenizer(tokenizer_json)
    py = T5Tokenizer(tokenizer_json, prefer_native=False)
    assert nat.uses_native and not py.uses_native
    rng = random.Random(1)
    words = ["hello", "world", "the", "cat's", "a", "photo", "of", "running,", "x", "123",
             "mars", "(parens)", "é", "double  space", "</s>"]
    fuzz = [" ".join(rng.choice(words) for _ in range(rng.randint(1, 12)))
            for _ in range(200)]
    for text in T5_TEXTS + fuzz:
        assert nat.encode(text) == py.encode(text), repr(text)
        for a, b in zip(nat.tokenize(text), py.tokenize(text)):
            np.testing.assert_array_equal(a, b)
    assert nat.native_calls > 100


def test_unigram_duplicate_pieces_take_the_last_id(built, tmp_path):
    """A piece listed twice (as a letter and as a one-letter word, say):
    ``tokenizers`` keeps its last id and score, and so must the native
    path."""
    from ml_stable_diffusion_tpu.tokenizer.t5 import T5Tokenizer as JaxT5Tokenizer

    from test_native_t5 import _unigram_json

    path = _unigram_json(tmp_path)
    spec = json.loads(path.read_text())
    spec["model"]["vocab"] += [["\u2581a", -0.5], ["\u2581hello", -9.0], ["lo", -0.2]]
    path.write_text(json.dumps(spec))
    nat, py = T5Tokenizer(path), T5Tokenizer(path, prefer_native=False)
    assert nat.uses_native
    ref = JaxT5Tokenizer(path, prefer_native=False)
    for text in ("a photo of a cat", "hello world", "a lo hello", "x a y"):
        assert nat.encode(text) == py.encode(text) == ref.encode(text), text
    assert nat.native_calls == 4


def _tensors():
    rng = np.random.RandomState(0)
    return {
        "a.weight": torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
        "a.bias": torch.from_numpy(rng.randn(7).astype(np.float16)),
        "b/idx": torch.from_numpy(rng.randint(0, 255, (11,)).astype(np.uint8)),
        "b/counts": torch.from_numpy(rng.randint(-9, 9, (2, 3)).astype(np.int64)),
        "c.bf": torch.from_numpy(rng.randn(4, 4).astype(np.float32)).to(torch.bfloat16),
        "c.flag": torch.tensor([True, False, True]),
        "d.scalar": torch.tensor(2.5),
        "d.empty": torch.zeros(0, 4),
        'e."quoted"\\name': torch.ones(2, dtype=torch.int32),
    }


def test_header_parse_equals_python(built, tmp_path):
    tensors = _tensors()
    native_io.save_file(tensors, tmp_path / "t.safetensors", metadata={"format": "pt"})
    got = native_io.parse_table(tmp_path / "t.safetensors", native=True)
    want = native_io.parse_table(tmp_path / "t.safetensors", native=False)
    assert got[0] == want[0] and sorted(got[1]) == sorted(want[1])
    loaded = native_io.load_file(tmp_path / "t.safetensors")  # the native parse: built
    assert set(loaded) == set(tensors)
    for k, v in tensors.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k
    # both refuse a span past the end of the file
    blob = json.dumps({"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 64]}}).encode()
    (tmp_path / "bad.safetensors").write_bytes(len(blob).to_bytes(8, "little") + blob
                                               + bytes(16))
    for flag in (True, False):
        with pytest.raises(ValueError):
            native_io.parse_table(tmp_path / "bad.safetensors", native=flag)


def test_failed_build_falls_back_with_equal_outputs(broken, tmp_path, vocab_dir,  # noqa: F811
                                                    tokenizer_json):  # noqa: F811
    assert native.build_native() is None
    with pytest.raises(OSError):
        native.load_library("bpe")
    tok = load_tokenizer(vocab_dir)
    assert isinstance(tok, CLIPTokenizer)
    with pytest.raises(OSError):
        NativeCLIPTokenizer(vocab_dir / "vocab.json", vocab_dir / "merges.txt")
    py = CLIPTokenizer.from_pretrained_dir(vocab_dir)
    assert [tok.encode(t) for t in CORPUS] == [py.encode(t) for t in CORPUS]
    t5 = T5Tokenizer(tokenizer_json)
    assert not t5.uses_native
    assert t5.encode("hello world") == T5Tokenizer(tokenizer_json,
                                                   prefer_native=False).encode("hello world")
    x = np.random.RandomState(2).uniform(-1.2, 1.2, (2, 33, 17, 3)).astype(np.float32)
    np.testing.assert_array_equal(image.denormalize_to_uint8(x),
                                  image.denormalize_to_uint8_numpy(x))
    native_io.save_file(_tensors(), tmp_path / "t.safetensors")
    loaded = native_io.load_file(tmp_path / "t.safetensors")
    assert all(torch.equal(loaded[k], v) for k, v in _tensors().items())
    with pytest.raises(OSError):
        native_io.parse_table(tmp_path / "t.safetensors", native=True)
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").glob("*.so"))


def test_failed_build_is_not_tried_again(broken, monkeypatch):
    """After a failed build the process neither runs ``make`` again nor
    logs again, until a forced build."""
    calls = []
    real = native.subprocess.run
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    assert native.build_native() is None and len(calls) == 1 and native.build_failed
    assert native.build_native() is None
    with pytest.raises(OSError):
        native.load_library("image")
    x = np.linspace(-1.5, 1.5, 64, dtype=np.float32).reshape(1, 4, 16, 1)
    np.testing.assert_array_equal(image.denormalize_to_uint8(x),
                                  image.denormalize_to_uint8_numpy(x))
    assert len(calls) == 1
    assert native.build_native(force=True) is None and len(calls) == 2
