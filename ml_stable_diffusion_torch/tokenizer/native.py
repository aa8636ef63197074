"""The native C++ CLIP BPE tokenizer (``native/bpe``) through ctypes (port of
ml_stable_diffusion_tpu/tokenizer/native.py).

``NativeCLIPTokenizer`` has ``tokenizer/bpe.py:CLIPTokenizer``'s surface and
gives its ids.  The C++ path lowercases ASCII only, so a prompt with any
non-ASCII character, or one holding a textual-inversion placeholder, goes to
the Python tokenizer it wraps.  ``load_tokenizer`` prefers the native
tokenizer and falls back to the Python one when the library cannot be built
(``utils/native.py``); constructing ``NativeCLIPTokenizer`` raises instead.
"""

from __future__ import annotations

import ctypes
import logging
from pathlib import Path

import numpy as np

from ..utils.native import load_library

logger = logging.getLogger(__name__)


def _load_lib():
    lib = load_library("bpe")
    lib.sdtpu_bpe_create.restype = ctypes.c_void_p
    lib.sdtpu_bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.sdtpu_bpe_error.restype = ctypes.c_char_p
    lib.sdtpu_bpe_error.argtypes = [ctypes.c_void_p]
    lib.sdtpu_bpe_destroy.restype = None
    lib.sdtpu_bpe_destroy.argtypes = [ctypes.c_void_p]
    lib.sdtpu_bpe_bos.restype = ctypes.c_int32
    lib.sdtpu_bpe_bos.argtypes = [ctypes.c_void_p]
    lib.sdtpu_bpe_eos.restype = ctypes.c_int32
    lib.sdtpu_bpe_eos.argtypes = [ctypes.c_void_p]
    lib.sdtpu_bpe_encode.restype = ctypes.c_int32
    lib.sdtpu_bpe_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    return lib


class NativeCLIPTokenizer:
    """``CLIPTokenizer``'s surface (``encode``, ``tokenize``, placeholders;
    any other attribute is the Python tokenizer's) on the C++ encoder."""

    def __init__(self, vocab_path, merges_path, pad_token_id: int | None = None,
                 fallback=None):
        self._lib = _load_lib()
        self._handle = self._lib.sdtpu_bpe_create(str(vocab_path).encode(),
                                                  str(merges_path).encode())
        err = self._lib.sdtpu_bpe_error(self._handle)
        if err:
            raise RuntimeError(f"native tokenizer: {err.decode()}")
        self.bos_id = self._lib.sdtpu_bpe_bos(self._handle)
        self.eos_id = self._lib.sdtpu_bpe_eos(self._handle)
        self.pad_id = self.eos_id if pad_token_id is None else pad_token_id
        if fallback is None:
            from .bpe import CLIPTokenizer

            fallback = CLIPTokenizer.from_pretrained_dir(Path(vocab_path).parent)
        self._fallback = fallback
        #: prompts the C++ encoder tokenized (the rest went to Python)
        self.native_calls = 0

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.sdtpu_bpe_destroy(self._handle)
            self._handle = None

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._fallback, name)

    def add_placeholder(self, token: str, ids):
        """A textual-inversion placeholder: prompts holding one go to the
        Python tokenizer."""
        self._fallback.add_placeholder(token, ids)

    @property
    def added_placeholders(self):
        return self._fallback.added_placeholders

    def encode(self, text: str) -> list[int]:
        if not text.isascii():
            return self._fallback.encode(text)
        placeholders = self._fallback.added_placeholders
        if placeholders and any(k in text.lower() for k in placeholders):
            return self._fallback.encode(text)
        raw = text.encode("utf-8")
        # a piece holds one byte or more: room for every id (the JAX
        # binding's 512 cut longer prompts short)
        buf = (ctypes.c_int32 * (len(raw) + 1))()
        n = self._lib.sdtpu_bpe_encode(self._handle, raw, buf, len(raw) + 1)
        self.native_calls += 1
        return list(buf[:n])

    def tokenize(self, text: str, max_length: int = 77, pad_to_max: bool = True):
        ids = [self.bos_id] + self.encode(text)
        ids = ids[: max_length - 1] + [self.eos_id]
        true_len = len(ids)
        if pad_to_max:
            ids = ids + [self.pad_id] * (max_length - len(ids))
        return np.asarray(ids, dtype=np.int32), true_len


def load_tokenizer(directory, pad_token: str = "<|endoftext|>", prefer_native: bool = True):
    """A tokenizer directory (``vocab.json``, ``merges.txt``) -> the native
    tokenizer where it builds, else the Python one."""
    from .bpe import CLIPTokenizer

    directory = Path(directory)
    py = CLIPTokenizer.from_pretrained_dir(directory, pad_token=pad_token)
    if not prefer_native:
        return py
    try:
        return NativeCLIPTokenizer(directory / "vocab.json", directory / "merges.txt",
                                   pad_token_id=py.pad_id, fallback=py)
    except (RuntimeError, OSError) as e:
        logger.info("falling back to the Python tokenizer: %s", e)
        return py
