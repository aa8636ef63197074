"""CLIP byte-pair-encoding tokenizer (port of
ml_stable_diffusion_tpu/tokenizer/bpe.py).

The same algorithm over the standard ``vocab.json`` + ``merges.txt``
artifacts: html unescape, whitespace collapse and lowercase, regex word
splitting, per-word lowest-rank pair merging with an end-of-word ``</w>``
marker, then vocabulary lookup with ``<|startoftext|>`` / ``<|endoftext|>``
specials and padding with the end-of-text token.

The JAX package splits words with the third-party ``regex`` module's
``\\p{L}`` / ``\\p{N}`` classes.  This copy uses the standard library's
``re``, with the letter and number classes built from ``unicodedata``
categories (L* and N*) on first use, and whitespace spelled out as the
``regex`` module's ``\\s`` (the standard ``\\s`` also matches U+001C-U+001F).
The two agree on every character that Python's Unicode database knows;
characters assigned in later Unicode versions than that database's may
split differently.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import re
import sys
import unicodedata
from pathlib import Path

import numpy as np

#: the ``regex`` module's ``\s``: Unicode White_Space
_WS = r"\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
_WHITESPACE = re.compile(f"[{_WS}]+")


def _category_class(prefix: str) -> str:
    """Character-class body of every code point whose general category
    starts with ``prefix``, as ranges."""
    parts = []
    start = prev = None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            parts.append(f"\\U{start:08x}" if start == prev
                         else f"\\U{start:08x}-\\U{prev:08x}")
            start = None
    if start is not None:
        parts.append(f"\\U{start:08x}-\\U{prev:08x}")
    return "".join(parts)


@functools.cache
def _word_pattern() -> re.Pattern:
    """CLIP's word-splitting pattern (also transformers' CLIPTokenizer)."""
    letters, numbers = _category_class("L"), _category_class("N")
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        f"|[{letters}]+|[{numbers}]|[^{_WS}{letters}{numbers}]+",
        re.IGNORECASE,
    )


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = _WHITESPACE.sub(" ", text)
    return text.strip().lower()


@functools.cache
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP byte<->unicode table: every UTF-8 byte maps to a printable
    unicode char, so BPE runs over bytes and non-ASCII text tokenizes
    exactly like the ecosystem vocab/merges."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.cache
def unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


def _pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


class CLIPTokenizer:
    """CLIP BPE tokenizer over vocab.json + merges.txt: ``tokenize`` pads or
    truncates to a fixed length, ``decode`` inverts it."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 pad_token: str = "<|endoftext|>"):
        self.vocab = dict(vocab)
        self.decoder = {v: k for k, v in self.vocab.items()}
        self.merge_ranks = {m: i for i, m in enumerate(merges)}
        self.bos_token = "<|startoftext|>"
        self.eos_token = "<|endoftext|>"
        self.bos_id = self.vocab[self.bos_token]
        self.eos_id = self.vocab[self.eos_token]
        self.pad_id = self.vocab[pad_token]
        self._cache: dict[str, list[str]] = {}
        #: textual-inversion placeholders: lowercased token -> the ids it
        #: expands to (rows of a token-embedding table grown past the vocab)
        self.added_placeholders: dict[str, list[int]] = {}
        self._added_re = None

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_files(cls, vocab_path: str | Path, merges_path: str | Path,
                   pad_token: str = "<|endoftext|>") -> "CLIPTokenizer":
        """Load the standard artifacts.  merges.txt may have a ``#version``
        header line (skipped) and may be gzipped."""
        vocab_path, merges_path = Path(vocab_path), Path(merges_path)
        vocab = json.loads(vocab_path.read_text())
        opener = gzip.open if merges_path.suffix == ".gz" else open
        with opener(merges_path, "rt") as f:
            lines = f.read().splitlines()
        if lines and lines[0].startswith("#"):
            lines = lines[1:]
        merges = []
        for line in lines:
            parts = line.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        return cls(vocab, merges, pad_token=pad_token)

    @classmethod
    def from_pretrained_dir(cls, path: str | Path, **kw) -> "CLIPTokenizer":
        path = Path(path)
        merges = path / "merges.txt"
        if not merges.exists() and (path / "merges.txt.gz").exists():
            merges = path / "merges.txt.gz"
        return cls.from_files(path / "vocab.json", merges, **kw)

    # -- BPE core -------------------------------------------------------------

    def _bpe(self, token: str) -> list[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        if not token:
            return []
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.merge_ranks.get(p, float("inf")))
            if bigram not in self.merge_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                if j < len(word) - 1 and word[j + 1] == second:
                    new_word.append(first + second)
                    i = j + 2
                else:
                    new_word.append(word[j])
                    i = j + 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    # -- public API -----------------------------------------------------------

    def add_placeholder(self, token: str, ids: list[int]):
        """Register a textual-inversion placeholder: every occurrence of
        ``token`` (case-insensitive, the longest registered one first)
        expands to ``ids``."""
        self.added_placeholders[token.lower()] = [int(i) for i in ids]
        pat = "|".join(re.escape(k) for k in
                       sorted(self.added_placeholders, key=len, reverse=True))
        self._added_re = re.compile(f"({pat})")

    def encode(self, text: str) -> list[int]:
        """Text -> token ids, without specials or padding.  Words are
        byte-level encoded (bytes_to_unicode) before BPE; registered
        placeholders expand to their ids."""
        if self._added_re is None:
            return self._encode_plain(text)
        ids: list[int] = []
        for seg in self._added_re.split(_clean(text)):
            if seg in self.added_placeholders:
                ids += self.added_placeholders[seg]
            elif seg:
                ids += self._encode_plain(seg)
        return ids

    def _encode_plain(self, text: str) -> list[int]:
        ids: list[int] = []
        unk = self.eos_id
        b2u = bytes_to_unicode()
        for tok in _word_pattern().findall(_clean(text)):
            tok = "".join(b2u[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(tok):
                ids.append(self.vocab.get(piece, unk))
        return ids

    def tokenize(self, text: str, max_length: int = 77,
                 pad_to_max: bool = True) -> tuple[np.ndarray, int]:
        """Text -> (ids[max_length] int32, true_length incl. specials).

        BOS + tokens + EOS, truncated so EOS always survives, padded with the
        pad token."""
        ids = [self.bos_id] + self.encode(text)
        ids = ids[: max_length - 1] + [self.eos_id]
        true_len = len(ids)
        if pad_to_max:
            ids = ids + [self.pad_id] * (max_length - len(ids))
        return np.asarray(ids, dtype=np.int32), true_len

    def decode(self, ids) -> str:
        """Token ids -> text (byte-level inverse)."""
        specials = {self.bos_id, self.eos_id, self.pad_id}
        text = "".join(self.decoder.get(int(i), "") for i in ids if int(i) not in specials)
        u2b = unicode_to_bytes()
        raw = bytearray(u2b.get(c, ord("?")) for c in text)
        return (raw.decode("utf-8", errors="replace")
                .replace("</w>", " ").strip())

    @functools.cached_property
    def vocab_size(self) -> int:
        return len(self.vocab)
