"""T5 unigram tokenizer over an HF ``tokenizer.json`` (port of
ml_stable_diffusion_tpu/tokenizer/t5.py).

The JAX package reads ``tokenizer.json`` through the HF ``tokenizers``
library, with a native C++ Viterbi for plain ASCII.  This copy does without
``tokenizers``: it parses the JSON itself and runs what ``tokenizers`` (0.22)
runs for ``encode(text, add_special_tokens=False)``, in pure Python (and
the same C++ Viterbi where it applies, below):

1. the added tokens (``</s>``, ``<pad>``, ...) are split out of the raw text,
   leftmost-longest, before normalisation; each is its own id;
2. every other piece goes through the normalizer: ``Sequence``,
   ``Precompiled`` (sentencepiece's compiled character map), ``Strip`` and
   ``Replace`` (a String or a Regex pattern, on the standard ``re``);
3. and the pre-tokenizer: ``Metaspace`` (``prepend_scheme``
   always/first/never, with the legacy ``add_prefix_space`` agreeing,
   ``split``),
   ``WhitespaceSplit`` and ``Sequence``;
4. each pre-token is segmented by the ``Unigram`` model: the best-scoring
   path over the vocabulary's pieces (a forward pass keeping, for every end
   position, the first best path found, as ``tokenizers`` does), a character
   no piece covers costing the least score less 10, and runs of such
   characters fused into one unknown id.

``Precompiled`` reads its ``precompiled_charsmap``: a little-endian u32
trie size, a darts-clone double array of u32 units, then NUL-terminated
replacement strings.  ``tokenizers`` walks the text by extended grapheme
cluster: a cluster shorter than 6 UTF-8 bytes is looked up whole, else (or
when the cluster has no entry) each of its characters; a lookup is a
common-prefix search over the UTF-8 bytes that takes the *shortest* match.
The clusters here follow the Unicode segmentation rules from the standard
``unicodedata`` tables (which carry no Extended_Pictographic property: an
emoji after a zero-width joiner is taken to join it).

Any other normalizer or pre-tokenizer type, an added token with
``lstrip``, ``rstrip``, ``single_word`` or ``normalized`` set, a byte
fallback, truncation or padding in the file raise ``ValueError``.

The native fast path (``prefer_native=True``, the default): the C++ Viterbi
of ``native/unigram`` (through ``utils/native.py``) segments the plain-ASCII
prompts, as the JAX package's does, where the file is a Unigram model behind
a ``Metaspace`` pre-tokenizer (U+2581, prepend always, split): printable
ASCII, single-spaced, without an added token (on which T5's ``Precompiled``
normalizer is the identity).  Every other prompt, and a chunk the C++ code
cannot cover, goes to the Python path.  At load the native encoder is held
against the Python path on a probe corpus, and any difference turns it off
for the tokenizer, as does a library that cannot be built
(``T5Tokenizer.uses_native`` says which path it took).
"""

from __future__ import annotations

import base64
import ctypes
import json
import logging
import re
import struct
import unicodedata
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

#: Unicode White_Space (Rust's ``char::is_whitespace``, which ``Strip`` and
#: ``WhitespaceSplit`` use; Python's ``str.isspace`` adds U+001C-U+001F)
_WHITE_SPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                         + "".join(chr(c) for c in range(0x2000, 0x200B)))
#: what an uncovered character scores below the vocabulary's least score
_UNK_PENALTY = 10.0


# -- grapheme clusters -------------------------------------------------------------

_ZWJ, _ZWNJ = "\u200d", "\u200c"


def _gcb(ch: str) -> str:
    """A character's grapheme-cluster-break class (UAX #29), approximately."""
    cp = ord(ch)
    if ch == "\r":
        return "CR"
    if ch == "\n":
        return "LF"
    if ch == _ZWJ:
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    if ch == _ZWNJ or 0x1F3FB <= cp <= 0x1F3FF or 0xE0020 <= cp <= 0xE007F:
        return "Extend"
    cat = unicodedata.category(ch)
    if cat in ("Mn", "Me"):
        return "Extend"
    if cat == "Mc":
        return "SpacingMark"
    if 0x0600 <= cp <= 0x0605 or cp in (0x06DD, 0x070F, 0x0890, 0x0891, 0x08E2, 0x110BD,
                                        0x110CD):
        return "Prepend"
    if cat in ("Cc", "Cf", "Zl", "Zp"):
        return "Control"
    if cat == "So":
        return "ExtPict"
    return "Other"


def _joins(prev: str, cur: str, prev_pict_zwj: bool, ri_run: int) -> bool:
    """Whether no cluster boundary falls between two characters of classes
    ``prev`` and ``cur`` (rules GB3-GB13)."""
    if prev == "CR" and cur == "LF":
        return True
    if prev in ("CR", "LF", "Control") or cur in ("CR", "LF", "Control"):
        return False
    if prev == "L" and cur in ("L", "V", "LV", "LVT"):
        return True
    if prev in ("LV", "V") and cur in ("V", "T"):
        return True
    if prev in ("LVT", "T") and cur == "T":
        return True
    if cur in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
        return True
    if prev_pict_zwj and cur == "ExtPict":
        return True
    return prev == "RI" and cur == "RI" and ri_run % 2 == 1


def graphemes(text: str) -> list[str]:
    """``text`` split into extended grapheme clusters."""
    out: list[str] = []
    prev = None
    pict = pict_zwj = False  # an ExtPict Extend* run; ... followed by ZWJ
    ri_run = 0
    for ch in text:
        cur = _gcb(ch)
        if prev is not None and _joins(prev, cur, pict_zwj, ri_run):
            out[-1] += ch
        else:
            out.append(ch)
        pict_zwj = pict and cur == "ZWJ"
        pict = cur == "ExtPict" or (pict and cur == "Extend")
        ri_run = ri_run + 1 if cur == "RI" else 0
        prev = cur
    return out


# -- the normalizers ---------------------------------------------------------------
#
# A normalized piece is (text, origins): ``origins[i]`` is the offset in the
# raw text of the character that normalized character i came from.

class Precompiled:
    """sentencepiece's compiled character map (``precompiled_charsmap``)."""

    def __init__(self, charsmap_b64: str):
        blob = base64.b64decode(charsmap_b64)
        if len(blob) < 4:
            raise ValueError("precompiled_charsmap: too short for its trie size")
        (trie_bytes,) = struct.unpack_from("<I", blob, 0)
        if trie_bytes % 4 or 4 + trie_bytes > len(blob):
            raise ValueError(f"precompiled_charsmap: bad trie size {trie_bytes}")
        self.units = struct.unpack_from(f"<{trie_bytes // 4}I", blob, 4)
        self.normalized = blob[4 + trie_bytes:]

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def _common_prefix_values(self, key: bytes):
        """darts-clone's common-prefix search: the values of every entry
        that is a prefix of ``key``, shortest first."""
        units = self.units
        pos = self._offset(units[0]) if units else 0
        for c in key:
            if c == 0:
                return
            pos ^= c
            if pos >= len(units):
                return
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                return
            pos ^= self._offset(unit)
            if unit & (1 << 8) and pos < len(units):
                yield units[pos] & 0x7FFFFFFF

    def transform(self, chunk: str) -> str | None:
        """The replacement of ``chunk``'s shortest mapped prefix, or None."""
        for value in self._common_prefix_values(chunk.encode("utf-8")):
            end = self.normalized.find(b"\0", value)
            return self.normalized[value:end if end >= 0 else None].decode("utf-8")
        return None

    def __call__(self, text: str, origins: list[int]):
        out, out_origins = [], []
        i = 0
        for cluster in graphemes(text):
            rep = self.transform(cluster) if len(cluster.encode("utf-8")) < 6 else None
            if rep is not None:
                out.append(rep)
                out_origins += [origins[i]] * len(rep)
            else:
                for j, ch in enumerate(cluster):
                    rep = self.transform(ch)
                    rep = ch if rep is None else rep
                    out.append(rep)
                    out_origins += [origins[i + j]] * len(rep)
            i += len(cluster)
        return "".join(out), out_origins


def _strip(left: bool, right: bool):
    def strip(text, origins):
        lo, hi = 0, len(text)
        while left and lo < hi and text[lo] in _WHITE_SPACE:
            lo += 1
        while right and hi > lo and text[hi - 1] in _WHITE_SPACE:
            hi -= 1
        return text[lo:hi], origins[lo:hi]
    return strip


def _replace(pattern: dict, content: str):
    if "String" in pattern:
        regex = re.compile(re.escape(pattern["String"]))
    elif "Regex" in pattern:
        regex = re.compile(pattern["Regex"])
    else:
        raise ValueError(f"Replace pattern {pattern!r}: expected String or Regex")

    def replace(text, origins):
        out, out_origins, pos = [], [], 0
        for m in regex.finditer(text):
            a, b = m.span()
            out.append(text[pos:a])
            out_origins += origins[pos:a]
            out.append(content)
            origin = origins[a] if a < len(origins) else (origins[-1] if origins else 0)
            out_origins += [origin] * len(content)
            pos = b
        out.append(text[pos:])
        out_origins += origins[pos:]
        return "".join(out), out_origins
    return replace


def _normalizer(spec: dict | None):
    if spec is None:
        return lambda text, origins: (text, origins)
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]

        def sequence(text, origins):
            for step in steps:
                text, origins = step(text, origins)
            return text, origins
        return sequence
    if kind == "Precompiled":
        if not spec.get("precompiled_charsmap"):  # an empty map is the identity
            return lambda text, origins: (text, origins)
        return Precompiled(spec["precompiled_charsmap"])
    if kind == "Strip":
        return _strip(spec.get("strip_left", True), spec.get("strip_right", True))
    if kind == "Replace":
        return _replace(spec["pattern"], spec["content"])
    raise ValueError(f"T5Tokenizer: normalizer type {kind!r} is not ported")


# -- the pre-tokenizers ------------------------------------------------------------
#
# A pre-token is (text, origins, start): ``start`` the raw-text offset the
# piece begins at (tokenizers' ``offsets_original().0``).

def _metaspace(spec: dict):
    rep = spec.get("replacement", "▁")
    scheme = spec.get("prepend_scheme", "always")
    if scheme not in ("always", "first", "never"):
        raise ValueError(f"Metaspace prepend_scheme {scheme!r} is not ported")
    # the legacy flag must agree with the scheme, as tokenizers requires
    if spec.get("add_prefix_space", scheme != "never") != (scheme != "never"):
        raise ValueError("Metaspace: add_prefix_space does not match prepend_scheme")
    split = spec.get("split", True)

    def metaspace(pieces):
        out = []
        for text, origins, start in pieces:
            text = text.replace(" ", rep)
            if (text and not text.startswith(rep)
                    and (scheme == "always" or (scheme == "first" and start == 0))):
                text, origins = rep + text, origins[:1] + origins
            if not split:
                out.append((text, origins, start))
                continue
            # split on the replacement, each merged with what follows it
            begin = 0
            for i in range(1, len(text) + 1):
                if i == len(text) or text[i] == rep:
                    if i > begin:
                        out.append((text[begin:i], origins[begin:i], origins[begin]))
                    begin = i
        return out
    return metaspace


def _whitespace_split(pieces):
    out = []
    for text, origins, _ in pieces:
        begin = None
        for i, ch in enumerate(text + " "):
            if ch in _WHITE_SPACE or i == len(text):
                if begin is not None:
                    out.append((text[begin:i], origins[begin:i], origins[begin]))
                    begin = None
            elif begin is None:
                begin = i
    return out


def _pre_tokenizer(spec: dict | None):
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def sequence(pieces):
            for step in steps:
                pieces = step(pieces)
            return pieces
        return sequence
    if kind == "Metaspace":
        return _metaspace(spec)
    if kind == "WhitespaceSplit":
        return _whitespace_split
    raise ValueError(f"T5Tokenizer: pre-tokenizer type {kind!r} is not ported")


# -- the unigram model -------------------------------------------------------------

class Unigram:
    """``tokenizers``' Unigram model (``byte_fallback`` false, unknown runs
    fused)."""

    def __init__(self, spec: dict):
        if spec.get("type") != "Unigram":
            raise ValueError(f"T5Tokenizer: model type {spec.get('type')!r} is not ported")
        if spec.get("byte_fallback"):
            raise ValueError("T5Tokenizer: a Unigram byte_fallback is not ported")
        vocab = spec["vocab"]
        self.unk_id = spec.get("unk_id")
        self.scores = [float(score) for _, score in vocab]
        # a piece listed twice takes its last id, as tokenizers' map does
        self.ids = {piece: i for i, (piece, _) in enumerate(vocab)}
        self.unk_score = min(self.scores, default=0.0) - _UNK_PENALTY
        self.max_len = max((len(p) for p in self.ids), default=0)

    def encode(self, text: str) -> list[int]:
        n = len(text)
        if n == 0:
            return []
        # best[e] = (score of the best path ending at e, its last piece's
        # start, the piece's id); the first path found wins a tie
        best: list[tuple[float, int, int] | None] = [None] * (n + 1)
        best[0] = (0.0, -1, -1)
        for s in range(n):
            here = best[s][0]
            single = False
            for e in range(s + 1, min(n, s + self.max_len) + 1):
                piece_id = self.ids.get(text[s:e])
                if piece_id is None:
                    continue
                score = here + self.scores[piece_id]
                if best[e] is None or score > best[e][0]:
                    best[e] = (score, s, piece_id)
                single = single or e == s + 1
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"T5Tokenizer: {text[s]!r} has no piece and the "
                                     "model no unk_id")
                score = here + self.unk_score
                if best[s + 1] is None or score > best[s + 1][0]:
                    best[s + 1] = (score, s, self.unk_id)
        pieces: list[str] = []
        unk_run: list[str] = []
        e = n
        while e > 0:
            _, s, piece_id = best[e]
            if piece_id == self.unk_id:
                unk_run.append(text[s:e])
            else:
                if unk_run:
                    pieces.append("".join(reversed(unk_run)))
                    unk_run = []
                pieces.append(text[s:e])
            e = s
        if unk_run:
            pieces.append("".join(reversed(unk_run)))
        return [self.ids.get(p, self.unk_id) for p in reversed(pieces)]


# -- the native path -----------------------------------------------------------------

#: the self-check corpus of the native encoder
_PROBES = (
    "a photo of an astronaut riding a horse on mars",
    "hello world",
    "the quick brown fox jumps over the lazy dog.",
    "8k, highly detailed, trending on artstation!",
    "one, two; three: four-five (six) 'seven'",
    "a",
    "",
    "watercolor? masterpiece... 1girl 4k",
)


def _load_unigram_lib():
    from ..utils.native import load_library

    lib = load_library("unigram")
    lib.sdtpu_unigram_create.restype = ctypes.c_void_p
    lib.sdtpu_unigram_create.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32]
    lib.sdtpu_unigram_error.restype = ctypes.c_char_p
    lib.sdtpu_unigram_error.argtypes = [ctypes.c_void_p]
    lib.sdtpu_unigram_destroy.restype = None
    lib.sdtpu_unigram_destroy.argtypes = [ctypes.c_void_p]
    lib.sdtpu_unigram_encode.restype = ctypes.c_int32
    lib.sdtpu_unigram_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    return lib


class NativeUnigram:
    """The C++ Viterbi unigram encoder; ``encode`` returns None where it
    cannot give the Python path's answer (a chunk no piece covers).

    A piece listed twice takes its last id and score in ``tokenizers`` (and
    in ``Unigram``), its first in the C++ map: every earlier entry is handed
    to the C++ code as a private-use string that no eligible prompt holds,
    so that the ids and the scores the search sees are the Python path's."""

    def __init__(self, vocab: list, special_tokens):
        self._lib = _load_unigram_lib()
        last = {piece: i for i, (piece, _) in enumerate(vocab)}
        blob = bytearray()
        for i, (piece, score) in enumerate(vocab):
            raw = (piece if last[piece] == i else f"\ue000{i}").encode("utf-8")
            blob += struct.pack("<I", len(raw)) + raw + struct.pack("<d", float(score))
        self._blob = bytes(blob)  # kept alive for the handle
        self._handle = self._lib.sdtpu_unigram_create(self._blob, len(self._blob), len(vocab))
        err = self._lib.sdtpu_unigram_error(self._handle)
        if err:
            raise RuntimeError(f"native unigram: {err.decode()}")
        self._specials = tuple(special_tokens)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.sdtpu_unigram_destroy(self._handle)
            self._handle = None

    def eligible(self, text: str) -> bool:
        return (text.isascii() and (text == "" or text.isprintable()) and "  " not in text
                and text == text.strip() and not any(s in text for s in self._specials))

    def encode(self, text: str) -> list[int] | None:
        if not text:
            return []  # an empty pre-tokenization has no pieces
        buf = (ctypes.c_int32 * 1024)()
        n = self._lib.sdtpu_unigram_encode(self._handle, text.encode("utf-8"), buf, 1024)
        return None if n < 0 else list(buf[:n])


def _native_for(spec: dict) -> NativeUnigram | None:
    """The native encoder iff ``tokenizer.json`` is what the C++ code
    implements: a Unigram model without byte fallback behind a
    ``Metaspace(U+2581, prepend always, split)`` pre-tokenizer."""
    model = spec.get("model") or {}
    pre = spec.get("pre_tokenizer") or {}
    if model.get("type") != "Unigram" or model.get("byte_fallback"):
        return None
    scheme = pre.get("prepend_scheme",
                     "always" if pre.get("add_prefix_space", True) else "never")
    if (pre.get("type") != "Metaspace" or pre.get("replacement") != "\u2581"
            or scheme != "always" or pre.get("split", True) is not True):
        return None
    return NativeUnigram(model["vocab"], [t["content"] for t in spec.get("added_tokens") or []])


class T5Tokenizer:
    """``tokenizer.json`` -> ids; ``tokenize`` adds EOS, pads and masks.
    ``prefer_native``: the C++ path where it applies and builds."""

    def __init__(self, tokenizer_json: str | Path, eos_id: int = 1, pad_id: int = 0,
                 prefer_native: bool = True):
        spec = json.loads(Path(tokenizer_json).read_text(encoding="utf-8"))
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise ValueError(f"T5Tokenizer: {key} in tokenizer.json is not ported")
        self.added = {}
        for tok in spec.get("added_tokens") or []:
            for flag in ("lstrip", "rstrip", "single_word", "normalized"):
                if tok.get(flag):
                    raise ValueError(f"T5Tokenizer: added token {tok['content']!r} with "
                                     f"{flag} is not ported")
            self.added[tok["content"]] = tok["id"]
        self._added_lens = sorted({len(t) for t in self.added}, reverse=True)
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = Unigram(spec["model"])
        self.eos_id = eos_id
        self.pad_id = pad_id
        self._native = None
        #: prompts the C++ encoder segmented (the rest went to Python)
        self.native_calls = 0
        if not prefer_native:
            return
        try:
            enc = _native_for(spec)
        except (RuntimeError, OSError) as e:
            logger.info("native unigram unavailable: %s", e)
            return
        if enc is not None and self._self_check(enc):
            self._native = enc

    def _self_check(self, native: NativeUnigram) -> bool:
        """Whether the native encoder gives the Python path's ids on the
        probe corpus (score ties, or a normalizer that is not the identity
        on ASCII, would show here)."""
        for text in _PROBES:
            got = native.encode(text) if native.eligible(text) else None
            if got is None:
                continue
            want = self._encode_python(text)
            if got != want:
                logger.warning("native unigram self-check mismatch on %r (%s != %s); using "
                               "the Python path", text, got, want)
                return False
        return True

    @property
    def uses_native(self) -> bool:
        return self._native is not None

    def _split_added(self, text: str):
        """-> [(piece, start, added id or None)]: the added tokens split out,
        leftmost-longest."""
        out, begin, i = [], 0, 0
        while i < len(text):
            for n in self._added_lens:
                tok_id = self.added.get(text[i:i + n])
                if tok_id is not None:
                    if i > begin:
                        out.append((text[begin:i], begin, None))
                    out.append((text[i:i + n], i, tok_id))
                    i = begin = i + n
                    break
            else:
                i += 1
        if begin < len(text):
            out.append((text[begin:], begin, None))
        return out

    def encode(self, text: str) -> list[int]:
        """Segment (no EOS, no padding): the native path where eligible."""
        if self._native is not None and self._native.eligible(text):
            ids = self._native.encode(text)
            if ids is not None:
                self.native_calls += 1
                return ids
        return self._encode_python(text)

    def _encode_python(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece, start, tok_id in self._split_added(text):
            if tok_id is not None:
                ids.append(tok_id)
                continue
            norm, origins = self.normalize(piece, list(range(start, start + len(piece))))
            for sub, _, _ in self.pre_tokenize([(norm, origins, start)]):
                ids += self.model.encode(sub)
        return ids

    def tokenize(self, text: str, max_length: int = 77):
        """-> (ids[max_length] int32, attention_mask[max_length] int32):
        truncated so that EOS survives, padded with ``pad_id``; the mask
        covers the real tokens and EOS."""
        ids = self.encode(text)[: max_length - 1] + [self.eos_id]
        pad = max_length - len(ids)
        return (np.asarray(ids + [self.pad_id] * pad, dtype=np.int32),
                np.asarray([1] * len(ids) + [0] * pad, dtype=np.int32))
