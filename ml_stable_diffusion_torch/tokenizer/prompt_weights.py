"""Prompt attention-weight syntax (copy of
ml_stable_diffusion_tpu/tokenizer/prompt_weights.py, which this package may
not import).

The de-facto ecosystem prompt syntax: ``(text)`` emphasizes by 1.1,
``[text]`` de-emphasizes by 1/1.1, ``(text:1.5)`` sets an explicit weight,
nesting multiplies, ``\\(`` escapes a literal parenthesis.  The weights
scale the text encoder's hidden states per token with mean preservation
(``pipelines/sd.py:apply_prompt_weights``).  Prompts longer than one CLIP
window split into windows of 75 tokens, each with its own BOS/EOS.
"""

from __future__ import annotations

import logging
import re

import numpy as np

_ROUND = 1.1
_SQUARE = 1.0 / 1.1

_TOKEN_RE = re.compile(r"""
    \\\( | \\\) | \\\[ | \\\] | \\\\   # escaped specials -> literal
  | \( | \[                            # group open
  | :\s*([+-]?[0-9]*\.?[0-9]+)\s*\)    # explicit weight close
  | \) | \]                            # group close
  | [^\\()\[\]:]+                      # plain text run
  | :                                  # bare colon (literal)
""", re.VERBOSE)


def parse_prompt_attention(text: str) -> list[tuple[str, float]]:
    """-> [(text segment, weight)], consecutive equal weights merged."""
    res: list[list] = []
    round_stack: list[int] = []
    square_stack: list[int] = []

    def multiply_range(start: int, mult: float):
        for p in range(start, len(res)):
            res[p][1] *= mult

    for m in _TOKEN_RE.finditer(text):
        tok = m.group(0)
        weight = m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_stack.append(len(res))
        elif tok == "[":
            square_stack.append(len(res))
        elif weight is not None:
            if round_stack:
                multiply_range(round_stack.pop(), float(weight))
            else:  # stray ":1.5)" with no open group: literal
                res.append([tok, 1.0])
        elif tok == ")":
            if round_stack:
                multiply_range(round_stack.pop(), _ROUND)
            else:
                res.append([tok, 1.0])
        elif tok == "]":
            if square_stack:
                multiply_range(square_stack.pop(), _SQUARE)
            else:
                res.append([tok, 1.0])
        else:
            res.append([tok, 1.0])
    # unclosed groups still emphasize (ecosystem behavior)
    for pos in round_stack:
        multiply_range(pos, _ROUND)
    for pos in square_stack:
        multiply_range(pos, _SQUARE)
    if not res:
        return [("", 1.0)]
    merged: list[list] = [res[0]]
    for seg, w in res[1:]:
        if w == merged[-1][1]:
            merged[-1][0] += seg
        else:
            merged.append([seg, w])
    return [(seg, w) for seg, w in merged]


def weighted_token_chunks(tokenizer, text: str, max_length: int = 77,
                          max_chunks: int = 4):
    """Long-prompt chunking (ecosystem behavior: prompts beyond the CLIP
    window split into ``max_length-2``-token windows, each encoded with its
    own BOS/EOS; contexts concatenate along the sequence axis).

    -> (ids (k, max_length) int32, weights (k, max_length) float32,
    any_weighted).  A prompt of one window without the syntax gives the row
    that ``tokenize`` gives (k = 1)."""
    segments = parse_prompt_attention(text)
    flat_ids: list[int] = []
    flat_w: list[float] = []
    for seg, w in segments:
        seg_ids = tokenizer.encode(seg)
        flat_ids += seg_ids
        flat_w += [w] * len(seg_ids)
    window = max_length - 2
    cap = window * max_chunks
    if len(flat_ids) > cap:
        logging.getLogger(__name__).warning(
            "prompt spans %d tokens; truncating to %d windows (%d tokens)",
            len(flat_ids), max_chunks, cap)
    flat_ids, flat_w = flat_ids[:cap], flat_w[:cap]
    rows, wrows = [], []
    for lo in range(0, max(len(flat_ids), 1), window):
        chunk = flat_ids[lo:lo + window]
        cw = flat_w[lo:lo + window]
        row = [tokenizer.bos_id] + chunk + [tokenizer.eos_id]
        wrow = [1.0] + cw + [1.0]
        row += [tokenizer.pad_id] * (max_length - len(row))
        wrow += [1.0] * (max_length - len(wrow))
        rows.append(row)
        wrows.append(wrow)
    ids = np.asarray(rows, np.int32)
    weights = np.asarray(wrows, np.float32)
    return ids, weights, bool((weights != 1.0).any())


def empty_chunk_row(tokenizer, max_length: int = 77):
    """A BOS+EOS+pad row — chunk padding when batched prompts need
    differing window counts."""
    row = ([tokenizer.bos_id, tokenizer.eos_id]
           + [tokenizer.pad_id] * (max_length - 2))
    return np.asarray(row, np.int32)
