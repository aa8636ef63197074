"""Textual-inversion embeddings (port of
ml_stable_diffusion_tpu/convert/textual_inversion.py).

A textual-inversion embedding is a learned set of token vectors that a
placeholder word expands to.  On-disk variants:

- **a1111 .pt** (pickled): ``{"string_to_param": {"*": (n, d) tensor},
  "name": "<token>"}``;
- **kohya / a1111 .safetensors**: ``{"emb_params": (n, d)}`` for SD, or
  ``{"clip_l": (n, 768), "clip_g": (n, 1280)}`` for SDXL's two encoders;
- **diffusers .safetensors**: a single ``{token: (n, d)}`` entry.

The CLIP token-embedding table grows by the new rows
(``extend_token_embedding``) and the tokenizer expands the placeholder to
their indices (``CLIPTokenizer.add_placeholder``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .native_io import load_file


def _np2d(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    arr = np.asarray(t, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    if arr.ndim != 2:
        raise ValueError(f"TI embedding must be (n, dim); got {arr.shape}")
    return arr


def load_ti_embedding(source) -> tuple[dict[str, np.ndarray], str | None]:
    """-> ({"clip_l": (n, d)[, "clip_g": (n, d2)]} float32, the token the
    file names or None).

    ``source``: a path (.safetensors, or a torch-pickled .pt/.bin), a dict
    of either layout, or an (n, d) array."""
    if isinstance(source, (np.ndarray, torch.Tensor)):
        return {"clip_l": _np2d(source)}, None
    if isinstance(source, dict):
        raw = source
    else:
        path = Path(source)
        if path.suffix == ".safetensors":
            raw = load_file(path)
        else:
            try:
                raw = torch.load(path, map_location="cpu", weights_only=True)
            except Exception:
                # a1111 .pt files carry non-tensor metadata in the pickle
                raw = torch.load(path, map_location="cpu", weights_only=False)
    if "string_to_param" in raw:  # a1111 .pt
        arr = next(iter(raw["string_to_param"].values()))
        name = raw.get("name")
        return {"clip_l": _np2d(arr)}, (str(name) if name else None)
    if "emb_params" in raw:
        return {"clip_l": _np2d(raw["emb_params"])}, None
    if "clip_l" in raw or "clip_g" in raw:
        out = {k: _np2d(raw[k]) for k in ("clip_l", "clip_g") if k in raw}
        ns = {v.shape[0] for v in out.values()}
        if len(ns) != 1:
            raise ValueError(f"clip_l/clip_g vector counts differ: {ns}")
        return out, None
    tensors = {k: v for k, v in raw.items() if hasattr(v, "shape") and k != "name"}
    if len(tensors) == 1:  # diffusers {token: tensor}
        (token, arr), = tensors.items()
        return {"clip_l": _np2d(arr)}, token
    raise ValueError(f"unrecognized textual-inversion layout (keys: {sorted(raw)})")


@torch.no_grad()
def extend_token_embedding(encoder, rows: np.ndarray):
    """Append ``rows`` to ``encoder``'s (a ``CLIPTextEncoder``) token
    embedding table and grow its config's ``vocab_size`` to match, in place.
    The new table lives where the old one did, in its dtype (the rows are
    rounded to it)."""
    cfg = encoder.config
    if rows.shape[1] != cfg.hidden_size:
        raise ValueError(f"TI embedding dim {rows.shape[1]} != encoder hidden size "
                         f"{cfg.hidden_size}")
    emb = encoder.text_model.embeddings
    old = emb.token_embedding.weight
    table = torch.cat([old, torch.from_numpy(rows).to(old.device, old.dtype)])
    new = nn.Embedding(table.shape[0], table.shape[1], device=old.device, dtype=old.dtype)
    new.weight.copy_(table)
    emb.token_embedding = new
    encoder.config = dataclasses.replace(cfg, vocab_size=table.shape[0])
    return encoder
