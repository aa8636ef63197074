"""Serve-time weight transforms (port of
ml_stable_diffusion_tpu/convert/optimize.py)."""

from __future__ import annotations

import re

import torch

_SELF_QKV = re.compile(r"(.*\.attn1)\.to_q\.weight")


def fuse_qkv_params(state_dict: dict) -> dict:
    """A UNet (or ControlNet) state dict with every self attention's
    ``attn1.to_q``, ``to_k`` and ``to_v`` weights replaced by one
    ``attn1.to_qkv.weight``, the three concatenated on the output dim (dim 0
    of the (N, K) Linear layout, the JAX kernel's axis 1), as
    ``UNetConfig(fuse_qkv=True)`` takes it.  Cross attention (attn2) is
    untouched: its k and v read the context.  The other entries are shared,
    not copied."""
    out = dict(state_dict)
    for key in state_dict:
        m = _SELF_QKV.fullmatch(key)
        if m is None:
            continue
        base = m.group(1)
        parts = [out.pop(f"{base}.{n}.weight") for n in ("to_q", "to_k", "to_v")]
        out[f"{base}.to_qkv.weight"] = torch.cat(parts, dim=0)
    return out
