"""IP-Adapter checkpoints (port of
ml_stable_diffusion_tpu/convert/ip_adapter.py).

The h94/IP-Adapter format has two groups:

- ``image_proj``: the BASE projection (``proj.*``, ``norm.*``) or the PLUS
  resampler (``latents``, ``proj_in.*``, ``layers.*``, ``proj_out.*``,
  ``norm_out.*``), under models/ip_adapter.py's names as they stand;
- ``ip_adapter``: ``{2i+1}.to_k_ip.weight`` / ``.to_v_ip.weight``, where the
  integer indexes diffusers' ``unet.attn_processors``: attn1 and attn2 of
  every transformer block, so the i-th cross attention holds ``2i + 1``.
  That enumeration goes down blocks, then UP blocks, then the mid block
  last (torch registers ``up_blocks`` before ``mid_block``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..models.unet import UNetConfig
from .native_io import load_file


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.array(value))


def load_ip_adapter_state(source) -> tuple[dict, dict]:
    """-> (image_proj {name: tensor}, ip_layers {"1.to_k_ip.weight": tensor,
    ...}) on the CPU.

    ``source``: a .safetensors file (flat ``image_proj.*`` / ``ip_adapter.*``
    keys), a torch-pickled .bin (nested dicts, read with
    ``weights_only=True``), or a nested dict."""
    if isinstance(source, dict):
        raw = source
    else:
        path = Path(source)
        if path.suffix == ".safetensors":
            raw = {"image_proj": {}, "ip_adapter": {}}
            for k, v in load_file(path).items():
                group, _, rest = k.partition(".")
                if group not in raw:
                    raise ValueError(f"unexpected IP-Adapter key: {k}")
                raw[group][rest] = v
        else:
            raw = torch.load(path, map_location="cpu", weights_only=True)
    if "image_proj" not in raw or "ip_adapter" not in raw:
        raise ValueError(f"not an IP-Adapter checkpoint (groups: {sorted(raw)})")
    image_proj = {k: _tensor(v) for k, v in raw["image_proj"].items()}
    if "proj.weight" not in image_proj and "latents" not in image_proj:
        raise ValueError(
            "unrecognized IP-Adapter projection layout (image_proj keys: "
            f"{sorted(image_proj)}); expected the BASE (proj/norm) or PLUS "
            "(latents/proj_in/layers.*) format")
    return image_proj, {k: _tensor(v) for k, v in raw["ip_adapter"].items()}


def cross_attention_paths(config: UNetConfig) -> list[str]:
    """The UNet's cross-attention (attn2) module names in diffusers'
    ``attn_processors`` order: down blocks, up blocks, the mid block last."""
    paths: list[str] = []

    def spatial(prefix: str, depth: int):
        paths.extend(f"{prefix}.transformer_blocks.{k}.attn2" for k in range(depth))

    n_blocks = len(config.block_out_channels)
    for bi, btype in enumerate(config.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            for li in range(config.layers_per_block):
                spatial(f"down_blocks.{bi}.attentions.{li}",
                        config.transformer_layers_per_block[bi])
    for bi, btype in enumerate(config.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            for li in range(config.layers_per_block + 1):
                spatial(f"up_blocks.{bi}.attentions.{li}",
                        config.transformer_layers_per_block[n_blocks - 1 - bi])
    spatial("mid_block.attentions.0", config.transformer_layers_per_block[-1])
    return paths


def port_ip_adapter(config: UNetConfig, ip_layers: dict) -> dict:
    """-> {attn2 module name: {"to_k_ip": (inner, cross) weight, "to_v_ip":
    ...}}; ``ValueError`` when the checkpoint's indices are not this UNet's."""
    paths = cross_attention_paths(config)
    have = {int(k.split(".")[0]) for k in ip_layers}
    want = {2 * i + 1 for i in range(len(paths))}
    if have != want:
        raise ValueError(
            f"IP-Adapter layer indices {sorted(have)} do not match this UNet's "
            f"{len(paths)} cross-attentions (expected odd indices up to "
            f"{2 * len(paths) - 1}) — wrong base model?")
    return {path: {name: ip_layers[f"{2 * i + 1}.{name}.weight"]
                   for name in ("to_k_ip", "to_v_ip")}
            for i, path in enumerate(paths)}


@torch.no_grad()
def install_ip_projections(unet, ported: dict):
    """Give each cross attention of ``unet`` its bias-free ``to_k_ip`` /
    ``to_v_ip`` Linear holding ``port_ip_adapter``'s weights, in the UNet's
    dtype on its device (replacing those of an adapter loaded before)."""
    w = unet.conv_in.weight
    for name, weights in ported.items():
        attn = unet.get_submodule(name)
        for key, value in weights.items():
            layer = torch.nn.Linear(value.shape[1], value.shape[0], bias=False,
                                    device=w.device, dtype=w.dtype)
            layer.weight.copy_(value)
            setattr(attn, key, layer)


def resampler_geometry(image_proj: dict) -> dict:
    """``IPResampler``'s geometry from a PLUS ``image_proj`` group: latents
    (1, num_queries, dim); to_q (heads * 64, dim), dim_head being 64 in
    every published plus adapter; proj_out (output_dim, dim); ``layers.{i}``
    for depth i."""
    lat = image_proj["latents"]
    dim = lat.shape[-1]
    inner = image_proj["layers.0.0.to_q.weight"].shape[0]
    depth = 1 + max(int(k.split(".")[1]) for k in image_proj if k.startswith("layers."))
    ff_in = image_proj["layers.0.1.1.weight"].shape[0]
    return {"output_dim": image_proj["proj_out.weight"].shape[0], "dim": dim,
            "depth": depth, "dim_head": 64, "heads": inner // 64,
            "num_queries": lat.shape[1], "ff_mult": ff_in // dim}
