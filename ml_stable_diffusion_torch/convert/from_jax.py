"""JAX package parameter trees -> this package's state dicts.

The input is a Flax parameter tree as nested dicts of numpy arrays (the
caller runs ``np.asarray`` over the leaves; this module imports no JAX) or of
torch tensors (``convert/artifacts.load_module``).  The output is a
diffusers/transformers-keyed state dict of torch tensors that
``load_state_dict(strict=True)`` accepts for ``UNet2DConditionModel``,
``VAEDecoder``, ``CLIPTextEncoder`` and ``MMDiT``.

Layouts: a conv kernel goes HWIO -> OIHW, a dense kernel is transposed,
a norm ``scale`` becomes ``weight``, an embedding table stays as it is.

A palettized kernel (a ``PalettizedTensor`` leaf of either package: uint8
indices, a LUT, a shape and a bit width) stays palettized: its indices are
permuted as the kernel would be, its shape swapped, its LUT kept, and it
comes out as the port's ``compress.palettize.PalettizedTensor``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

from ..compress.palettize import PalettizedTensor, to_torch_layout


def _is_palettized(value) -> bool:
    return all(hasattr(value, a) for a in ("indices", "lut", "shape", "nbits"))


def _as_torch(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.array(value))  # a writable copy


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        elif _is_palettized(value):
            yield prefix + (key,), PalettizedTensor(
                _as_torch(value.indices).reshape(-1).to(torch.uint8),
                _as_torch(value.lut).float(), tuple(value.shape), int(value.nbits))
        else:
            yield prefix + (key,), _as_torch(value)


def _tensor(leaf: str, value):
    """(torch leaf name, the tensor or palettized tensor in torch layout)."""
    if leaf == "kernel":
        leaf = "weight"
        if isinstance(value, PalettizedTensor):
            return leaf, to_torch_layout(value)
        value = value.permute(3, 2, 0, 1) if value.ndim == 4 else value.t()
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return leaf, value if isinstance(value, PalettizedTensor) else value.contiguous()


# flax module path -> diffusers module path, applied in order
_UNET_VAE_RENAMES = (
    ("down_blocks_", "down_blocks."),
    ("up_blocks_", "up_blocks."),
    ("mid_block_resnets_", "mid_block.resnets."),
    ("mid_block_attentions_", "mid_block.attentions."),
    ("mid_block/resnets_", "mid_block/resnets."),
    ("mid_block/attentions_0", "mid_block/attentions.0"),
    ("_resnets_", ".resnets."),
    ("_attentions_", ".attentions."),
    ("_downsamplers_0_conv", ".downsamplers.0.conv"),
    ("_downsamplers_0", ".downsamplers.0"),
    ("_upsamplers_0_conv", ".upsamplers.0.conv"),
    ("_upsamplers_0", ".upsamplers.0"),
    ("transformer_blocks_", "transformer_blocks."),
    ("to_out_0", "to_out.0"),
    ("geglu_proj", "net.0.proj"),
    ("ff/proj_out", "ff/net.2"),
)


def _unet_vae_state_dict(params, prefix_of) -> dict[str, torch.Tensor]:
    sd = {}
    for path, value in _leaves(params):
        name = "/".join(path[:-1])
        for old, new in _UNET_VAE_RENAMES:
            name = name.replace(old, new)
        name = prefix_of(name.replace("/", "."))
        leaf, tensor = _tensor(path[-1], value)
        sd[f"{name}.{leaf}"] = tensor
    return sd


def unet_state_dict(params) -> dict[str, torch.Tensor]:
    """Flax ``UNet2DConditionModel`` params -> port UNet state dict."""
    return _unet_vae_state_dict(params, lambda name: name)


def vae_decoder_state_dict(params) -> dict[str, torch.Tensor]:
    """Flax ``VAEDecoder`` params -> port ``VAEDecoder`` state dict."""
    return _unet_vae_state_dict(
        params, lambda n: n if n.startswith("post_quant_conv") else "decoder." + n)


_CLIP_LAYER = {
    "ln1": "layer_norm1", "ln2": "layer_norm2",
    "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
    "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}


def clip_text_state_dict(params) -> dict[str, torch.Tensor]:
    """Flax ``CLIPTextEncoder`` params -> port ``CLIPTextEncoder`` state dict
    (transformers ``CLIPTextModel`` keys)."""
    sd = {}
    for path, value in _leaves(params):
        head = path[0]
        leaf, tensor = _tensor(path[-1], value)
        m = re.fullmatch(r"layers_(\d+)", head)
        if m:
            name = f"text_model.encoder.layers.{m.group(1)}.{_CLIP_LAYER[path[1]]}"
        elif head == "token_embedding":
            name = "text_model.embeddings.token_embedding"
        elif head == "position_embedding":
            name, leaf = "text_model.embeddings.position_embedding", "weight"
        elif head == "final_layer_norm":
            name = "text_model.final_layer_norm"
        elif head == "text_projection":
            name = "text_projection"
        else:
            raise KeyError(f"unexpected CLIP parameter {'/'.join(path)}")
        sd[f"{name}.{leaf}"] = tensor
    return sd


# flax MMDiT module name -> diffusers SD3Transformer2DModel module path
_MMDIT_TOP = {
    "patch_proj": "pos_embed.proj",
    "timestep_embedder": "time_text_embed.timestep_embedder",
    "text_embedder": "time_text_embed.text_embedder",
    "context_embedder": "context_embedder",
    "norm_out_linear": "norm_out.linear",
    "proj_out": "proj_out",
}
_MMDIT_BLOCK = {
    "norm1_linear": "norm1.linear", "norm1_context_linear": "norm1_context.linear",
    "to_q": "attn.to_q", "to_k": "attn.to_k", "to_v": "attn.to_v",
    "add_q_proj": "attn.add_q_proj", "add_k_proj": "attn.add_k_proj",
    "add_v_proj": "attn.add_v_proj", "to_out_0": "attn.to_out.0",
    "to_add_out": "attn.to_add_out",
    "norm_q": "attn.norm_q", "norm_k": "attn.norm_k",
    "norm_added_q": "attn.norm_added_q", "norm_added_k": "attn.norm_added_k",
    "ff_proj": "ff.net.0.proj", "ff_out": "ff.net.2",
    "ff_context_proj": "ff_context.net.0.proj", "ff_context_out": "ff_context.net.2",
}


def mmdit_state_dict(params) -> dict[str, torch.Tensor]:
    """Flax ``MMDiT`` params -> port ``MMDiT`` state dict (diffusers
    ``SD3Transformer2DModel`` keys).  The positional table goes from the
    Flax (M, M, D) grid to the diffusers (1, M*M, D) layout."""
    sd = {}
    for path, value in _leaves(params):
        head = path[0]
        if head == "pos_embed":
            M1, M2, D = value.shape
            sd["pos_embed.pos_embed"] = value.reshape(1, M1 * M2, D).contiguous()
            continue
        leaf, tensor = _tensor(path[-1], value)
        m = re.fullmatch(r"blocks_(\d+)", head)
        if m:
            name = f"transformer_blocks.{m.group(1)}.{_MMDIT_BLOCK[path[1]]}"
        elif head in _MMDIT_TOP:
            name = ".".join([_MMDIT_TOP[head], *path[1:-1]])
        else:
            raise KeyError(f"unexpected MMDiT parameter {'/'.join(path)}")
        sd[f"{name}.{leaf}"] = tensor
    return sd
