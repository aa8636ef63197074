"""JAX package parameter trees -> this package's state dicts.

The input is a Flax parameter tree as nested dicts of numpy arrays (the
caller runs ``np.asarray`` over the leaves; this module imports no JAX) or of
torch tensors (``convert/artifacts.load_module``).  The output is a
diffusers/transformers-keyed state dict of torch tensors that
``load_state_dict(strict=True)`` accepts for ``UNet2DConditionModel``,
``ControlNetModel``, ``VAEDecoder``, ``VAEEncoder``, ``CLIPTextEncoder``,
``SafetyChecker``, ``CLIPVisionEncoder``, ``MMDiT``, ``SD3ControlNetModel``
and ``T5Encoder``.

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


def _unet_vae_module_name(flax_path: str) -> str:
    """A flax module path ("/"-joined) -> the diffusers module path."""
    for old, new in _UNET_VAE_RENAMES:
        flax_path = flax_path.replace(old, new)
    return flax_path.replace("/", ".")


def _unet_vae_state_dict(params, prefix_of) -> dict[str, torch.Tensor]:
    sd = {}
    for path, value in _leaves(params):
        name = prefix_of(_unet_vae_module_name("/".join(path[:-1])))
        leaf, tensor = _tensor(path[-1], value)
        sd[f"{name}.{leaf}"] = tensor
    return sd


def unet_state_dict(params) -> dict[str, torch.Tensor]:
    """Flax ``UNet2DConditionModel`` params -> port UNet state dict.  A
    fused self-attention projection ``attn1/to_qkv`` (JAX
    ``convert/optimize.fuse_qkv_params``) maps to ``attn1.to_qkv``."""
    return _unet_vae_state_dict(params, lambda name: name)


def unet_module_name(flax_path: str) -> str:
    """A Flax UNet module path (``down_blocks_0_attentions_0/
    transformer_blocks_0/attn1/to_q``, as the JAX package keys W8A8 scales
    and int8 weights) -> the port's module name (``down_blocks.0.attentions.0
    .transformer_blocks.0.attn1.to_q``): ``unet_state_dict``'s map."""
    return _unet_vae_module_name(flax_path)


def unet_flax_path(name: str) -> str:
    """The inverse of ``unet_module_name``: the renames undone in reverse
    order (the VAE's ``mid_block/`` forms are never reached: the UNet's
    ``.resnets.`` and ``.attentions.`` come first), then the remaining dots
    made module separators.  ``KeyError`` when the result does not map back
    to ``name``."""
    path = name
    for old, new in reversed(_UNET_VAE_RENAMES):
        path = path.replace(new.replace("/", "."), old)
    path = path.replace(".", "/")
    if unet_module_name(path) != name:
        raise KeyError(f"no Flax UNet path maps to {name!r}")
    return path


def controlnet_state_dict(params) -> dict[str, torch.Tensor]:
    """Flax ``ControlNetModel`` params -> port ``ControlNetModel`` state dict
    (diffusers ``ControlNetModel`` keys)."""
    return _unet_vae_state_dict(
        params, lambda n: n.replace("cond_embedding.blocks_", "cond_embedding.blocks."))


def vae_decoder_state_dict(params) -> dict[str, torch.Tensor]:
    """Flax ``VAEDecoder`` params -> port ``VAEDecoder`` state dict."""
    return _unet_vae_state_dict(
        params, lambda n: n if n.startswith("post_quant_conv") else "decoder." + n)


def vae_encoder_state_dict(params) -> dict[str, torch.Tensor]:
    """Flax ``VAEEncoder`` params -> port ``VAEEncoder`` state dict."""
    return _unet_vae_state_dict(
        params, lambda n: n if n.startswith("quant_conv") else "encoder." + n)


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


_SAFETY_VISION = {
    "patch_embedding": "embeddings.patch_embedding",
    "pre_layernorm": "pre_layrnorm",  # HF's spelling
    "post_layernorm": "post_layernorm",
}
_SAFETY_BANKS = ("concept_embeds", "concept_embeds_weights", "special_care_embeds",
                 "special_care_embeds_weights")


def safety_checker_state_dict(params) -> dict[str, torch.Tensor]:
    """Flax ``SafetyChecker`` params -> port ``SafetyChecker`` state dict
    (HF ``StableDiffusionSafetyChecker`` keys: the inverse of the JAX
    package's ``convert/safety.py``)."""
    return _vision_tower_state_dict(params, "vision_model.vision_model")


def clip_vision_state_dict(params) -> dict[str, torch.Tensor]:
    """Flax ``CLIPVisionEncoder`` params -> port ``CLIPVisionEncoder`` state
    dict (transformers ``CLIPVisionModelWithProjection`` keys)."""
    return _vision_tower_state_dict(params, "vision_model")


def _vision_tower_state_dict(params, vm: str) -> dict[str, torch.Tensor]:
    sd = {}
    for path, value in _leaves(params):
        head = path[0]
        if head in _SAFETY_BANKS:
            sd[head] = value.contiguous()
        elif head == "class_embedding":
            sd[f"{vm}.embeddings.class_embedding"] = value.contiguous()
        elif head == "position_embedding":
            sd[f"{vm}.embeddings.position_embedding.weight"] = value.contiguous()
        else:
            leaf, tensor = _tensor(path[-1], value)
            m = re.fullmatch(r"layers_(\d+)", head)
            if m:
                name = f"{vm}.encoder.layers.{m.group(1)}.{_CLIP_LAYER[path[1]]}"
            elif head in _SAFETY_VISION:
                name = f"{vm}.{_SAFETY_VISION[head]}"
            elif head == "visual_projection":
                name = head
            else:
                raise KeyError(f"unexpected vision tower parameter {'/'.join(path)}")
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
        if path[0] == "pos_embed":
            M1, M2, D = value.shape
            sd["pos_embed.pos_embed"] = value.reshape(1, M1 * M2, D).contiguous()
            continue
        leaf, tensor = _tensor(path[-1], value)
        sd[f"{_mmdit_module_name(path[:-1])}.{leaf}"] = tensor
    return sd


def _mmdit_module_name(path: tuple) -> str:
    head = path[0]
    m = re.fullmatch(r"blocks_(\d+)", head)
    if m:
        return f"transformer_blocks.{m.group(1)}.{_MMDIT_BLOCK[path[1]]}"
    if head in _MMDIT_TOP:
        return ".".join([_MMDIT_TOP[head], *path[1:]])
    raise KeyError(f"unexpected MMDiT module {'/'.join(path)}")


def mmdit_module_name(flax_path: str) -> str:
    """A Flax MMDiT module path (``blocks_3/to_q``) -> the port's module
    name (``transformer_blocks.3.attn.to_q``): ``mmdit_state_dict``'s map."""
    return _mmdit_module_name(tuple(flax_path.split("/")))


def mmdit_flax_path(name: str) -> str:
    """The inverse of ``mmdit_module_name``, read off the same two maps
    inverted; ``KeyError`` for a name no Flax path maps to."""
    m = re.fullmatch(r"transformer_blocks\.(\d+)\.(.+)", name)
    if m:
        inv = {v: k for k, v in _MMDIT_BLOCK.items()}
        if m.group(2) in inv:
            return f"blocks_{m.group(1)}/{inv[m.group(2)]}"
    for head, top in _MMDIT_TOP.items():
        if name == top or name.startswith(top + "."):
            path = "/".join([head, *name[len(top) + 1:].split(".")]) if name != top else head
            if mmdit_module_name(path) == name:
                return path
    raise KeyError(f"no Flax MMDiT path maps to {name!r}")


# flax T5Block module name -> transformers T5 block path
_T5_BLOCK = {
    "attn_layer_norm": "layer.0.layer_norm",
    "q": "layer.0.SelfAttention.q", "k": "layer.0.SelfAttention.k",
    "v": "layer.0.SelfAttention.v", "o": "layer.0.SelfAttention.o",
    "ff_layer_norm": "layer.1.layer_norm",
    "wi_0": "layer.1.DenseReluDense.wi_0", "wi_1": "layer.1.DenseReluDense.wi_1",
    "wo": "layer.1.DenseReluDense.wo",
}


def t5_state_dict(params) -> dict[str, torch.Tensor]:
    """Flax ``T5Encoder`` params -> port ``T5Encoder`` state dict
    (transformers ``T5EncoderModel`` keys; the inverse of the JAX package's
    ``convert/t5.py``)."""
    sd = {}
    for path, value in _leaves(params):
        head = path[0]
        if head == "relative_attention_bias":
            sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
                value.contiguous())
            continue
        leaf, tensor = _tensor(path[-1], value)
        m = re.fullmatch(r"block_(\d+)", head)
        if m:
            name = f"encoder.block.{m.group(1)}.{_T5_BLOCK[path[1]]}"
        elif head == "shared":
            name = "shared"
        elif head == "final_layer_norm":
            name = "encoder.final_layer_norm"
        else:
            raise KeyError(f"unexpected T5 parameter {'/'.join(path)}")
        sd[f"{name}.{leaf}"] = tensor
    return sd


def sd3_controlnet_state_dict(params) -> dict[str, torch.Tensor]:
    """Flax ``SD3ControlNetModel`` params -> port ``SD3ControlNetModel``
    state dict (diffusers ``SD3ControlNetModel`` keys): the MMDiT stem and
    blocks as ``mmdit_state_dict`` maps them, the zero patch embedding of
    the control latents as ``pos_embed_input.proj`` and the per-block
    projections as ``controlnet_blocks.{i}``."""
    stem = {k: v for k, v in params.items()
            if k != "patch_proj_input" and not k.startswith("controlnet_blocks_")}
    sd = mmdit_state_dict(stem)
    for path, value in _leaves({k: v for k, v in params.items() if k not in stem}):
        leaf, tensor = _tensor(path[-1], value)
        head = path[0]
        name = ("pos_embed_input.proj" if head == "patch_proj_input"
                else "controlnet_blocks." + head[len("controlnet_blocks_"):])
        sd[f"{name}.{leaf}"] = tensor
    return sd
