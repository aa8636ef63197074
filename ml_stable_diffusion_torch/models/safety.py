"""Safety checker (port of ml_stable_diffusion_tpu/models/safety.py).

A CLIP ViT image tower, its visual projection, and cosine distances of the
normalized image embedding to learned "concept" and "special-care" banks:
an image is flagged when any ``cos - threshold + adjustment`` is above 0,
special-care hits loosening the concept thresholds by 0.01 (the HF
``StableDiffusionSafetyChecker`` rule).  Parameter names are that module's
keys (``vision_model.vision_model.encoder.layers.0.self_attn.q_proj.weight``,
``visual_projection.weight``, ``concept_embeds``, ...).

The tower's attention always takes the plain path, as the JAX module forces
XLA: its f32 D = 64 heads at 257 tokens would otherwise qualify for the
flash kernel.  ``check_images`` resizes on the device
(``resize_uint8``) where the JAX function resizes with PIL.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .clip import CLIPEncoderLayer

#: CLIP image normalization
CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class SafetyCheckerConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    projection_dim: int = 768
    num_concepts: int = 17
    num_special_care: int = 3
    layer_norm_eps: float = 1e-5

    #: the tower's MLP activation (a class attribute, not a field: the JAX
    #: config has none)
    hidden_act = "quick_gelu"


class _Embeddings(nn.Module):
    def __init__(self, cfg: SafetyCheckerConfig):
        super().__init__()
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(n, cfg.hidden_size)

    def forward(self, x):
        patches = self.patch_embedding(x).flatten(2).transpose(1, 2)  # (B, S, C), rows first
        cls = self.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class _Encoder(nn.Module):
    def __init__(self, cfg: SafetyCheckerConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, causal=False)
                                    for _ in range(cfg.num_hidden_layers))


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: SafetyCheckerConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        # HF's key really is spelled "pre_layrnorm"
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        h = self.pre_layrnorm(self.embeddings(x))
        for layer in self.encoder.layers:
            h = layer(h)
        return self.post_layernorm(h[:, 0])


class _VisionModel(nn.Module):
    def __init__(self, cfg: SafetyCheckerConfig):
        super().__init__()
        self.vision_model = _VisionTransformer(cfg)


def _cos(a, bank):
    return a @ (bank / bank.norm(dim=-1, keepdim=True)).T


class SafetyChecker(nn.Module):
    """``forward(images (B, 3, S, S) in [0, 1], adjustment)`` -> ``has_nsfw``
    (B,) bool, ``concept_scores``, ``special_scores`` and the normalized
    ``image_embeds`` (float32)."""

    def __init__(self, config: SafetyCheckerConfig):
        super().__init__()
        self.config = cfg = config
        self.vision_model = _VisionModel(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)
        self.concept_embeds = nn.Parameter(torch.zeros(cfg.num_concepts, cfg.projection_dim))
        self.concept_embeds_weights = nn.Parameter(torch.zeros(cfg.num_concepts))
        self.special_care_embeds = nn.Parameter(
            torch.zeros(cfg.num_special_care, cfg.projection_dim))
        self.special_care_embeds_weights = nn.Parameter(torch.zeros(cfg.num_special_care))

    def forward(self, images, adjustment: float = 0.0):
        dtype = self.visual_projection.weight.dtype
        mean, std = (torch.from_numpy(a).to(images.device)[:, None, None]
                     for a in (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD))
        x = ((images.float() - mean) / std).to(dtype)
        embeds = self.visual_projection(self.vision_model.vision_model(x)).float()
        embeds = embeds / embeds.norm(dim=-1, keepdim=True)
        special_scores = (_cos(embeds, self.special_care_embeds.float())
                          - self.special_care_embeds_weights.float() + adjustment)
        has_special = (special_scores > 0).any(dim=1)
        concept_adj = adjustment + torch.where(has_special, 0.01, 0.0)[:, None]
        concept_scores = (_cos(embeds, self.concept_embeds.float())
                          - self.concept_embeds_weights.float() + concept_adj)
        return {"has_nsfw": (concept_scores > 0).any(dim=1), "concept_scores": concept_scores,
                "special_scores": special_scores, "image_embeds": embeds}


def resize_uint8(images, size: int) -> torch.Tensor:
    """(N, H, W, 3) uint8 (numpy or tensor, on the checker's device) ->
    (N, 3, size, size) float32 in [0, 1], as PIL's ``resize(BICUBIC)`` of
    the JAX function gives it: bicubic with antialiasing, the width first,
    each pass rounded and clamped to uint8 levels (PIL keeps its
    intermediate image in uint8).  Within one level of PIL's result."""
    x = torch.as_tensor(images).permute(0, 3, 1, 2).float()
    for hw in ((x.shape[2], size), (size, size)):
        x = F.interpolate(x, size=hw, mode="bicubic", antialias=True, align_corners=False)
        x = x.round().clamp(0, 255)
    return x / 255.0


@torch.inference_mode()
def check_images(model: SafetyChecker, images: np.ndarray, adjustment: float = 0.0):
    """(N, H, W, 3) uint8 images -> (images with the flagged ones zeroed,
    flags).  Runs on the checker's device.  ``adjustment`` is taken and not
    applied, as the JAX ``check_images`` takes it: the flags are the
    checker's unadjusted ones (``SafetyChecker`` itself applies one)."""
    del adjustment
    device = next(model.parameters()).device
    x = resize_uint8(torch.from_numpy(np.ascontiguousarray(images)).to(device),
                     model.config.image_size)
    flags = [bool(f) for f in model(x)["has_nsfw"].cpu()]
    out = np.array(images, copy=True)
    out[np.asarray(flags, bool)] = 0
    return out, flags
