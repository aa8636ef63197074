"""CLIP vision encoder, transformers ``CLIPVisionModelWithProjection``
(port of ml_stable_diffusion_tpu/models/clip_vision.py).

The IP-Adapter's reference-image encoder.  The tower is the safety
checker's (models/safety.py: its embeddings, pre-LN encoder layers and
LayerNorms) under the standalone model's keys
(``vision_model.embeddings.patch_embedding.weight``, ...,
``visual_projection.weight``).  As in the JAX package:

- the MLP activation is quick_gelu whatever the checkpoint's config names
  (the JAX tower hard-codes it; OpenCLIP ViT-H/14 and bigG name "gelu");
- attention is always the plain path (the JAX tower forces XLA), though
  its heads over 257 tokens would qualify for the flash kernel;
- ``image_embeds`` is the raw projected embedding, not normalized.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .safety import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, _VisionTransformer


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5

    #: the tower's MLP activation (a class attribute, not a field: the JAX
    #: config has none, and its tower runs quick_gelu)
    hidden_act = "quick_gelu"

    @classmethod
    def from_diffusers(cls, raw: dict) -> "CLIPVisionConfig":
        """A transformers vision ``config.json`` (its ``vision_config``);
        ``hidden_act`` is not read."""
        return cls(
            image_size=raw.get("image_size", 224),
            patch_size=raw.get("patch_size", 14),
            hidden_size=raw.get("hidden_size", 1024),
            intermediate_size=raw.get("intermediate_size", 4096),
            num_hidden_layers=raw.get("num_hidden_layers", 24),
            num_attention_heads=raw.get("num_attention_heads", 16),
            projection_dim=raw.get("projection_dim", 1024),
        )


class CLIPVisionEncoder(nn.Module):
    """``forward(images (B, 3, S, S) in [0, 1])`` -> ``image_embeds`` (B,
    projection_dim), ``pooled_output`` (B, hidden), the post-LN class
    state, and ``penultimate`` (B, tokens, hidden), the hidden states that
    enter the last layer (what ip-adapter-plus resamples).  Computes in the
    dtype of its parameters."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim,
                                           bias=False)
        self._stats: dict = {}

    def _pixel_stats(self, device):
        """The CLIP mean and std as (3, 1, 1) tensors on ``device``, made
        once: a host copy inside a captured program is not allowed."""
        if device not in self._stats:
            self._stats[device] = tuple(torch.from_numpy(a).to(device)[:, None, None]
                                        for a in (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD))
        return self._stats[device]

    def forward(self, images):
        dtype = self.visual_projection.weight.dtype
        mean, std = self._pixel_stats(images.device)
        x = ((images.float() - mean) / std).to(dtype)
        vm = self.vision_model
        h = vm.pre_layrnorm(vm.embeddings(x))
        layers = vm.encoder.layers
        for layer in layers[:-1]:
            h = layer(h)
        penultimate = h
        h = layers[-1](h)
        pooled = vm.post_layernorm(h[:, 0])
        return {"image_embeds": self.visual_projection(pooled), "pooled_output": pooled,
                "penultimate": penultimate}
