"""CLIP vision encoder checkpoints (port of
ml_stable_diffusion_tpu/convert/clip_vision.py): a transformers
``CLIPVisionModelWithProjection`` directory -> ``CLIPVisionEncoder``."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from ..models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
from .load import _build, load_safetensors_state_dict


def load_clip_vision(directory: str | Path, dtype=torch.float32,
                     device: str | torch.device = "cuda") -> CLIPVisionEncoder:
    """``config.json`` (its ``vision_config`` if nested, the outer
    ``projection_dim`` over the inner one) and safetensors -> the encoder
    on ``device`` in ``dtype``, loaded strictly.  The safety checker's
    doubled ``vision_model.vision_model.`` prefix and the ``pre_layernorm``
    spelling are read too, as the JAX converter reads them (transformers'
    own key is ``pre_layrnorm``)."""
    directory = Path(directory)
    raw = json.loads((directory / "config.json").read_text())
    config = CLIPVisionConfig.from_diffusers(raw.get("vision_config", raw))
    if "projection_dim" in raw:
        config = dataclasses.replace(config, projection_dim=raw["projection_dim"])
    sd = {}
    for key, value in load_safetensors_state_dict(directory).items():
        if key.startswith("vision_model.vision_model."):
            key = key[len("vision_model."):]
        sd[key.replace(".pre_layernorm.", ".pre_layrnorm.")] = value
    return _build(CLIPVisionEncoder, config, sd, dtype, device)
