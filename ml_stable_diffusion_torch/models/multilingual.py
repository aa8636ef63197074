"""Multilingual text-encoder projection (port of
ml_stable_diffusion_tpu/models/multilingual.py).

A linear map of an external multilingual embedding, (B, S, ``EMBED_DIM``),
into the denoiser's cross-attention width; the pipeline takes it with a host
``embed_fn(text) -> (S, EMBED_DIM)`` in place of the CLIP text encoder and
cuts or zero-pads every prompt to ``MAX_SEQUENCE_LENGTH`` rows.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

MAX_SEQUENCE_LENGTH = 256
EMBED_DIM = 512


class MultilingualProjection(nn.Module):
    """(B, S, EMBED_DIM) external embeddings -> (B, S, hidden_size), in the
    dtype of its parameters."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.linear = nn.Linear(EMBED_DIM, hidden_size)

    def forward(self, embeddings):
        return self.linear(embeddings.to(self.linear.weight.dtype))


def port_multilingual_projection(state_dict) -> dict[str, torch.Tensor]:
    """A torch ``nn.Linear`` state dict (``weight``, ``bias``) ->
    ``MultilingualProjection``'s, float32."""
    return {f"linear.{k}": torch.tensor(np.asarray(v, np.float32)) for k, v in state_dict.items()}
