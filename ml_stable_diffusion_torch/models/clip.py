"""CLIP text encoder (port of ml_stable_diffusion_tpu/models/clip.py).

Parameter names are transformers' ``CLIPTextModel`` keys
(``text_model.encoder.layers.0.self_attn.q_proj.weight``, ...), so a
converted checkpoint loads with ``load_state_dict(strict=True)``.  The
forward returns the JAX module's dict: ``last_hidden_state`` (after the
final LayerNorm), every layer's output, the penultimate layer's output and
the pooled state at the first EOS token.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.activations import gelu_erf, quick_gelu
from ..ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"  # "quick_gelu" for SD1.x ViT-L
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    #: output a projected pooled vector (SDXL text encoder 2 / bigG)
    use_text_projection: bool = False
    projection_dim: int = 1280

    @classmethod
    def sd1(cls) -> "CLIPTextConfig":
        """openai/clip-vit-large-patch14 (SD 1.x; SD3's first encoder)."""
        return cls(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                   num_attention_heads=12, hidden_act="quick_gelu")

    @classmethod
    def sd2(cls) -> "CLIPTextConfig":
        """OpenCLIP ViT-H trimmed to 23 layers (SD 2.x checkpoints ship 23)."""
        return cls()

    @classmethod
    def sdxl_g(cls) -> "CLIPTextConfig":
        """OpenCLIP bigG (SDXL text encoder 2; SD3's second encoder)."""
        return cls(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                   num_attention_heads=20, use_text_projection=True,
                   projection_dim=1280)


def _activation(name: str):
    if name == "quick_gelu":
        return quick_gelu
    if name == "gelu":
        return gelu_erf
    raise ValueError(f"unknown activation {name!r}")


class _SelfAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, causal: bool = True):
        super().__init__()
        C = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.causal = causal
        self.q_proj = nn.Linear(C, C)
        self.k_proj = nn.Linear(C, C)
        self.v_proj = nn.Linear(C, C)
        self.out_proj = nn.Linear(C, C)

    def forward(self, x):
        B, S, C = x.shape
        H = self.heads
        q = self.q_proj(x).view(B, S, H, C // H)
        k = self.k_proj(x).view(B, S, H, C // H)
        v = self.v_proj(x).view(B, S, H, C // H)
        attn = dot_product_attention(q, k, v, causal=self.causal, impl="plain")
        return self.out_proj(attn.reshape(B, S, C))


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.act = _activation(cfg.hidden_act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """Pre-LN transformer layer, causal for the text encoder.  ``cfg``
    needs ``hidden_size``, ``num_attention_heads``, ``intermediate_size``,
    ``hidden_act`` and ``layer_norm_eps`` (the safety checker's vision tower
    passes its own config, non-causal).  Attention is always the plain
    path."""

    def __init__(self, cfg: CLIPTextConfig, causal: bool = True):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = _SelfAttention(cfg, causal)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(cfg)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)

    def forward(self, input_ids):
        S = input_ids.shape[1]
        return self.token_embedding(input_ids) + self.position_embedding.weight[None, :S]


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)
        if config.use_text_projection:
            self.text_projection = nn.Linear(config.hidden_size, config.projection_dim,
                                             bias=False)

    def forward(self, input_ids):
        cfg = self.config
        tm = self.text_model
        x = tm.embeddings(input_ids)
        hidden_states = []
        for layer in tm.encoder.layers:
            x = layer(x)
            hidden_states.append(x)
        last = tm.final_layer_norm(x)

        # pooled = hidden state at the first EOS position
        eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos_pos]
        if cfg.use_text_projection:
            pooled = self.text_projection(pooled)
        return {
            "last_hidden_state": last,
            "hidden_states": tuple(hidden_states),
            "penultimate_hidden_state": (hidden_states[-2] if cfg.num_hidden_layers > 1
                                         else x),
            "pooled_output": pooled,
        }
