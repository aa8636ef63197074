"""T5 v1.1 text encoder, SD3's third encoder (port of
ml_stable_diffusion_tpu/models/t5.py).

RMS-norm pre-norm blocks, attention without 1/sqrt(d) scaling whose logits
take a bucketed relative-position bias (one table, block 0's, shared by
every block), and a gated-GELU feed-forward ``gelu_tanh(wi_0 y) * wi_1 y``.
Parameter names are transformers' ``T5EncoderModel`` keys (``shared``,
``encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}``,
``encoder.block.0.layer.0.SelfAttention.relative_attention_bias``,
``encoder.block.{i}.layer.{0,1}.layer_norm``,
``encoder.block.{i}.layer.1.DenseReluDense.{wi_0,wi_1,wo}``,
``encoder.final_layer_norm``), so a checkpoint loads with
``load_state_dict(strict=True)`` once ``hf_state_dict`` has dropped the
embedding's tied alias.

The module computes in the dtype of its weights, as the Flax module computes
in its ``dtype`` over float32 parameters (bf16 on the card: the same values
as Flax's cast at each Dense).  The relative-position table stays float32
through ``.to(dtype)``, and so do the logits, the position and mask biases
(-1e9 on padding) and the softmax; the buckets are computed on the host in
float64, as the JAX function computes them.  The attention covers at most a
few hundred tokens and stays plain torch math, an op the JAX package left
to XLA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..ops.activations import gelu_tanh


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6

    @classmethod
    def xxl(cls) -> "T5Config":
        """google/t5-v1_1-xxl, the SD3 text encoder 3."""
        return cls()


class T5LayerNorm(nn.Module):
    """RMS norm without mean subtraction, statistics in float32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        dtype = self.weight.dtype
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * (var + self.eps) ** -0.5).to(dtype) * self.weight


def relative_position_buckets(qlen: int, klen: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """Bidirectional T5 relative-position buckets, (qlen, klen) int64, in
    numpy float64 (an f32 ``log`` can move a distance across a bucket
    edge)."""
    ctx = np.arange(qlen)[:, None]
    mem = np.arange(klen)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(rel.clip(1) / max_exact) / np.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(is_small, rel, large)


class _Float32Table(nn.Module):
    """The relative-position table, (buckets, heads): float32 whatever dtype
    the module is moved to (``_apply`` moves it to the new device only)."""

    def __init__(self, num_buckets: int, num_heads: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num_buckets, num_heads))

    def _apply(self, fn, recurse=True):
        w = self.weight
        device = fn(torch.empty(0, device=w.device)).device
        if w.device != device:
            moved = (torch.empty_like(w, dtype=torch.float32, device=device) if w.is_meta
                     else w.detach().to(device=device, dtype=torch.float32))
            self.weight = nn.Parameter(moved, requires_grad=w.requires_grad)
        return self


class _SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias_table: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q, self.k, self.v = (nn.Linear(cfg.d_model, inner, bias=False) for _ in range(3))
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias_table:
            self.relative_attention_bias = _Float32Table(cfg.relative_attention_num_buckets,
                                                         cfg.num_heads)

    def forward(self, y, bias):
        """``bias`` (B or 1, H, S, S) float32: position plus mask."""
        B, S, _ = y.shape
        q, k, v = (proj(y).view(B, S, self.heads, self.d_kv).transpose(1, 2)
                   for proj in (self.q, self.k, self.v))
        # float32 logits of the compute-dtype q and k, no 1/sqrt(d) scaling
        logits = q.float() @ k.float().transpose(-1, -2) + bias
        w = torch.softmax(logits, dim=-1).to(y.dtype)
        attn = (w.float() @ v.float()).to(y.dtype)
        return self.o(attn.transpose(1, 2).reshape(B, S, self.heads * self.d_kv))


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias_table: bool):
        super().__init__()
        self.SelfAttention = _SelfAttention(cfg, has_bias_table)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class _DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, y):
        return self.wo(gelu_tanh(self.wi_0(y)) * self.wi_1(y))


class _FeedForwardLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _DenseGatedGelu(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5Block(nn.Module):
    """Pre-norm self-attention, then the pre-norm gated-GELU feed-forward,
    each added to the residual stream."""

    def __init__(self, cfg: T5Config, has_bias_table: bool = False):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg, has_bias_table),
                                    _FeedForwardLayer(cfg)])

    def forward(self, x, bias):
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(T5Block(cfg, has_bias_table=i == 0)
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5Encoder(nn.Module):
    """ids (B, S) integer, attention_mask (B, S) {0, 1} or None ->
    {"encoder_hidden_states": (B, S, d_model)} in the compute dtype (the
    reference wrapper's output name, as the JAX module returns it)."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = _Stack(config)
        #: (S, device) -> the relative-position buckets, made once: a host
        #: copy inside a captured program is not allowed
        self._buckets: dict = {}

    def _position_buckets(self, S: int, device) -> torch.Tensor:
        key = (S, device)
        if key not in self._buckets:
            cfg = self.config
            self._buckets[key] = torch.from_numpy(relative_position_buckets(
                S, S, cfg.relative_attention_num_buckets,
                cfg.relative_attention_max_distance)).to(device)
        return self._buckets[key]

    def forward(self, input_ids, attention_mask=None):
        x = self.shared(input_ids)
        buckets = self._position_buckets(input_ids.shape[1], x.device)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        bias = table.float()[buckets].permute(2, 0, 1)[None]  # (1, H, S, S)
        if attention_mask is not None:
            mask = attention_mask.to(x.device)[:, None, None, :] > 0
            bias = bias + torch.where(mask, 0.0, -1e9).to(torch.float32)
        for block in self.encoder.block:
            x = block(x, bias)
        return {"encoder_hidden_states": self.encoder.final_layer_norm(x)}


def hf_state_dict(sd: dict) -> dict:
    """A transformers ``T5EncoderModel`` state dict -> this module's: the
    embedding's tied alias ``encoder.embed_tokens.weight`` is dropped (or
    taken as ``shared.weight`` where a checkpoint kept only the alias)."""
    sd = dict(sd)
    alias = sd.pop("encoder.embed_tokens.weight", None)
    if "shared.weight" not in sd and alias is not None:
        sd["shared.weight"] = alias
    return sd
