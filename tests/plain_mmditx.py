"""A plain float32 MMDiT-X: the SD3 / SD3.5 transformer denoiser in plain
``torch``, written from diffusers' ``SD3Transformer2DModel``,
``JointTransformerBlock``, ``SD3AdaLayerNormZeroX`` and the joint attention
processor, with their parameter names, so that a state dict of the port's
``MMDiT`` (or of a diffusers checkpoint) loads with ``strict=True``.

It imports no JAX and nothing of the port.  Attention is an explicit
softmax over float32 logits.  The configuration is a dict of the port's
``MMDiTConfig`` field names (``patch_size``, ``in_channels``,
``out_channels``, ``depth``, ``hidden_size``, ``num_heads``,
``context_dim``, ``pooled_dim``, ``pos_embed_max_size``, ``qk_norm``,
``dual_attention_layers``).

The block, for the latent stream x, the context stream c and the
conditioning vector y (timestep and pooled text embeddings):

- ``[shift, scale, gate] x 2`` (x 3 in a dual block) from
  ``norm1.linear(silu(y))``; ``n = LN(x)`` without affine, eps 1e-6;
- joint attention of ``n (1 + scale) + shift`` and the context's own
  modulated LN over the concatenated [latent, context] keys, per-head RMS
  qk-normalisation (eps 1e-6) with ``qk_norm``; each stream has its own
  projections; x += gate * out;
- a dual block (``dual_attention_layers``) then adds
  ``gate2 * attn2(n (1 + scale2) + shift2)``: a self-attention over the
  latent stream alone, of the same normalised n;
- the MLP (tanh GELU, 4x) on the modulated ``LN(x)``, gated;
- the context stream likewise, except the last block
  (``context_pre_only``), whose context is only projected to keys and
  values, modulated by ``[scale, shift]``.

Departures from the published model:

- the positional table ``pos_embed.pos_embed`` is a parameter (diffusers
  holds a fixed 2-D sin-cos buffer of the same name and shape), so that
  seeded weights reach it too;
- no skip-layer guidance and no ControlNet residuals: they belong to the
  pipeline, not to the forward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def attention(q, k, v):
    """(B, S, H, D) -> (B, Sq, H, D): softmax(q k^T / sqrt(D)) v over
    float32 logits, one sample at a time (the logits of a whole batch at
    4250 tokens would take gigabytes)."""
    D = q.shape[-1]
    out = []
    for i in range(q.shape[0]):
        logits = torch.einsum("qhd,khd->hqk", q[i], k[i]) * (D ** -0.5)
        out.append(torch.einsum("hqk,khd->qhd", torch.softmax(logits, dim=-1), v[i]))
    return torch.stack(out)


def timestep_embedding(t, dim: int = 256):
    """diffusers' ``Timesteps(dim, flip_sin_to_cos=True, shift=0)``."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / half))
    emb = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def layer_norm(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6) * self.weight


class AdaLN(nn.Module):
    def __init__(self, dim: int, n: int):
        super().__init__()
        self.linear = nn.Linear(dim, n * dim)

    def forward(self, y):
        return self.linear(F.silu(y))


class MLP2(nn.Module):
    """``linear_2(silu(linear_1(x)))``: diffusers' ``TimestepEmbedding`` and
    ``PixArtAlphaTextProjection``."""

    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d)
        self.linear_2 = nn.Linear(d, d)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _GELU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([_GELU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


class JointAttention(nn.Module):
    def __init__(self, c: dict, context_pre_only: bool):
        super().__init__()
        D, self.heads = c["hidden_size"], c["num_heads"]
        self.to_q, self.to_k, self.to_v = (nn.Linear(D, D) for _ in range(3))
        self.add_q_proj, self.add_k_proj, self.add_v_proj = (nn.Linear(D, D) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(D, D)])
        if not context_pre_only:
            self.to_add_out = nn.Linear(D, D)
        if c["qk_norm"]:
            Dh = D // self.heads
            self.norm_q, self.norm_k = RMSNorm(Dh), RMSNorm(Dh)
            self.norm_added_q, self.norm_added_k = RMSNorm(Dh), RMSNorm(Dh)

    def forward(self, x, ctx):
        B, Nx, D = x.shape

        def heads(p, t):
            return p(t).view(B, t.shape[1], self.heads, D // self.heads)

        q, k, v = (heads(p, x) for p in (self.to_q, self.to_k, self.to_v))
        qc, kc, vc = (heads(p, ctx) for p in (self.add_q_proj, self.add_k_proj,
                                              self.add_v_proj))
        if hasattr(self, "norm_q"):
            q, k = self.norm_q(q), self.norm_k(k)
            qc, kc = self.norm_added_q(qc), self.norm_added_k(kc)
        out = attention(torch.cat([q, qc], 1), torch.cat([k, kc], 1), torch.cat([v, vc], 1))
        out = out.reshape(B, -1, D)
        out_x = self.to_out[0](out[:, :Nx])
        return out_x, (self.to_add_out(out[:, Nx:]) if hasattr(self, "to_add_out") else None)


class SelfAttention(nn.Module):
    """``attn2`` of a dual block."""

    def __init__(self, c: dict):
        super().__init__()
        D, self.heads = c["hidden_size"], c["num_heads"]
        self.to_q, self.to_k, self.to_v = (nn.Linear(D, D) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(D, D)])
        if c["qk_norm"]:
            self.norm_q, self.norm_k = RMSNorm(D // self.heads), RMSNorm(D // self.heads)

    def forward(self, x):
        B, N, D = x.shape
        q, k, v = (p(x).view(B, N, self.heads, D // self.heads)
                   for p in (self.to_q, self.to_k, self.to_v))
        if hasattr(self, "norm_q"):
            q, k = self.norm_q(q), self.norm_k(k)
        return self.to_out[0](attention(q, k, v).reshape(B, N, D))


class Block(nn.Module):
    def __init__(self, c: dict, context_pre_only: bool, dual: bool):
        super().__init__()
        D = c["hidden_size"]
        self.context_pre_only, self.dual = context_pre_only, dual
        self.norm1 = AdaLN(D, 9 if dual else 6)
        self.norm1_context = AdaLN(D, 2 if context_pre_only else 6)
        self.attn = JointAttention(c, context_pre_only)
        if dual:
            self.attn2 = SelfAttention(c)
        self.ff = FeedForward(D)
        if not context_pre_only:
            self.ff_context = FeedForward(D)

    def forward(self, x, ctx, y):
        m = self.norm1(y).chunk(9 if self.dual else 6, dim=-1)
        n = layer_norm(x)
        if self.context_pre_only:
            c_scale, c_shift = self.norm1_context(y).chunk(2, dim=-1)
        else:
            c_shift, c_scale, c_gate, c_shift2, c_scale2, c_gate2 = \
                self.norm1_context(y).chunk(6, dim=-1)
        out_x, out_c = self.attn(modulate(n, m[0], m[1]),
                                 modulate(layer_norm(ctx), c_shift, c_scale))
        x = x + m[2][:, None] * out_x
        if self.dual:
            x = x + m[8][:, None] * self.attn2(modulate(n, m[6], m[7]))
        x = x + m[5][:, None] * self.ff(modulate(layer_norm(x), m[3], m[4]))
        if self.context_pre_only:
            return x, ctx
        ctx = ctx + c_gate[:, None] * out_c
        ctx = ctx + c_gate2[:, None] * self.ff_context(modulate(layer_norm(ctx), c_shift2,
                                                                c_scale2))
        return x, ctx


class PatchEmbed(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        P, D, M = c["patch_size"], c["hidden_size"], c["pos_embed_max_size"]
        self.proj = nn.Conv2d(c["in_channels"], D, P, stride=P)
        self.pos_embed = nn.Parameter(torch.zeros(1, M * M, D))

    def forward(self, latents):
        x = self.proj(latents)
        B, D, hp, wp = x.shape
        M = math.isqrt(self.pos_embed.shape[1])
        top, left = (M - hp) // 2, (M - wp) // 2
        pos = self.pos_embed.view(1, M, M, D)[:, top:top + hp, left:left + wp]
        return x.flatten(2).transpose(1, 2) + pos.reshape(1, hp * wp, D)


class TimeTextEmbed(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.timestep_embedder = MLP2(256, c["hidden_size"])
        self.text_embedder = MLP2(c["pooled_dim"], c["hidden_size"])


class MMDiTX(nn.Module):
    """latents (B, C, H, W), timesteps (B,) or a scalar (sigma * 1000),
    context (B, S, context_dim), pooled (B, pooled_dim) -> velocity
    (B, out_channels, H, W), all float32."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = dict(c)
        D, depth = c["hidden_size"], c["depth"]
        dual = set(c.get("dual_attention_layers") or ())
        self.pos_embed = PatchEmbed(c)
        self.time_text_embed = TimeTextEmbed(c)
        self.context_embedder = nn.Linear(c["context_dim"], D)
        self.transformer_blocks = nn.ModuleList(
            Block(c, context_pre_only=i == depth - 1, dual=i in dual) for i in range(depth))
        self.norm_out = AdaLN(D, 2)
        self.proj_out = nn.Linear(D, c["patch_size"] ** 2 * c["out_channels"])

    def forward(self, latents, timesteps, context, pooled):
        P, C = self.c["patch_size"], self.c["out_channels"]
        B, _, H, W = latents.shape
        t = timesteps.float().reshape(-1).expand(B)
        tte = self.time_text_embed
        y = tte.timestep_embedder(timestep_embedding(t)) + tte.text_embedder(pooled)
        x, ctx = self.pos_embed(latents), self.context_embedder(context)
        for block in self.transformer_blocks:
            x, ctx = block(x, ctx, y)
        scale, shift = self.norm_out(y).chunk(2, dim=-1)
        x = self.proj_out(modulate(layer_norm(x), shift, scale))
        x = x.reshape(B, H // P, W // P, P, P, C).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(B, C, H, W)
