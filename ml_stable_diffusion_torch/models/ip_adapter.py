"""IP-Adapter image projections (port of
ml_stable_diffusion_tpu/models/ip_adapter.py).

The IP-Adapter conditions the UNet on a reference image: a CLIP image
embedding becomes a few extra context tokens, and every cross attention
gains a decoupled K/V pair over them whose attention output, scaled, is
added before the out-projection (``models/unet.py`` ``Attention``).  The
two published projection heads, with h94/IP-Adapter's parameter names so a
checkpoint's ``image_proj`` group loads strictly:

- BASE (``proj.*``, ``norm.*``): ``IPImageProjection``, a Linear over the
  projected CLIP image embedding reshaped to tokens, then a LayerNorm;
- PLUS (``latents``, ``proj_in.*``, ``layers.{i}.0.*`` attention,
  ``layers.{i}.1.{0,1,3}.*`` feed-forward, ``proj_out.*``, ``norm_out.*``):
  ``IPResampler``, learned query latents that cross-attend to the CLIP
  penultimate patch states through ``depth`` attention + FF blocks.

As in the JAX modules: the perceiver softmax runs in float32, the
feed-forward GELU is the exact erf form, LayerNorm eps is 1e-5, and the
attention here is plain matmuls (16 queries over a few hundred keys).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.activations import gelu_erf


class IPImageProjection(nn.Module):
    """CLIP image embedding (B, E) -> (B, num_tokens, cross_attention_dim)
    context tokens."""

    def __init__(self, embed_dim: int, cross_attention_dim: int, num_tokens: int = 4):
        super().__init__()
        self.cross_attention_dim = cross_attention_dim
        self.num_tokens = num_tokens
        self.proj = nn.Linear(embed_dim, num_tokens * cross_attention_dim)
        self.norm = nn.LayerNorm(cross_attention_dim, eps=1e-5)

    def forward(self, image_embeds):
        x = self.proj(image_embeds.to(self.proj.weight.dtype))
        return self.norm(x.reshape(x.shape[0], self.num_tokens, self.cross_attention_dim))


class _PerceiverAttention(nn.Module):
    """Latents cross-attend to [patch tokens ++ latents]: both streams
    pre-LN, q from the latents, k and v from the concatenation, logits
    scaled by 1/sqrt(dim_head) in float32; the residual is the caller's."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        x = self.norm1(x)
        latents = self.norm2(latents)
        B, Lq, _ = latents.shape
        kv_in = torch.cat([x, latents], dim=1)
        Lk = kv_in.shape[1]
        H, Dh = self.heads, self.dim_head
        q = self.to_q(latents).reshape(B, Lq, H, Dh).transpose(1, 2)
        k, v = self.to_kv(kv_in).chunk(2, dim=-1)
        k = k.reshape(B, Lk, H, Dh).transpose(1, 2)
        v = v.reshape(B, Lk, H, Dh).transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(Dh)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, Lq, H * Dh)
        return self.to_out(out)


class _GELU(nn.Module):
    """The exact erf GELU (``ops.activations.gelu_erf``), as a module so the
    feed-forward keeps the checkpoint's Sequential indices."""

    def forward(self, x):
        return gelu_erf(x)


class IPResampler(nn.Module):
    """ip-adapter-plus projection: ``num_queries`` learned latents resampled
    against the CLIP penultimate patch states (B, tokens, embedding_dim) ->
    (B, num_queries, output_dim).  The first seven arguments are
    ``convert.ip_adapter.resampler_geometry``'s (the JAX module's fields);
    ``embedding_dim`` is the vision tower's width."""

    def __init__(self, output_dim: int, dim: int = 768, depth: int = 4, heads: int = 12,
                 dim_head: int = 64, num_queries: int = 16, ff_mult: int = 4,
                 embedding_dim: int = 1280):
        super().__init__()
        self.latents = nn.Parameter(torch.zeros(1, num_queries, dim))
        self.proj_in = nn.Linear(embedding_dim, dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([_PerceiverAttention(dim, heads, dim_head),
                           nn.Sequential(nn.LayerNorm(dim, eps=1e-5),
                                         nn.Linear(dim, dim * ff_mult, bias=False),
                                         _GELU(),
                                         nn.Linear(dim * ff_mult, dim, bias=False))])
            for _ in range(depth))
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = nn.LayerNorm(output_dim, eps=1e-5)

    def forward(self, patch_states):
        dtype = self.proj_in.weight.dtype
        x = self.proj_in(patch_states.to(dtype))
        latents = self.latents.to(dtype).expand(x.shape[0], -1, -1)
        for attn, ff in self.layers:
            latents = latents + attn(x, latents)
            latents = latents + ff(latents)
        return self.norm_out(self.proj_out(latents))
