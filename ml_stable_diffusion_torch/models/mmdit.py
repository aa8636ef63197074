"""MMDiT, the multimodal diffusion transformer of SD3 (port of
ml_stable_diffusion_tpu/models/mmdit.py).

NCHW latents in, a float32 velocity out, NCHW; the model computes in the
dtype of its parameters.  Parameter names are the diffusers
``SD3Transformer2DModel`` keys (``pos_embed.proj``, ``pos_embed.pos_embed``,
``time_text_embed.timestep_embedder.linear_1``, ``context_embedder``,
``transformer_blocks.0.norm1.linear``, ``...attn.to_q``,
``...attn.add_q_proj``, ``...ff.net.0.proj``, ``...ff_context.net.2``,
``norm_out.linear``, ``proj_out``), so a converted checkpoint loads with
``load_state_dict(strict=True)``.  The math follows the Flax module:

- each block modulates with adaLN-Zero, split ``[shift, scale, gate, shift2,
  scale2, gate2]``; the last block's context stream and the final norm use
  the AdaLayerNormContinuous order ``[scale, shift]``;
- the blocks in ``dual_attention_layers`` (SD3.5-medium's MMDiT-X: 0-12)
  are diffusers' dual-attention blocks: a nine-way modulation (the six,
  then ``[shift, scale, gate]`` of ``attn2``, diffusers'
  ``SD3AdaLayerNormZeroX``) and ``attn2``, a self-attention over the
  latent stream alone with its own projections (and qk RMSNorm), which
  reads the same normalised latents under its own shift and scale and adds,
  gated, after the joint attention's output (ops/attention.py:
  dot_product_attention: on the card the flash kernel);
- the last block (``context_pre_only``) projects the context to q/k/v but
  has no ``to_add_out`` and no ``ff_context``;
- LayerNorms carry no affine parameters, eps 1e-6; qk RMSNorm (SD3.5) eps
  1e-6;
- the learned positional table is centre-cropped from its M x M grid;
- the latent and context streams attend jointly over their concatenated
  keys (ops/attention.py:joint_dot_product_attention): on the card one
  launch of the multi-stream flash kernel per block;
- SD3 ControlNet residuals (models/controlnet_sd3.py) add to the latent
  stream after the blocks.

Every attention call counts itself by kind in ``.launches`` of
``mmdit_joint_attention`` and ``mmdit_self_attention``
(pipelines/program.py:kernel_counters(), so a captured program's replay
credits them): 24 and 0 a SD3-medium forward, 24 and 13 a SD3.5-medium one.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import gelu_tanh
from ..ops.attention import dot_product_attention, joint_dot_product_attention
from .unet import TimestepEmbedding, get_timestep_embedding


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    depth: int = 24
    hidden_size: int = 1536  # = 64 * depth for SD3-medium
    num_heads: int = 24
    context_dim: int = 4096  # CLIP-L + CLIP-G (zero-padded) and T5 width
    pooled_dim: int = 2048
    pos_embed_max_size: int = 192
    #: SD3.5 uses RMS qk-normalization
    qk_norm: bool = False
    #: the blocks with a second, latent-only self-attention (MMDiT-X)
    dual_attention_layers: tuple[int, ...] = ()

    @classmethod
    def sd3_medium(cls) -> "MMDiTConfig":
        return cls()

    @classmethod
    def sd35_medium(cls) -> "MMDiTConfig":
        """stabilityai/stable-diffusion-3.5-medium ``transformer/config.json``:
        the MMDiT-X, 13 dual-attention blocks of 24."""
        return cls(depth=24, hidden_size=1536, num_heads=24, qk_norm=True,
                   pos_embed_max_size=384, dual_attention_layers=tuple(range(13)))

    @classmethod
    def sd35_large(cls) -> "MMDiTConfig":
        return cls(depth=38, hidden_size=2432, num_heads=38, qk_norm=True)


class AttentionCounter:
    """The MMDiT's attention calls of one kind, counted in ``.launches`` as
    the kernel wrappers count theirs."""

    def __init__(self):
        self.launches = 0


#: joint attention calls (the multi-stream flash kernel on the card)
mmdit_joint_attention = AttentionCounter()
#: MMDiT-X ``attn2`` calls (the flash kernel's self-attention on the card)
mmdit_self_attention = AttentionCounter()


def _layer_norm(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


class _RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * (var + 1e-6) ** -0.5).to(x.dtype) * self.weight.to(x.dtype)


class _AdaLN(nn.Module):
    """The modulation linear of diffusers' AdaLayerNormZero/Continuous:
    ``n`` chunks of width D from silu(c)."""

    def __init__(self, dim: int, n: int):
        super().__init__()
        self.linear = nn.Linear(dim, n * dim)

    def forward(self, c):
        return self.linear(F.silu(c))


class _GELUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)

    def forward(self, x):
        return gelu_tanh(self.proj(x))


class _FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        # diffusers' [GELU(proj), Dropout, Linear]
        self.net = nn.ModuleList([_GELUProj(dim, 4 * dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class _JointAttention(nn.Module):
    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool):
        super().__init__()
        D = cfg.hidden_size
        self.heads = cfg.num_heads
        self.to_q, self.to_k, self.to_v = (nn.Linear(D, D) for _ in range(3))
        self.add_q_proj, self.add_k_proj, self.add_v_proj = (nn.Linear(D, D)
                                                             for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(D, D)])
        if not context_pre_only:
            self.to_add_out = nn.Linear(D, D)
        if cfg.qk_norm:
            Dh = D // cfg.num_heads
            self.norm_q, self.norm_k = _RMSNorm(Dh), _RMSNorm(Dh)
            self.norm_added_q, self.norm_added_k = _RMSNorm(Dh), _RMSNorm(Dh)

    def forward(self, x, ctx):
        """-> (latent output, context output or None), both projected."""
        B, Nx, D = x.shape
        Nc = ctx.shape[1]
        H = self.heads

        def heads(proj, t, n):
            return proj(t).view(B, n, H, D // H)

        q_x, k_x, v_x = (heads(p, x, Nx) for p in (self.to_q, self.to_k, self.to_v))
        q_c, k_c, v_c = (heads(p, ctx, Nc)
                         for p in (self.add_q_proj, self.add_k_proj, self.add_v_proj))
        if hasattr(self, "norm_q"):
            q_x, k_x = self.norm_q(q_x), self.norm_k(k_x)
            q_c, k_c = self.norm_added_q(q_c), self.norm_added_k(k_c)
        k = torch.cat([k_x, k_c], dim=1)
        v = torch.cat([v_x, v_c], dim=1)
        mmdit_joint_attention.launches += 1
        attn_x, attn_c = joint_dot_product_attention([q_x, q_c], k, v)
        out_x = self.to_out[0](attn_x.reshape(B, Nx, D))
        if not hasattr(self, "to_add_out"):
            return out_x, None
        return out_x, self.to_add_out(attn_c.reshape(B, Nc, D))


class _SelfAttention(nn.Module):
    """MMDiT-X ``attn2``: self-attention over the latent stream (diffusers'
    ``Attention`` with biases, qk RMSNorm with ``qk_norm``)."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        D = cfg.hidden_size
        self.heads = cfg.num_heads
        self.to_q, self.to_k, self.to_v = (nn.Linear(D, D) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(D, D)])
        if cfg.qk_norm:
            Dh = D // cfg.num_heads
            self.norm_q, self.norm_k = _RMSNorm(Dh), _RMSNorm(Dh)

    def forward(self, x):
        B, N, D = x.shape
        q, k, v = (p(x).view(B, N, self.heads, D // self.heads)
                   for p in (self.to_q, self.to_k, self.to_v))
        if hasattr(self, "norm_q"):
            q, k = self.norm_q(q), self.norm_k(k)
        mmdit_self_attention.launches += 1
        return self.to_out[0](dot_product_attention(q, k, v).reshape(B, N, D))


class JointTransformerBlock(nn.Module):
    """Dual-stream block with joint attention and adaLN-Zero modulation;
    ``dual``: the MMDiT-X block, with ``attn2`` over the latent stream."""

    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool = False, dual: bool = False):
        super().__init__()
        D = cfg.hidden_size
        self.context_pre_only = context_pre_only
        self.norm1 = _AdaLN(D, 9 if dual else 6)
        self.norm1_context = _AdaLN(D, 2 if context_pre_only else 6)
        self.attn = _JointAttention(cfg, context_pre_only)
        if dual:
            self.attn2 = _SelfAttention(cfg)
        self.ff = _FeedForward(D)
        if not context_pre_only:
            self.ff_context = _FeedForward(D)

    def forward(self, x, ctx, c):
        dual = hasattr(self, "attn2")
        mod = self.norm1(c).chunk(9 if dual else 6, dim=-1)
        sh1, sc1, g1, sh2, sc2, g2 = mod[:6]
        if self.context_pre_only:
            csc1, csh1 = self.norm1_context(c).chunk(2, dim=-1)
        else:
            csh1, csc1, cg1, csh2, csc2, cg2 = self.norm1_context(c).chunk(6, dim=-1)

        n = _layer_norm(x)
        attn_x, attn_c = self.attn(_modulate(n, sh1, sc1),
                                   _modulate(_layer_norm(ctx), csh1, csc1))
        x = x + g1[:, None] * attn_x
        if dual:
            sh3, sc3, g3 = mod[6:]
            x = x + g3[:, None] * self.attn2(_modulate(n, sh3, sc3))
        x = x + g2[:, None] * self.ff(_modulate(_layer_norm(x), sh2, sc2))
        if self.context_pre_only:
            return x, ctx
        ctx = ctx + cg1[:, None] * attn_c
        ctx = ctx + cg2[:, None] * self.ff_context(_modulate(_layer_norm(ctx), csh2, csc2))
        return x, ctx


class _PatchEmbed(nn.Module):
    """Patchify conv plus the centre-cropped learned positional table."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        P, D, M = cfg.patch_size, cfg.hidden_size, cfg.pos_embed_max_size
        self.max_size = M
        self.proj = nn.Conv2d(cfg.in_channels, D, P, stride=P)
        self.pos_embed = nn.Parameter(torch.zeros(1, M * M, D))

    def forward(self, latents):
        x = self.proj(latents)  # (B, D, hp, wp)
        hp, wp = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)  # (B, hp*wp, D), row-major patches
        M, D = self.max_size, x.shape[-1]
        top, left = (M - hp) // 2, (M - wp) // 2
        pos = self.pos_embed.view(1, M, M, D)[:, top:top + hp, left:left + wp]
        return x + pos.reshape(1, hp * wp, D).to(x.dtype)


class _TimeTextEmbed(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.timestep_embedder = TimestepEmbedding(256, cfg.hidden_size)
        self.text_embedder = TimestepEmbedding(cfg.pooled_dim, cfg.hidden_size)

    def forward(self, t_emb, pooled):
        return self.timestep_embedder(t_emb) + self.text_embedder(pooled)


class MMDiT(nn.Module):
    """latents (B, C, H, W), timesteps (B,) or scalar float (sigma * 1000),
    context (B, S, context_dim), pooled (B, pooled_dim) -> velocity
    (B, out_channels, H, W) float32."""

    def __init__(self, config: MMDiTConfig):
        super().__init__()
        self.config = config
        D = config.hidden_size
        self.pos_embed = _PatchEmbed(config)
        self.time_text_embed = _TimeTextEmbed(config)
        self.context_embedder = nn.Linear(config.context_dim, D)
        self.transformer_blocks = nn.ModuleList(
            JointTransformerBlock(config, context_pre_only=i == config.depth - 1,
                                  dual=i in config.dual_attention_layers)
            for i in range(config.depth))
        self.norm_out = _AdaLN(D, 2)
        self.proj_out = nn.Linear(D, config.patch_size ** 2 * config.out_channels)

    def forward(self, latents, timesteps, context, pooled, controlnet_residuals=None):
        """``controlnet_residuals``: the SD3 ControlNets' (B, hp*wp, D)
        residuals; block i adds residual i // ceil(depth / n), cast to the
        stream's dtype, and the last block (``context_pre_only``) adds none,
        as in the JAX module (so 18 residuals serve 24 blocks two a
        residual)."""
        cfg = self.config
        P, C = cfg.patch_size, cfg.out_channels
        B, _, H, W = latents.shape
        # the positional table: a W8A8 proj_out holds no float weight
        dtype = self.pos_embed.pos_embed.dtype
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)

        x = self.pos_embed(latents.to(dtype))
        t_emb = get_timestep_embedding(timesteps, 256, flip_sin_to_cos=True, freq_shift=0)
        c = self.time_text_embed(t_emb.to(dtype), pooled.to(dtype))
        ctx = self.context_embedder(context.to(dtype))
        for i, block in enumerate(self.transformer_blocks):
            x, ctx = block(x, ctx, c)
            if controlnet_residuals and not block.context_pre_only:
                interval = -(-cfg.depth // len(controlnet_residuals))
                x = x + controlnet_residuals[i // interval].to(x.dtype)

        scale, shift = self.norm_out(c).chunk(2, dim=-1)
        x = self.proj_out(_modulate(_layer_norm(x), shift, scale))
        # unpatchify: (B, hp, wp, P, P, C) -> (B, C, hp, P, wp, P) -> NCHW
        x = x.reshape(B, H // P, W // P, P, P, C).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(B, C, H, W).float()
