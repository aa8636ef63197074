"""SD3 ControlNet, an MMDiT-style control branch (port of
ml_stable_diffusion_tpu/models/controlnet_sd3.py).

A truncated stack of joint transformer blocks (every one with
``context_pre_only=False``) on the MMDiT's stem.  The control image enters as
VAE-encoded latents through a zero-initialised patch embedding added to the
patchified latents; each block's latent stream passes through a
zero-initialised linear projection and becomes a residual, float32 times
``conditioning_scale``, that the paired MMDiT adds to its own latent stream
(models/mmdit.py).  ``forward`` returns ``(residuals, None)``: the
pipelines' multi-net sum and CFG duplication treat both ControlNet families
alike, with no mid residual here.

Parameter names are the diffusers ``SD3ControlNetModel`` keys: the MMDiT
stem's (``pos_embed.proj``, ``pos_embed.pos_embed``, ``time_text_embed``,
``context_embedder``, ``transformer_blocks.{i}``), ``pos_embed_input.proj``
and ``controlnet_blocks.{i}``.  The joint attention goes through
``ops/attention.py:joint_dot_product_attention``: on the card the
multi-stream flash kernel, at batch N (the nets run on the positive
conditioning only).
"""

from __future__ import annotations

import dataclasses

from torch import nn

from .mmdit import JointTransformerBlock, MMDiTConfig, _PatchEmbed, _TimeTextEmbed
from .unet import get_timestep_embedding


@dataclasses.dataclass(frozen=True)
class SD3ControlNetConfig:
    """The MMDiT block geometry and the control branch's depth.

    ``mmdit.depth`` is not read: the branch has ``num_layers`` blocks (a
    diffusers ControlNet config records no depth of the paired MMDiT)."""

    mmdit: MMDiTConfig = MMDiTConfig()
    #: joint blocks of the branch (12 for the published SD3-medium nets)
    num_layers: int = 12
    #: InstantX SD3 nets (true) run with a zeroed pooled projection and take
    #: control latents without the VAE shift; SD3.5-family nets (false) take
    #: the pooled embedding and ``(mean - shift) * scale``
    force_zeros_for_pooled_projection: bool = True

    @classmethod
    def sd3_medium(cls, num_layers: int = 12) -> "SD3ControlNetConfig":
        return cls(mmdit=MMDiTConfig.sd3_medium(), num_layers=num_layers)


class _ControlPatchEmbed(nn.Module):
    """The control latents' patchify conv (no positional table)."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_channels, cfg.hidden_size, cfg.patch_size,
                              stride=cfg.patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class SD3ControlNetModel(nn.Module):
    """latents (B, C, H, W), timesteps (B,) or scalar, context (B, S,
    context_dim), pooled (B, pooled_dim), cond_latents (B, C, H, W): the
    VAE-encoded control image -> (tuple of ``num_layers`` (B, hp*wp, D)
    float32 residuals, None)."""

    def __init__(self, config: SD3ControlNetConfig):
        super().__init__()
        self.config = config
        mm = config.mmdit
        D = mm.hidden_size
        self.pos_embed = _PatchEmbed(mm)
        self.pos_embed_input = _ControlPatchEmbed(mm)
        self.time_text_embed = _TimeTextEmbed(mm)
        self.context_embedder = nn.Linear(mm.context_dim, D)
        self.transformer_blocks = nn.ModuleList(
            JointTransformerBlock(mm, context_pre_only=False) for _ in range(config.num_layers))
        self.controlnet_blocks = nn.ModuleList(nn.Linear(D, D)
                                               for _ in range(config.num_layers))

    def forward(self, latents, timesteps, context, pooled, cond_latents,
                conditioning_scale: float = 1.0):
        B = latents.shape[0]
        dtype = self.context_embedder.weight.dtype
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)
        x = self.pos_embed(latents.to(dtype)) + self.pos_embed_input(cond_latents.to(dtype))
        t_emb = get_timestep_embedding(timesteps, 256, flip_sin_to_cos=True, freq_shift=0)
        c = self.time_text_embed(t_emb.to(dtype), pooled.to(dtype))
        ctx = self.context_embedder(context.to(dtype))
        residuals = []
        for block, proj in zip(self.transformer_blocks, self.controlnet_blocks):
            x, ctx = block(x, ctx, c)
            residuals.append(conditioning_scale * proj(x).float())
        return tuple(residuals), None
