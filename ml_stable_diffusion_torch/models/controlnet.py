"""ControlNet (port of ml_stable_diffusion_tpu/models/controlnet.py).

The UNet's down and mid blocks (``models/unet.py:down_and_mid_blocks``,
the same diffusers keys) with a conditioning-image embedding added to
conv_in's output and one 1x1 "zero conv" per skip connection plus one
after the mid block.  The residuals come out in float32 times
``conditioning_scale``; the pipeline sums several nets' in order.

As in the JAX module, the resnets run plain ``nn.GroupNorm`` + SiLU and
the feed-forwards the exact GELU whatever the config's ``fused_groupnorm``,
``lowmem_groupnorm`` and ``fast_gelu`` say, and there is no guidance
embedding.  SDXL-family nets (``addition_embed_type="text_time"``) take the
UNet's ``added_cond``.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .unet import (
    TimestepEmbedding,
    UNetConfig,
    down_and_mid_blocks,
    run_down,
    run_mid,
    time_and_added_embedding,
)


class ControlNetConditioningEmbedding(nn.Module):
    """RGB conditioning image (B, 3, H, W) -> a feature map at latent
    resolution (H / 8): 3x3 convs with SiLU, three of them of stride 2."""

    def __init__(self, out_channels: int, block_channels=(16, 32, 96, 256)):
        super().__init__()
        self.conv_in = nn.Conv2d(3, block_channels[0], 3, padding=1)
        blocks = []
        for c_in, c_out in zip(block_channels[:-1], block_channels[1:]):
            blocks.append(nn.Conv2d(c_in, c_in, 3, padding=1))
            blocks.append(nn.Conv2d(c_in, c_out, 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(block_channels[-1], out_channels, 3, padding=1)

    def forward(self, cond):
        h = F.silu(self.conv_in(cond))
        for conv in self.blocks:
            h = F.silu(conv(h))
        return self.conv_out(h)


class ControlNetModel(nn.Module):
    """``forward(sample (B, C, h, w), timesteps, encoder_hidden_states,
    cond_image (B, 3, 8h, 8w) in [0, 1], conditioning_scale, added_cond)``
    -> (down residuals, mid residual), float32; computes in the dtype of its
    parameters."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        ch = cfg.block_out_channels
        self.time_embedding = TimestepEmbedding(ch[0], cfg.time_embed_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, cfg.time_embed_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(ch[0])
        self.down_blocks, self.mid_block, skip_ch = down_and_mid_blocks(cfg)
        self.controlnet_down_blocks = nn.ModuleList(nn.Conv2d(c, c, 1) for c in skip_ch)
        self.controlnet_mid_block = nn.Conv2d(ch[-1], ch[-1], 1)

    def forward(self, sample, timesteps, encoder_hidden_states, cond_image,
                conditioning_scale: float = 1.0, added_cond=None):
        dtype = self.conv_in.weight.dtype
        emb = time_and_added_embedding(self.config, self.time_embedding,
                                       getattr(self, "add_embedding", None), timesteps,
                                       sample.shape[0], dtype, added_cond)
        context = encoder_hidden_states.to(dtype)
        h = self.conv_in(sample.to(dtype)) + self.controlnet_cond_embedding(cond_image.to(dtype))
        h, residuals = run_down(self.down_blocks, h, emb, context)
        h = run_mid(self.mid_block, h, emb, context)
        down = [conditioning_scale * conv(r).float()
                for conv, r in zip(self.controlnet_down_blocks, residuals)]
        return down, conditioning_scale * self.controlnet_mid_block(h).float()
