"""VAE decoder and encoder (port of ml_stable_diffusion_tpu/models/vae.py).

NCHW inside.  Parameter names are the diffusers ``AutoencoderKL`` keys:
``post_quant_conv.*`` and ``decoder.*`` for the decoder, ``encoder.*`` and
``quant_conv.*`` for the encoder.  The JAX decoder's fused and parity
upsamplers compute the same function as the nearest-2x + 3x3 conv used
here.  Both mid blocks hold the single-head D = 512 attention, which takes
the f32 flash kernel on the card (ops/attention.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .unet import Upsample2D


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    #: SD/SDXL have 1x1 quant/post_quant convs; SD3's 16-ch VAE does not
    use_quant_conv: bool = True

    @classmethod
    def sd(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def sd3(cls) -> "VAEConfig":
        """SD3's 16-channel VAE, without quant convs."""
        return cls(latent_channels=16, use_quant_conv=False)


class VAEResnetBlock(nn.Module):
    """Resnet block without time conditioning."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)
        else:
            self.conv_shortcut = None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttentionBlock(nn.Module):
    """Single-head self-attention over spatial positions, head width C."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q = self.to_q(h)[:, :, None, :]
        k = self.to_k(h)[:, :, None, :]
        v = self.to_v(h)[:, :, None, :]
        # one head of width C through the shared dispatch: on the card the
        # flash kernel never materializes the (HW, HW) logits
        h = dot_product_attention(q, k, v)[:, :, 0, :]
        h = self.to_out[0](h)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, groups, eps),
                                      VAEResnetBlock(channels, channels, groups, eps)])
        self.attentions = nn.ModuleList([VAEAttentionBlock(channels, groups, eps)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _UpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int, groups: int,
                 eps: float, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            VAEResnetBlock(in_channels if li == 0 else out_channels, out_channels,
                           groups, eps) for li in range(layers))
        if upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels)])

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class _DownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int, groups: int,
                 eps: float, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            VAEResnetBlock(in_channels if li == 0 else out_channels, out_channels,
                           groups, eps) for li in range(layers))
        if downsample:
            self.downsamplers = nn.ModuleList([_Downsample(out_channels)])

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        return x


class _Downsample(nn.Module):
    """Pad (0, 1, 0, 1), then a stride-2 valid 3x3 conv (diffusers)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        G, eps = cfg.norm_num_groups, cfg.norm_eps
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            _DownBlock(ch[max(bi - 1, 0)], out, cfg.layers_per_block, G, eps,
                       downsample=bi < len(ch) - 1)
            for bi, out in enumerate(ch))
        self.mid_block = VAEMidBlock(ch[-1], G, eps)
        self.conv_norm_out = nn.GroupNorm(G, ch[-1], eps=eps)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAEEncoder(nn.Module):
    """image (B, 3, H, W) in [-1, 1] -> Gaussian moments (B, 2 * C_lat, H/8,
    W/8): mean, then log-variance; float32, computed in the dtype of its
    parameters."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = _Encoder(config)
        if config.use_quant_conv:
            self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                        2 * config.latent_channels, 1)

    def forward(self, x):
        h = self.encoder(x.to(self.encoder.conv_in.weight.dtype))
        if self.config.use_quant_conv:
            h = self.quant_conv(h)
        return h.float()


def sample_diagonal_gaussian(moments, noise):
    """Moments (B, 2C, h, w) and standard-normal noise (B, C, h, w) -> a
    latent sample, the log-variance clamped to [-30, 20]."""
    mean, logvar = torch.chunk(moments, 2, dim=1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    return mean + torch.exp(0.5 * logvar) * noise


class _Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = tuple(reversed(cfg.block_out_channels))
        G, eps = cfg.norm_num_groups, cfg.norm_eps
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0], G, eps)
        self.up_blocks = nn.ModuleList(
            _UpBlock(rev[max(bi - 1, 0)], out, cfg.layers_per_block + 1, G, eps,
                     upsample=bi < len(rev) - 1)
            for bi, out in enumerate(rev))
        self.conv_norm_out = nn.GroupNorm(G, rev[-1], eps=eps)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAEDecoder(nn.Module):
    """latents (B, C_lat, h, w) -> image (B, 3, 8h, 8w) in [-1, 1], float32;
    computes in the dtype of its parameters."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        if config.use_quant_conv:
            self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                             config.latent_channels, 1)
        self.decoder = _Decoder(config)

    def forward(self, z):
        z = z.to(self.decoder.conv_in.weight.dtype)
        if self.config.use_quant_conv:
            z = self.post_quant_conv(z)
        return self.decoder(z).float()
