"""UNet2DConditionModel, SD 1.x/2.x and SDXL base/refiner (port of
ml_stable_diffusion_tpu/models/unet.py).

NCHW activations and OIHW convolutions inside; parameter names are the
diffusers checkpoint keys (``down_blocks.0.attentions.0.transformer_blocks.0
.attn1.to_q.weight``, ...).  The math follows the Flax module:

- the sinusoidal timestep embedding is computed in float32;
- the transformer LayerNorms use flax's default eps = 1e-6 (diffusers uses
  1e-5), the transformer GroupNorm eps = 1e-6, the resnet GroupNorms
  ``norm_eps``;
- softmax always runs in float32 (ops/attention.py);
- ``Upsample2D`` is nearest-2x plus a 3x3 conv: the JAX package's fused and
  parity upsamplers compute the same function, and its ``_Conv1x1`` is an
  ordinary 1x1 conv.

- SDXL's added conditioning (``addition_embed_type="text_time"``): the
  sinusoid of every time id, concatenated after the pooled text embedding in
  float32, through ``add_embedding`` and added to the timestep embedding;
- the LCM guidance embedding (``time_cond_proj_dim``): the sinusoid of
  ``w * 1000`` (``get_guidance_scale_embedding``) through the bias-free
  ``time_embedding.cond_proj``, added to the timestep sinusoid before the
  MLP;
- the resnet GroupNorm+SiLU goes through ``ops/groupnorm.py``:
  ``fused_groupnorm`` runs the CUDA kernel (its plain version on the CPU),
  ``lowmem_groupnorm`` the low-memory formulation.  ``norm1``/``norm2``
  stay ``nn.GroupNorm`` parameter holders either way, so the state-dict keys
  do not depend on the flag.  The transformer GroupNorm and
  ``conv_norm_out`` stay plain, as in the JAX package.

- ControlNet residuals (``models/controlnet.py``): each down residual is
  added to its skip, the mid residual after the mid block;
- DeepCache: ``return_deep_feature`` also returns the tensor entering the
  last up block; ``deep_feature`` runs the shallow pass (conv_in, down
  block 0 and the last up block) on a cached one.

- IP-Adapter: ``load_ip_adapter`` gives each cross attention (attn2)
  ``to_k_ip``/``to_v_ip`` Linears over the image tokens; with
  ``ip_context`` every attn2 adds ``ip_scale`` times the attention of its
  queries over those tokens to its own before ``to_out``, as the JAX
  ``Attention`` does (``ip_scale=0`` leaves the output as it is without
  them, bit for bit).  Self attention and the ControlNet take no tokens.

- ``fuse_qkv``: each self attention (attn1) projects q, k and v with one
  ``to_qkv`` Linear of 3C outputs (the three weights concatenated on the
  output dim, ``convert/optimize.py:fuse_qkv_params``) and splits it in
  three, as the JAX ``Attention`` does; cross attention keeps its three.

The down and mid blocks are built and run by ``down_and_mid_blocks``,
``run_down`` and ``run_mid``, which the ControlNet shares.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import geglu, gelu_erf, quick_gelu
from ..ops.attention import dot_product_attention
from ..ops.groupnorm import group_norm_silu, group_norm_silu_lowmem


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    #: per down-block transformer depth
    transformer_layers_per_block: tuple[int, ...] = (1, 1, 1, 1)
    #: heads per block (diffusers' attention_head_dim for SD checkpoints)
    num_attention_heads: tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    #: None (SD) or "text_time" (SDXL micro-conditioning)
    addition_embed_type: str | None = None
    addition_time_embed_dim: int = 256
    #: SDXL: 2816 = 1280 pooled + 6*256 time ids; refiner: 2560 (5 ids)
    projection_class_embeddings_input_dim: int = 2816
    #: LCM guidance-embedding input width (diffusers ``time_cond_proj_dim``,
    #: e.g. 256): the guidance scale is an input, not applied by CFG
    time_cond_proj_dim: int | None = None
    #: self attention on one fused q/k/v projection (``to_qkv``)
    fuse_qkv: bool = False
    #: resnet GroupNorm+SiLU on the CUDA kernel (ops/groupnorm.py)
    fused_groupnorm: bool = False
    #: resnet GroupNorm+SiLU with statistics reduced from the compute dtype
    lowmem_groupnorm: bool = False
    #: quick_gelu in place of the exact erf GELU in the GEGLU feed-forwards
    fast_gelu: bool = False
    #: the JAX package's upsampler rewrites compute the same function as
    #: NN-2x + conv, which is what the port runs for either value
    parity_upsample: bool = False
    fused_upsample: bool = True

    @classmethod
    def sd15(cls) -> "UNetConfig":
        """SD-1.5: 8 heads in every block (D = 40, 80, 160), CLIP-L context."""
        return cls(cross_attention_dim=768, num_attention_heads=(8, 8, 8, 8))

    @classmethod
    def sd21(cls) -> "UNetConfig":
        return cls()

    @classmethod
    def sdxl(cls) -> "UNetConfig":
        return cls(
            block_out_channels=(320, 640, 1280),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                              "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                            "UpBlock2D"),
            transformer_layers_per_block=(1, 2, 10),
            num_attention_heads=(5, 10, 20),
            cross_attention_dim=2048,
            addition_embed_type="text_time",
            projection_class_embeddings_input_dim=2816,
        )

    @classmethod
    def sdxl_refiner(cls) -> "UNetConfig":
        return cls(
            block_out_channels=(384, 768, 1536, 1536),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                              "CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D",
                            "CrossAttnUpBlock2D", "UpBlock2D"),
            transformer_layers_per_block=(1, 4, 4, 1),
            num_attention_heads=(6, 12, 24, 24),
            cross_attention_dim=1280,
            addition_embed_type="text_time",
            projection_class_embeddings_input_dim=2560,
        )

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def get_timestep_embedding(timesteps, dim: int, flip_sin_to_cos: bool = True,
                           freq_shift: float = 0.0, max_period: float = 10000.0):
    """Sinusoidal timestep embedding, in float32 whatever the model dtype."""
    half = dim // 2
    log_period = torch.log(torch.tensor(max_period, dtype=torch.float32))
    exponent = -log_period * torch.arange(half, dtype=torch.float32,
                                          device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin], dim=-1) if flip_sin_to_cos else torch.cat([sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


def get_guidance_scale_embedding(w, dim: int):
    """The LCM guidance embedding (diffusers semantics): the sinusoid of
    ``w * 1000``, denominator ``half - 1``, [sin, cos] order; float32."""
    w = torch.as_tensor(w, dtype=torch.float32) * 1000.0
    half = dim // 2
    log_period = torch.log(torch.tensor(10000.0, dtype=torch.float32))
    emb = torch.exp(torch.arange(half, dtype=torch.float32, device=w.device)
                    * (-log_period / (half - 1)))
    emb = w[:, None] * emb[None, :]
    out = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """Two-layer MLP over the sinusoidal embedding; with ``cond_dim``, a
    bias-free ``cond_proj`` of a conditioning vector is added to the input
    first (the LCM guidance embedding)."""

    def __init__(self, in_dim: int, dim: int, cond_dim: int | None = None):
        super().__init__()
        if cond_dim is not None:
            self.cond_proj = nn.Linear(cond_dim, in_dim, bias=False)
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x, cond=None):
        if cond is not None:
            x = x + self.cond_proj(cond.to(x.dtype))
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv, + time-embedding add, GN -> SiLU -> conv, + skip.

    ``gn``: "plain" (``nn.GroupNorm`` then SiLU), "fused" (``group_norm_silu``,
    the CUDA kernel on the card) or "lowmem" (``group_norm_silu_lowmem``)."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 groups: int = 32, eps: float = 1e-5, gn: str = "plain"):
        super().__init__()
        self.gn = gn
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)
        else:
            self.conv_shortcut = None

    def _gn_silu(self, x, norm: nn.GroupNorm):
        if hasattr(norm, "gn_silu"):  # split over image rows (parallel/layers.py)
            return norm.gn_silu(x, self.gn)
        if self.gn == "fused":
            return group_norm_silu(x, norm.weight, norm.bias, norm.num_groups,
                                   norm.eps).to(norm.weight.dtype)
        if self.gn == "lowmem":
            return group_norm_silu_lowmem(x.to(norm.weight.dtype), norm.weight, norm.bias,
                                          norm.num_groups, norm.eps)
        return F.silu(norm(x))

    def forward(self, x, temb):
        h = self.conv1(self._gn_silu(x, self.norm1))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self._gn_silu(h, self.norm2))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """QKV attention over (B, S, C) through the shared dispatch.  ``ip``:
    (IP-Adapter tokens (B, S_ip, C_ctx), scale) for a cross attention that
    ``load_ip_adapter`` gave ``to_k_ip``/``to_v_ip``.  ``fuse_qkv`` (self
    attention only): one ``to_qkv`` projection, split in three.  The head
    count follows the projections' widths (``head_dim`` each), so a
    tensor-parallel rank whose projections hold its heads runs its own
    (parallel/layers.py); ``self_attention_kv`` is where spatial sharding
    gathers the keys and values of every rank's tokens."""

    def __init__(self, query_dim: int, heads: int, context_dim: int | None = None,
                 fuse_qkv: bool = False):
        super().__init__()
        self.heads = heads
        self.head_dim = query_dim // heads
        if fuse_qkv:
            if context_dim is not None:
                raise ValueError("fuse_qkv is for self attention: its k and v read x")
            self.to_qkv = nn.Linear(query_dim, 3 * query_dim, bias=False)
        else:
            context_dim = context_dim or query_dim
            self.to_q = nn.Linear(query_dim, query_dim, bias=False)
            self.to_k = nn.Linear(context_dim, query_dim, bias=False)
            self.to_v = nn.Linear(context_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def self_attention_kv(self, k, v):
        return k, v

    def forward(self, x, context=None, ip=None):
        is_self = context is None
        context = x if context is None else context
        B, Sq, _ = x.shape
        Sk = context.shape[1]
        D = self.head_dim
        if hasattr(self, "to_qkv"):
            q, k, v = (t.view(B, Sq, -1, D) for t in self.to_qkv(x).chunk(3, dim=-1))
        else:
            q = self.to_q(x).view(B, Sq, -1, D)
            k = self.to_k(context).view(B, Sk, -1, D)
            v = self.to_v(context).view(B, Sk, -1, D)
        if is_self:
            k, v = self.self_attention_kv(k, v)
        out = dot_product_attention(q, k, v)
        if ip is not None:
            tokens, scale = ip
            if not hasattr(self, "to_k_ip"):
                raise ValueError("IP-Adapter tokens reached a cross attention without "
                                 "to_k_ip/to_v_ip: load_ip_adapter on this UNet first")
            S_ip = tokens.shape[1]
            k_ip = self.to_k_ip(tokens).view(B, S_ip, -1, D)
            v_ip = self.to_v_ip(tokens).view(B, S_ip, -1, D)
            out = out + scale * dot_product_attention(q, k_ip, v_ip)
        return self.to_out[0](out.reshape(B, Sq, -1))


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward; ``net.0.proj`` and ``net.2`` as in diffusers, the
    gate by ``ops/activations.py:geglu``."""

    def __init__(self, dim: int, mult: int = 4, fast_gelu: bool = False):
        super().__init__()
        inner = dim * mult
        self.gelu = quick_gelu if fast_gelu else gelu_erf
        self.net = nn.ModuleList([_GEGLUProj(dim, inner), nn.Identity(),
                                  nn.Linear(inner, dim)])

    def forward(self, x):
        return self.net[2](geglu(self.net[0].proj(x), fast=self.gelu is quick_gelu))


class BasicTransformerBlock(nn.Module):
    """self-attn + cross-attn + GEGLU FF, pre-LN (flax LayerNorm eps 1e-6)."""

    def __init__(self, dim: int, heads: int, context_dim: int, fast_gelu: bool = False,
                 fuse_qkv: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, heads, fuse_qkv=fuse_qkv)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim, fast_gelu=fast_gelu)

    def forward(self, x, context, ip=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context, ip)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GN -> linear proj_in -> transformer blocks over (B, H*W, C) ->
    proj_out, + residual (diffusers Transformer2DModel, linear projection)."""

    def __init__(self, channels: int, heads: int, depth: int, context_dim: int,
                 groups: int = 32, eps: float = 1e-6, fast_gelu: bool = False,
                 fuse_qkv: bool = False):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps=eps)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, heads, context_dim, fast_gelu, fuse_qkv)
            for _ in range(depth))
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context, ip=None):
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h, context, ip)
        h = self.proj_out(h)
        # x first: the sum takes x's contiguous NCHW layout, which the
        # GroupNorm kernel of the next resnet needs (the permuted h first
        # would make it channels-last)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """A down/up/mid block: ``resnets``, optional ``attentions`` and
    ``downsamplers``/``upsamplers``, named as in diffusers."""

    def __init__(self, resnets, attentions=(), downsamplers=(), upsamplers=()):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsamplers:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers:
            self.upsamplers = nn.ModuleList(upsamplers)


def _check_supported(cfg: UNetConfig):
    if cfg.addition_embed_type not in (None, "text_time"):
        raise ValueError(f"unknown addition_embed_type {cfg.addition_embed_type!r}")


def down_and_mid_blocks(cfg: UNetConfig, gn: str = "plain", fast_gelu: bool = False):
    """The diffusers down and mid blocks of ``cfg``, shared by the UNet and
    the ControlNet -> (down blocks, mid block, skip channels: conv_in's,
    then one per residual ``run_down`` returns).  ``gn``: the resnets'
    GroupNorm+SiLU (``ResnetBlock2D``)."""
    ch = cfg.block_out_channels
    G, eps, temb = cfg.norm_num_groups, cfg.norm_eps, cfg.time_embed_dim

    def transformer(c, bi):
        return SpatialTransformer(c, cfg.num_attention_heads[bi],
                                  cfg.transformer_layers_per_block[bi],
                                  cfg.cross_attention_dim, G, fast_gelu=fast_gelu,
                                  fuse_qkv=cfg.fuse_qkv)

    skip_ch = [ch[0]]
    down = []
    c_in = ch[0]
    for bi, btype in enumerate(cfg.down_block_types):
        out = ch[bi]
        resnets, attns = [], []
        for li in range(cfg.layers_per_block):
            resnets.append(ResnetBlock2D(c_in if li == 0 else out, out, temb, G, eps, gn))
            if btype == "CrossAttnDownBlock2D":
                attns.append(transformer(out, bi))
            skip_ch.append(out)
        final = bi == len(cfg.down_block_types) - 1
        if not final:
            skip_ch.append(out)
        down.append(_Block(resnets, attns, downsamplers=[] if final else [Downsample2D(out)]))
        c_in = out
    mid = ch[-1]
    mid_block = _Block([ResnetBlock2D(mid, mid, temb, G, eps, gn) for _ in range(2)],
                       [transformer(mid, len(ch) - 1)])
    return nn.ModuleList(down), mid_block, skip_ch


def run_down(blocks, h, emb, context, shallow: bool = False, ip=None):
    """The down blocks on conv_in's output ``h`` -> (h, the skip residuals,
    conv_in's output first).  ``shallow`` (DeepCache): down block 0 without
    its downsampler.  ``ip``: IP-Adapter (tokens, scale) for the cross
    attentions."""
    residuals = [h]
    for block in blocks[:1] if shallow else blocks:
        for li, resnet in enumerate(block.resnets):
            h = resnet(h, emb)
            if hasattr(block, "attentions"):
                h = block.attentions[li](h, context, ip)
            residuals.append(h)
        if hasattr(block, "downsamplers") and not shallow:
            h = block.downsamplers[0](h)
            residuals.append(h)
    return h, residuals


def run_mid(block, h, emb, context, ip=None):
    h = block.resnets[0](h, emb)
    h = block.attentions[0](h, context, ip)
    return block.resnets[1](h, emb)


def time_and_added_embedding(cfg: UNetConfig, time_embedding, add_embedding, timesteps,
                             batch: int, dtype, added_cond=None, timestep_cond=None):
    """The timestep embedding (float32 sinusoid, the MLP in ``dtype``) plus,
    for ``addition_embed_type="text_time"``, the added embedding of the
    pooled text vector and the time ids."""
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(batch)
    t_emb = get_timestep_embedding(timesteps, cfg.block_out_channels[0],
                                   cfg.flip_sin_to_cos, cfg.freq_shift)
    emb = time_embedding(t_emb.to(dtype), timestep_cond)
    if cfg.addition_embed_type == "text_time":
        if added_cond is None:
            raise ValueError("an SDXL UNet or ControlNet needs added_cond")
        time_ids = added_cond["time_ids"].reshape(-1)
        id_emb = get_timestep_embedding(time_ids, cfg.addition_time_embed_dim,
                                        cfg.flip_sin_to_cos, cfg.freq_shift)
        id_emb = id_emb.reshape(batch, -1)
        add = torch.cat([added_cond["text_embeds"].float(), id_emb], dim=-1)
        emb = emb + add_embedding(add.to(dtype))
    return emb


class UNet2DConditionModel(nn.Module):
    """Denoiser for SD 1.x/2.x and SDXL.  ``forward(sample (B, C, H, W),
    timesteps (B,) or scalar, encoder_hidden_states (B, S, C_ctx),
    added_cond)`` -> float32 (B, C_out, H, W); computes in the dtype of its
    parameters.  ``added_cond`` (SDXL): ``{"text_embeds": (B, pooled),
    "time_ids": (B, 5 or 6)}``.  ``ip_context`` (B, S_ip, C_ctx) and
    ``ip_scale``: IP-Adapter tokens for every cross attention."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        _check_supported(config)
        self.config = cfg = config
        ch = cfg.block_out_channels
        G, eps, temb = cfg.norm_num_groups, cfg.norm_eps, cfg.time_embed_dim
        L = cfg.layers_per_block
        gn = ("fused" if cfg.fused_groupnorm
              else "lowmem" if cfg.lowmem_groupnorm else "plain")

        def resnet(c_in, c_out):
            return ResnetBlock2D(c_in, c_out, temb, G, eps, gn)

        def transformer(c, bi):
            return SpatialTransformer(c, cfg.num_attention_heads[bi],
                                      cfg.transformer_layers_per_block[bi],
                                      cfg.cross_attention_dim, G,
                                      fast_gelu=cfg.fast_gelu, fuse_qkv=cfg.fuse_qkv)

        self.time_embedding = TimestepEmbedding(ch[0], temb, cfg.time_cond_proj_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks, self.mid_block, skip_ch = down_and_mid_blocks(cfg, gn, cfg.fast_gelu)

        up = []
        rev = list(reversed(ch))
        h_ch = ch[-1]
        for bi, btype in enumerate(cfg.up_block_types):
            out = rev[bi]
            cross = btype == "CrossAttnUpBlock2D"
            down_bi = len(ch) - 1 - bi  # heads indexed by mirrored down block
            resnets, attns = [], []
            for li in range(L + 1):
                resnets.append(resnet(h_ch + skip_ch.pop(), out))
                h_ch = out
                if cross:
                    attns.append(transformer(out, down_bi))
            final = bi == len(cfg.up_block_types) - 1
            up.append(_Block(resnets, attns,
                             upsamplers=[] if final else [Upsample2D(out)]))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = nn.GroupNorm(G, ch[0], eps=eps)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states, added_cond=None,
                down_block_residuals=None, mid_block_residual=None,
                ip_context=None, ip_scale: float = 1.0, deep_feature=None,
                return_deep_feature=False, timestep_cond=None):
        """``down_block_residuals`` / ``mid_block_residual``: a ControlNet's
        (float32; added in the compute dtype).  ``return_deep_feature``:
        -> (output, the tensor entering the last up block).  ``deep_feature``:
        the shallow pass on such a tensor; only the first skips take their
        residuals and the mid residual is skipped.  With a feature from a
        full pass on the same inputs it gives that pass's output bit for
        bit."""
        cfg = self.config
        shallow = deep_feature is not None
        if shallow or return_deep_feature:
            if shallow and return_deep_feature:
                raise ValueError("deep_feature and return_deep_feature exclude each other")
            if len(cfg.up_block_types) < 2:
                raise ValueError("DeepCache needs at least two up blocks")
        # a norm's weight: a W8A8 conv_in holds no float weight
        dtype = self.conv_norm_out.weight.dtype
        if cfg.time_cond_proj_dim is not None and timestep_cond is None:
            raise ValueError(
                f"this UNet is guidance-embedded (time_cond_proj_dim={cfg.time_cond_proj_dim}); "
                "pass timestep_cond (get_guidance_scale_embedding(w, dim))")
        emb = time_and_added_embedding(
            cfg, self.time_embedding, getattr(self, "add_embedding", None), timesteps,
            sample.shape[0], dtype, added_cond,
            timestep_cond if cfg.time_cond_proj_dim is not None else None)
        context = encoder_hidden_states.to(dtype)
        ip = None if ip_context is None else (ip_context.to(dtype), ip_scale)

        h, residuals = run_down(self.down_blocks, self.conv_in(sample.to(dtype)), emb, context,
                                shallow, ip)
        if down_block_residuals is not None:
            # on the shallow pass zip stops at the shallow skips, the list's head
            residuals = [r + c.to(r.dtype) for r, c in zip(residuals, down_block_residuals)]
        if shallow:
            h = deep_feature.to(dtype)
        else:
            h = run_mid(self.mid_block, h, emb, context, ip)
            if mid_block_residual is not None:
                h = h + mid_block_residual.to(h.dtype)

        deep_out = None
        for block in self.up_blocks[-1:] if shallow else self.up_blocks:
            if return_deep_feature and block is self.up_blocks[-1]:
                deep_out = h
            for li, resnet in enumerate(block.resnets):
                h = resnet(torch.cat([h, residuals.pop().to(h.dtype)], dim=1), emb)
                if hasattr(block, "attentions"):
                    h = block.attentions[li](h, context, ip)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)

        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return (h.float(), deep_out) if return_deep_feature else h.float()
