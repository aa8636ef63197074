"""Torch mirror forwards for the full-model conversion gates (the port's own
copy of ml_stable_diffusion_tpu/convert/torch_mirrors.py).

Independent functional re-implementations of the published forward
semantics, consuming a diffusers- or transformers-layout ``state_dict`` of
tensors directly (no module tree, no weight copy): diffusers'
UNet2DConditionModel, AutoencoderKL, ControlNetModel, SD3Transformer2DModel
and SD3ControlNetModel, copied from the JAX package's file with the port's
configs; and, written here from the published transformers models, the CLIP
text encoder (CLIPTextModel / CLIPTextModelWithProjection), the T5 encoder
(T5EncoderModel) and the CLIP vision tower with its projection
(CLIPVisionModelWithProjection, the safety checker's tower).  None of them
translates the port's ``models/``: agreement between the two independently
written forwards is the correctness evidence ``convert/verify.py`` gates at
35 dB.

Everything runs in float32 under ``torch.no_grad``, on the device of the
input tensors: the state dict's tensors are moved there as they are read.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..models.mmdit import MMDiTConfig
from ..models.unet import UNetConfig
from ..models.vae import VAEConfig


class _OnDevice(dict):
    """A state dict read on ``device``: each tensor moved as it is read."""

    def __init__(self, sd, device):
        super().__init__(sd)
        self.device = device

    def __getitem__(self, name):
        t = super().__getitem__(name)
        if not torch.is_tensor(t):
            t = torch.from_numpy(t.copy() if hasattr(t, "copy") else t)
        return t.to(self.device)


def _on(sd, like: torch.Tensor):
    return sd if isinstance(sd, _OnDevice) else _OnDevice(sd, like.device)


def _w(sd, name):
    t = sd[name]
    if not torch.is_tensor(t):
        t = torch.from_numpy(t.copy() if hasattr(t, "copy") else t)
    return t.float()


def _linear(sd, prefix, x):
    w = _w(sd, prefix + ".weight")
    if w.ndim == 4:  # 1x1 conv used as linear (SD1.x proj_in/out)
        w = w[:, :, 0, 0]
    b = _w(sd, prefix + ".bias") if prefix + ".bias" in sd else None
    return F.linear(x, w, b)


def _conv(sd, prefix, x, stride=1, padding=1):
    b = _w(sd, prefix + ".bias") if prefix + ".bias" in sd else None
    return F.conv2d(x, _w(sd, prefix + ".weight"), b, stride=stride,
                    padding=padding)


def _group_norm(sd, prefix, x, groups, eps):
    return F.group_norm(x, groups, _w(sd, prefix + ".weight"),
                        _w(sd, prefix + ".bias"), eps=eps)


def _layer_norm(sd, prefix, x):
    return F.layer_norm(x, (x.shape[-1],), _w(sd, prefix + ".weight"),
                        _w(sd, prefix + ".bias"), eps=1e-5)


def _sinusoidal(timesteps, dim, flip_sin_to_cos=True, freq_shift=0.0,
                max_period=10000.0):
    """diffusers embeddings.get_timestep_embedding: sin block then cos block,
    flipped to cos-first when flip_sin_to_cos."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _time_mlp(sd, prefix, x):
    h = _linear(sd, prefix + ".linear_1", x)
    return _linear(sd, prefix + ".linear_2", F.silu(h))


# ---------------------------------------------------------------- UNet ----


def _resnet_fwd(sd, p, x, emb, groups, eps):
    h = _conv(sd, p + ".conv1", F.silu(_group_norm(sd, p + ".norm1", x,
                                                   groups, eps)))
    if p + ".time_emb_proj.weight" in sd:
        h = h + _linear(sd, p + ".time_emb_proj", F.silu(emb))[:, :, None, None]
    h = _conv(sd, p + ".conv2", F.silu(_group_norm(sd, p + ".norm2", h,
                                                   groups, eps)))
    if p + ".conv_shortcut.weight" in sd:
        x = _conv(sd, p + ".conv_shortcut", x, padding=0)
    return x + h


def _mha(q, k, v, heads):
    B, Sq, D = q.shape
    Sk = k.shape[1]
    q = q.view(B, Sq, heads, D // heads).transpose(1, 2)
    k = k.view(B, Sk, heads, D // heads).transpose(1, 2)
    v = v.view(B, Sk, heads, D // heads).transpose(1, 2)
    o = F.scaled_dot_product_attention(q, k, v)
    return o.transpose(1, 2).reshape(B, Sq, D)


def _attn_fwd(sd, p, x, ctx, heads):
    q = _linear(sd, p + ".to_q", x)
    k = _linear(sd, p + ".to_k", ctx)
    v = _linear(sd, p + ".to_v", ctx)
    return _linear(sd, p + ".to_out.0", _mha(q, k, v, heads))


def _tblock_fwd(sd, p, x, ctx, heads):
    h = _layer_norm(sd, p + ".norm1", x)
    x = x + _attn_fwd(sd, p + ".attn1", h, h, heads)
    x = x + _attn_fwd(sd, p + ".attn2", _layer_norm(sd, p + ".norm2", x),
                      ctx, heads)
    h = _linear(sd, p + ".ff.net.0.proj", _layer_norm(sd, p + ".norm3", x))
    a, gate = h.chunk(2, dim=-1)
    return x + _linear(sd, p + ".ff.net.2", a * F.gelu(gate))


def _spatial_transformer_fwd(sd, p, x, ctx, heads, depth, groups):
    B, C, H, W = x.shape
    residual = x
    h = _group_norm(sd, p + ".norm", x, groups, eps=1e-6)
    linear_proj = _w(sd, p + ".proj_in.weight").ndim == 2
    if linear_proj:  # SD2.x/XL: flatten then Linear
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = _linear(sd, p + ".proj_in", h)
    else:  # SD1.x: 1x1 conv then flatten
        h = _conv(sd, p + ".proj_in", h, padding=0)
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
    for i in range(depth):
        h = _tblock_fwd(sd, p + f".transformer_blocks.{i}", h, ctx, heads)
    if linear_proj:
        h = _linear(sd, p + ".proj_out", h)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
    else:
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        h = _conv(sd, p + ".proj_out", h, padding=0)
    return h + residual


def _unet_embed(sd, cfg: UNetConfig, sample, timesteps, added_cond,
                timestep_cond=None):
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(sample.shape[0])
    t_emb = _sinusoidal(timesteps, cfg.block_out_channels[0],
                        cfg.flip_sin_to_cos, cfg.freq_shift)
    if timestep_cond is not None:
        # LCM guidance conditioning: bias-free projection added to the
        # sinusoid BEFORE the MLP (diffusers TimestepEmbedding.cond_proj)
        t_emb = t_emb + timestep_cond.float() @ _w(
            sd, "time_embedding.cond_proj.weight").t()
    emb = _time_mlp(sd, "time_embedding", t_emb)
    if cfg.addition_embed_type == "text_time":
        time_ids = added_cond["time_ids"].reshape(-1)
        id_emb = _sinusoidal(time_ids, cfg.addition_time_embed_dim,
                             cfg.flip_sin_to_cos, cfg.freq_shift)
        id_emb = id_emb.reshape(sample.shape[0], -1)
        add = torch.cat([added_cond["text_embeds"].float(), id_emb], dim=-1)
        emb = emb + _time_mlp(sd, "add_embedding", add)
    return emb


def _unet_down(sd, cfg: UNetConfig, h, emb, ctx):
    """conv_in + down stack; returns (h, residuals) with the diffusers
    residual ordering: conv_in output, then one per resnet(+attn), then one
    per downsampler."""
    groups, eps = cfg.norm_num_groups, cfg.norm_eps
    residuals = [h]
    n = len(cfg.block_out_channels)
    for bi, btype in enumerate(cfg.down_block_types):
        for li in range(cfg.layers_per_block):
            h = _resnet_fwd(sd, f"down_blocks.{bi}.resnets.{li}", h, emb,
                            groups, eps)
            if btype == "CrossAttnDownBlock2D":
                h = _spatial_transformer_fwd(
                    sd, f"down_blocks.{bi}.attentions.{li}", h, ctx,
                    cfg.num_attention_heads[bi],
                    cfg.transformer_layers_per_block[bi], groups)
            residuals.append(h)
        if bi < n - 1:
            h = _conv(sd, f"down_blocks.{bi}.downsamplers.0.conv", h,
                      stride=2, padding=1)
            residuals.append(h)
    return h, residuals


def _unet_mid(sd, cfg: UNetConfig, h, emb, ctx):
    groups, eps = cfg.norm_num_groups, cfg.norm_eps
    h = _resnet_fwd(sd, "mid_block.resnets.0", h, emb, groups, eps)
    h = _spatial_transformer_fwd(sd, "mid_block.attentions.0", h, ctx,
                                 cfg.num_attention_heads[-1],
                                 cfg.transformer_layers_per_block[-1], groups)
    return _resnet_fwd(sd, "mid_block.resnets.1", h, emb, groups, eps)


@torch.no_grad()
def torch_unet_forward(sd, cfg: UNetConfig, sample, timesteps, ctx,
                       added_cond=None, timestep_cond=None):
    """diffusers UNet2DConditionModel.forward on a raw state dict.

    sample (B, C, H, W), timesteps (B,) float, ctx (B, S, C_ctx);
    added_cond {"text_embeds", "time_ids"} for SDXL; timestep_cond
    (B, time_cond_proj_dim) for LCM guidance-embedded checkpoints.
    Returns (B, C, H, W).
    """
    sd = _on(sd, sample)
    groups, eps = cfg.norm_num_groups, cfg.norm_eps
    emb = _unet_embed(sd, cfg, sample, timesteps, added_cond, timestep_cond)
    h = _conv(sd, "conv_in", sample.float())
    h, residuals = _unet_down(sd, cfg, h, emb, ctx.float())
    h = _unet_mid(sd, cfg, h, emb, ctx.float())

    rev_heads = list(reversed(cfg.num_attention_heads))
    rev_depth = list(reversed(cfg.transformer_layers_per_block))
    n = len(cfg.block_out_channels)
    for bi, btype in enumerate(cfg.up_block_types):
        for li in range(cfg.layers_per_block + 1):
            res = residuals.pop()
            h = torch.cat([h, res], dim=1)
            h = _resnet_fwd(sd, f"up_blocks.{bi}.resnets.{li}", h, emb,
                            groups, eps)
            if btype == "CrossAttnUpBlock2D":
                h = _spatial_transformer_fwd(
                    sd, f"up_blocks.{bi}.attentions.{li}", h, ctx.float(),
                    rev_heads[bi], rev_depth[bi], groups)
        if bi < n - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(sd, f"up_blocks.{bi}.upsamplers.0.conv", h)
    h = F.silu(_group_norm(sd, "conv_norm_out", h, groups, eps))
    return _conv(sd, "conv_out", h)


# ---------------------------------------------------------- ControlNet ----


@torch.no_grad()
def torch_controlnet_forward(sd, cfg: UNetConfig, sample, timesteps, ctx,
                             cond_image, conditioning_scale=1.0,
                             added_cond=None):
    """diffusers ControlNetModel.forward on a raw state dict.

    cond_image (B, 3, H*8, W*8) in [0,1].  Returns (down_residuals tuple,
    mid_residual), both scaled."""
    sd = _on(sd, sample)
    emb = _unet_embed(sd, cfg, sample, timesteps, added_cond)
    h = _conv(sd, "conv_in", sample.float())

    # ControlNetConditioningEmbedding (controlnet.py:15-46 in the reference's
    # python package; diffusers class of the same name)
    c = F.silu(_conv(sd, "controlnet_cond_embedding.conv_in",
                     cond_image.float()))
    nb = 0
    while f"controlnet_cond_embedding.blocks.{nb}.weight" in sd:
        nb += 1
    for i in range(nb):
        stride = 2 if i % 2 == 1 else 1
        c = F.silu(_conv(sd, f"controlnet_cond_embedding.blocks.{i}", c,
                         stride=stride, padding=1))
    h = h + _conv(sd, "controlnet_cond_embedding.conv_out", c)

    h, residuals = _unet_down(sd, cfg, h, emb, ctx.float())
    h = _unet_mid(sd, cfg, h, emb, ctx.float())

    down_out = tuple(
        conditioning_scale * _conv(sd, f"controlnet_down_blocks.{i}", r,
                                   padding=0)
        for i, r in enumerate(residuals))
    mid = conditioning_scale * _conv(sd, "controlnet_mid_block", h, padding=0)
    return down_out, mid


# ------------------------------------------------------------------ VAE ----


def _vae_resnet_fwd(sd, p, x, groups, eps):
    return _resnet_fwd(sd, p, x, None, groups, eps)


def _vae_attn_fwd(sd, p, x, groups, eps):
    B, C, H, W = x.shape
    h = _group_norm(sd, p + ".group_norm", x, groups, eps)
    h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
    q = _linear(sd, p + ".to_q", h)
    k = _linear(sd, p + ".to_k", h)
    v = _linear(sd, p + ".to_v", h)
    o = F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None])[:, 0]
    h = _linear(sd, p + ".to_out.0", o)
    return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


def _vae_mid_fwd(sd, p, x, groups, eps):
    x = _vae_resnet_fwd(sd, p + ".resnets.0", x, groups, eps)
    x = _vae_attn_fwd(sd, p + ".attentions.0", x, groups, eps)
    return _vae_resnet_fwd(sd, p + ".resnets.1", x, groups, eps)


@torch.no_grad()
def torch_vae_encoder_forward(sd, cfg: VAEConfig, x):
    """diffusers AutoencoderKL.encode moments on a raw state dict.
    x (B, 3, H, W) -> (B, 2*latent_channels, H/8, W/8)."""
    sd = _on(sd, x)
    groups, eps = cfg.norm_num_groups, cfg.norm_eps
    h = _conv(sd, "encoder.conv_in", x.float())
    n = len(cfg.block_out_channels)
    for bi in range(n):
        for li in range(cfg.layers_per_block):
            h = _vae_resnet_fwd(sd, f"encoder.down_blocks.{bi}.resnets.{li}",
                                h, groups, eps)
        if bi < n - 1:
            # torch pads (0,1,0,1) then runs the stride-2 conv VALID
            h = F.pad(h, (0, 1, 0, 1))
            h = _conv(sd, f"encoder.down_blocks.{bi}.downsamplers.0.conv", h,
                      stride=2, padding=0)
    h = _vae_mid_fwd(sd, "encoder.mid_block", h, groups, eps)
    h = F.silu(_group_norm(sd, "encoder.conv_norm_out", h, groups, eps))
    h = _conv(sd, "encoder.conv_out", h)
    if "quant_conv.weight" in sd:
        h = _conv(sd, "quant_conv", h, padding=0)
    return h


@torch.no_grad()
def torch_vae_decoder_forward(sd, cfg: VAEConfig, z):
    """diffusers AutoencoderKL.decode on a raw state dict.
    z (B, latent_channels, h, w) -> (B, 3, 8h, 8w)."""
    sd = _on(sd, z)
    groups, eps = cfg.norm_num_groups, cfg.norm_eps
    if "post_quant_conv.weight" in sd:
        z = _conv(sd, "post_quant_conv", z.float(), padding=0)
    h = _conv(sd, "decoder.conv_in", z.float())
    h = _vae_mid_fwd(sd, "decoder.mid_block", h, groups, eps)
    n = len(cfg.block_out_channels)
    for bi in range(n):
        for li in range(cfg.layers_per_block + 1):
            h = _vae_resnet_fwd(sd, f"decoder.up_blocks.{bi}.resnets.{li}",
                                h, groups, eps)
        if bi < n - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(sd, f"decoder.up_blocks.{bi}.upsamplers.0.conv", h)
    h = F.silu(_group_norm(sd, "decoder.conv_norm_out", h, groups, eps))
    return _conv(sd, "decoder.conv_out", h)


# ---------------------------------------------------------------- MMDiT ----


def _rms_norm(sd, name, x):
    var = x.float().pow(2).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * _w(sd, name + ".weight")


def _ln_noaffine(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def _mmdit_stem(sd, cfg: MMDiTConfig, latents, timesteps, pooled,
                pos_prefix="pos_embed"):
    """Patchify + cropped pos table + combined timestep/text conditioning.
    latents (B, C, H, W) -> (x tokens, conditioning vector)."""
    B = latents.shape[0]
    P, D, M = cfg.patch_size, cfg.hidden_size, cfg.pos_embed_max_size
    hp, wp = latents.shape[2] // P, latents.shape[3] // P
    x = _conv(sd, pos_prefix + ".proj", latents.float(), stride=P, padding=0)
    x = x.flatten(2).transpose(1, 2)  # (B, hp*wp, D)
    pos = _w(sd, pos_prefix + ".pos_embed").reshape(1, M, M, D)
    top, left = (M - hp) // 2, (M - wp) // 2
    x = x + pos[:, top:top + hp, left:left + wp].reshape(1, hp * wp, D)
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(B)
    t_emb = _sinusoidal(timesteps, 256, flip_sin_to_cos=True, freq_shift=0)
    c = _time_mlp(sd, "time_text_embed.timestep_embedder", t_emb)
    c = c + _time_mlp(sd, "time_text_embed.text_embedder", pooled.float())
    return x, c


def _joint_block_fwd(sd, p, x, ctx, c, cfg: MMDiTConfig, pre_only):
    D, H = cfg.hidden_size, cfg.num_heads
    mod_x = _linear(sd, p + ".norm1.linear", F.silu(c))
    sh1, sc1, g1, sh2, sc2, g2 = mod_x.chunk(6, dim=-1)
    if pre_only:  # AdaLayerNormContinuous: [scale, shift]
        mod_c = _linear(sd, p + ".norm1_context.linear", F.silu(c))
        csc1, csh1 = mod_c.chunk(2, dim=-1)
    else:
        mod_c = _linear(sd, p + ".norm1_context.linear", F.silu(c))
        csh1, csc1, cg1, csh2, csc2, cg2 = mod_c.chunk(6, dim=-1)

    xm = _ln_noaffine(x) * (1 + sc1[:, None]) + sh1[:, None]
    cm = _ln_noaffine(ctx) * (1 + csc1[:, None]) + csh1[:, None]

    B, Nx, _ = xm.shape
    Nc = cm.shape[1]
    Dh = D // H

    def heads(t, n):
        return t.view(B, n, H, Dh)

    q = heads(_linear(sd, p + ".attn.to_q", xm), Nx)
    k = heads(_linear(sd, p + ".attn.to_k", xm), Nx)
    v = heads(_linear(sd, p + ".attn.to_v", xm), Nx)
    qc = heads(_linear(sd, p + ".attn.add_q_proj", cm), Nc)
    kc = heads(_linear(sd, p + ".attn.add_k_proj", cm), Nc)
    vc = heads(_linear(sd, p + ".attn.add_v_proj", cm), Nc)
    if p + ".attn.norm_q.weight" in sd:  # SD3.5 qk RMSNorm
        q = _rms_norm(sd, p + ".attn.norm_q", q)
        k = _rms_norm(sd, p + ".attn.norm_k", k)
        qc = _rms_norm(sd, p + ".attn.norm_added_q", qc)
        kc = _rms_norm(sd, p + ".attn.norm_added_k", kc)
    # joint attention: SAMPLE tokens first, then context
    q = torch.cat([q, qc], dim=1).transpose(1, 2)
    k = torch.cat([k, kc], dim=1).transpose(1, 2)
    v = torch.cat([v, vc], dim=1).transpose(1, 2)
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2)
    attn_x = o[:, :Nx].reshape(B, Nx, D)
    attn_c = o[:, Nx:].reshape(B, Nc, D)

    x = x + g1[:, None] * _linear(sd, p + ".attn.to_out.0", attn_x)
    xm2 = _ln_noaffine(x) * (1 + sc2[:, None]) + sh2[:, None]
    h = _linear(sd, p + ".ff.net.0.proj", xm2)
    x = x + g2[:, None] * _linear(sd, p + ".ff.net.2",
                                  F.gelu(h, approximate="tanh"))
    if pre_only:
        return x, ctx
    ctx = ctx + cg1[:, None] * _linear(sd, p + ".attn.to_add_out", attn_c)
    cm2 = _ln_noaffine(ctx) * (1 + csc2[:, None]) + csh2[:, None]
    hc = _linear(sd, p + ".ff_context.net.0.proj", cm2)
    ctx = ctx + cg2[:, None] * _linear(sd, p + ".ff_context.net.2",
                                       F.gelu(hc, approximate="tanh"))
    return x, ctx


@torch.no_grad()
def torch_mmdit_forward(sd, cfg: MMDiTConfig, latents, timesteps, ctx,
                        pooled):
    """diffusers SD3Transformer2DModel.forward on a raw state dict.
    latents (B, C, H, W), ctx (B, S, 4096), pooled (B, 2048)."""
    sd = _on(sd, latents)
    B = latents.shape[0]
    P = cfg.patch_size
    hp, wp = latents.shape[2] // P, latents.shape[3] // P
    x, c = _mmdit_stem(sd, cfg, latents, timesteps, pooled)
    context = _linear(sd, "context_embedder", ctx.float())
    for i in range(cfg.depth):
        x, context = _joint_block_fwd(sd, f"transformer_blocks.{i}", x,
                                      context, c, cfg,
                                      pre_only=(i == cfg.depth - 1))
    mod = _linear(sd, "norm_out.linear", F.silu(c))
    scale, shift = mod.chunk(2, dim=-1)
    x = _ln_noaffine(x) * (1 + scale[:, None]) + shift[:, None]
    x = _linear(sd, "proj_out", x)
    # unpatchify (nhwpqc -> nchpwq)
    x = x.reshape(B, hp, wp, P, P, cfg.out_channels)
    x = torch.einsum("nhwpqc->nchpwq", x)
    return x.reshape(B, cfg.out_channels, hp * P, wp * P)


@torch.no_grad()
def torch_sd3_controlnet_forward(sd, mmdit_cfg: MMDiTConfig, num_layers,
                                 latents, timesteps, ctx, pooled,
                                 cond_latents, conditioning_scale=1.0):
    """diffusers SD3ControlNetModel.forward on a raw state dict.
    cond_latents (B, C, H, W) — the VAE-encoded control image."""
    sd = _on(sd, latents)
    x, c = _mmdit_stem(sd, mmdit_cfg, latents, timesteps, pooled)
    cx = _conv(sd, "pos_embed_input.proj", cond_latents.float(),
               stride=mmdit_cfg.patch_size, padding=0)
    x = x + cx.flatten(2).transpose(1, 2)
    context = _linear(sd, "context_embedder", ctx.float())
    out = []
    for i in range(num_layers):
        x, context = _joint_block_fwd(sd, f"transformer_blocks.{i}", x,
                                      context, c, mmdit_cfg, pre_only=False)
        out.append(conditioning_scale
                   * _linear(sd, f"controlnet_blocks.{i}", x))
    return tuple(out)


# ------------------------------------------------ CLIP text, T5, CLIP vision ----
#
# transformers' CLIPTextModel(WithProjection), T5EncoderModel and
# CLIPVisionModelWithProjection, from their published forwards: ``sd`` is the
# checkpoint's own state dict (``text_model.*``, ``shared``/``encoder.*``,
# ``vision_model.*``).


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def _clip_layer(sd, p, x, heads, act, eps, causal):
    """transformers CLIPEncoderLayer: pre-LN self attention (q scaled by
    head_dim^-0.5), pre-LN MLP."""
    B, S, D = x.shape
    h = F.layer_norm(x, (D,), _w(sd, p + ".layer_norm1.weight"),
                     _w(sd, p + ".layer_norm1.bias"), eps)
    q = _linear(sd, p + ".self_attn.q_proj", h) * (D // heads) ** -0.5
    k = _linear(sd, p + ".self_attn.k_proj", h)
    v = _linear(sd, p + ".self_attn.v_proj", h)
    q, k, v = (t.view(B, S, heads, D // heads).transpose(1, 2) for t in (q, k, v))
    logits = q @ k.transpose(-1, -2)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
        logits = logits.masked_fill(mask, torch.finfo(logits.dtype).min)
    o = (logits.softmax(dim=-1) @ v).transpose(1, 2).reshape(B, S, D)
    x = x + _linear(sd, p + ".self_attn.out_proj", o)
    h = F.layer_norm(x, (D,), _w(sd, p + ".layer_norm2.weight"),
                     _w(sd, p + ".layer_norm2.bias"), eps)
    return x + _linear(sd, p + ".mlp.fc2", act(_linear(sd, p + ".mlp.fc1", h)))


@torch.no_grad()
def torch_clip_text_forward(sd, cfg, input_ids):
    """transformers CLIPTextModel(WithProjection).forward on a raw state
    dict.  ``cfg``: ``num_hidden_layers``, ``num_attention_heads``,
    ``hidden_act``, ``layer_norm_eps``, ``eos_token_id`` and
    ``use_text_projection``.  input_ids (B, S) -> {"last_hidden_state"
    (B, S, D), "pooled_output": the state at the first EOS (the legacy
    ``eos_token_id == 2`` checkpoints: at the largest id), projected by
    ``text_projection`` where the config has one}."""
    sd = _on(sd, input_ids)
    p = "text_model"
    S = input_ids.shape[1]
    x = (F.embedding(input_ids, _w(sd, p + ".embeddings.token_embedding.weight"))
         + _w(sd, p + ".embeddings.position_embedding.weight")[:S][None])
    act = _act(cfg.hidden_act)
    for i in range(cfg.num_hidden_layers):
        x = _clip_layer(sd, f"{p}.encoder.layers.{i}", x, cfg.num_attention_heads, act,
                        cfg.layer_norm_eps, causal=True)
    last = F.layer_norm(x, (x.shape[-1],), _w(sd, p + ".final_layer_norm.weight"),
                        _w(sd, p + ".final_layer_norm.bias"), cfg.layer_norm_eps)
    if cfg.eos_token_id == 2:
        eos = input_ids.to(torch.int64).argmax(dim=-1)
    else:
        eos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
    pooled = last[torch.arange(last.shape[0], device=last.device), eos]
    if cfg.use_text_projection:
        pooled = _linear(sd, "text_projection", pooled)
    return {"last_hidden_state": last, "pooled_output": pooled}


def _t5_rms(sd, name, x, eps):
    var = x.float().pow(2).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * _w(sd, name + ".weight")


def _t5_buckets(q_len, k_len, num_buckets, max_distance, device):
    """transformers T5Attention._relative_position_bucket, bidirectional."""
    ctx = torch.arange(q_len, dtype=torch.long, device=device)[:, None]
    mem = torch.arange(k_len, dtype=torch.long, device=device)[None, :]
    rel = mem - ctx
    num_buckets //= 2
    buckets = (rel > 0).to(torch.long) * num_buckets
    rel = rel.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(rel.float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(torch.long)
    large = torch.minimum(large, torch.full_like(large, num_buckets - 1))
    return buckets + torch.where(rel < max_exact, rel, large)


@torch.no_grad()
def torch_t5_encoder_forward(sd, cfg, input_ids, attention_mask=None):
    """transformers T5EncoderModel.forward (v1.1: gated-GELU feed-forward)
    on a raw state dict.  ``cfg``: ``num_layers``, ``num_heads``, ``d_kv``,
    ``relative_attention_num_buckets``, ``relative_attention_max_distance``,
    ``layer_norm_eps``.  -> last_hidden_state (B, S, d_model)."""
    sd = _on(sd, input_ids)
    B, S = input_ids.shape
    H, Dh = cfg.num_heads, cfg.d_kv
    x = F.embedding(input_ids, _w(sd, "shared.weight"))
    buckets = _t5_buckets(S, S, cfg.relative_attention_num_buckets,
                          cfg.relative_attention_max_distance, x.device)
    bias = F.embedding(buckets, _w(
        sd, "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"))
    bias = bias.permute(2, 0, 1)[None]  # (1, H, S, S)
    if attention_mask is not None:
        m = attention_mask.to(x.device)[:, None, None, :].float()
        bias = bias + (1.0 - m) * torch.finfo(torch.float32).min
    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}.layer"
        h = _t5_rms(sd, p + ".0.layer_norm", x, cfg.layer_norm_eps)
        q, k, v = (_linear(sd, f"{p}.0.SelfAttention.{n}", h).view(B, S, H, Dh).transpose(1, 2)
                   for n in "qkv")
        scores = q @ k.transpose(-1, -2) + bias  # no 1/sqrt(d) scaling
        o = (scores.float().softmax(dim=-1) @ v).transpose(1, 2).reshape(B, S, H * Dh)
        x = x + _linear(sd, f"{p}.0.SelfAttention.o", o)
        h = _t5_rms(sd, p + ".1.layer_norm", x, cfg.layer_norm_eps)
        gate = F.gelu(_linear(sd, f"{p}.1.DenseReluDense.wi_0", h), approximate="tanh")
        x = x + _linear(sd, f"{p}.1.DenseReluDense.wo",
                        gate * _linear(sd, f"{p}.1.DenseReluDense.wi_1", h))
    return _t5_rms(sd, "encoder.final_layer_norm", x, cfg.layer_norm_eps)


@torch.no_grad()
def torch_clip_vision_forward(sd, cfg, pixel_values, prefix="vision_model.",
                              projection="visual_projection"):
    """transformers CLIPVisionModelWithProjection.forward on a raw state
    dict: ``prefix`` + ``vision_model.*`` the tower, ``projection`` its
    bias-free projection (the safety checker's keys by default).  ``cfg``:
    ``patch_size``, ``num_hidden_layers``, ``num_attention_heads``,
    ``layer_norm_eps`` and ``hidden_act`` (quick_gelu where absent).
    pixel_values (B, 3, S, S), normalized -> {"pooled_output" (B, D),
    "image_embeds" (B, projection_dim)}."""
    sd = _on(sd, pixel_values)
    p = prefix + "vision_model"
    eps = getattr(cfg, "layer_norm_eps", 1e-5)
    patches = F.conv2d(pixel_values.float(), _w(sd, p + ".embeddings.patch_embedding.weight"),
                       stride=cfg.patch_size)
    patches = patches.flatten(2).transpose(1, 2)
    cls = _w(sd, p + ".embeddings.class_embedding").expand(patches.shape[0], 1, -1)
    x = (torch.cat([cls, patches], dim=1)
         + _w(sd, p + ".embeddings.position_embedding.weight")[None])
    D = x.shape[-1]
    x = F.layer_norm(x, (D,), _w(sd, p + ".pre_layrnorm.weight"),
                     _w(sd, p + ".pre_layrnorm.bias"), eps)
    act = _act(getattr(cfg, "hidden_act", "quick_gelu"))
    for i in range(cfg.num_hidden_layers):
        x = _clip_layer(sd, f"{p}.encoder.layers.{i}", x, cfg.num_attention_heads, act, eps,
                        causal=False)
    pooled = F.layer_norm(x[:, 0], (D,), _w(sd, p + ".post_layernorm.weight"),
                          _w(sd, p + ".post_layernorm.bias"), eps)
    return {"pooled_output": pooled, "image_embeds": _linear(sd, projection, pooled)}
