"""Plain float32 models of the benchmark's reference: the CLIP text encoder,
the conditional UNet (SD-2.x and SDXL base) and the VAE decoder.

Written from the published architectures (diffusers' ``CLIPTextModel``,
``UNet2DConditionModel`` with linear projections, ``AutoencoderKL``'s
decoder) and kept to the parameter names of those checkpoints, so that one
set of weights, made by ``sdbench.reference.weights`` from the seed, loads into
the program's modules and into these alike.  The math is plain ``torch``:
attention is an explicit softmax over f32 logits, normalisations are
``F.group_norm`` and ``F.layer_norm``, and nothing here imports the program.

Where the program departs from diffusers, these modules follow the program,
since the benchmark judges its outputs: the transformer LayerNorms use
eps 1e-6 and the transformer GroupNorm eps 1e-6 (the Flax models' values),
the causal mask of the text encoder is -1e4, and the GEGLU gate is the
exact erf GELU.

``Linear`` and ``Conv2d`` are the plain ``torch.nn`` layers, so the
control can hook their inputs, and the flop count runs these modules on
the ``meta`` device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _gelu_erf(x):
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def attention(q, k, v, causal: bool = False):
    """(B, S, H, D) -> (B, Sq, H, D): softmax(q k^T / sqrt(D)) v in the
    inputs' dtype, the causal mask at -1e4."""
    D = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (D ** -0.5)
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        logits = logits.masked_fill(~mask, -1e4)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)


# -- CLIP text encoder ----------------------------------------------------------

class _ClipAttention(nn.Module):
    def __init__(self, C: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(C, C)
        self.k_proj = nn.Linear(C, C)
        self.v_proj = nn.Linear(C, C)
        self.out_proj = nn.Linear(C, C)

    def forward(self, x):
        B, S, C = x.shape
        q, k, v = (p(x).view(B, S, self.heads, C // self.heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(attention(q, k, v, causal=True).reshape(B, S, C))


class _ClipMLP(nn.Module):
    def __init__(self, C: int, inner: int, act: str):
        super().__init__()
        self.fc1 = nn.Linear(C, inner)
        self.fc2 = nn.Linear(inner, C)
        self.act = _quick_gelu if act == "quick_gelu" else _gelu_erf

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _ClipLayer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        C, eps = c["hidden_size"], c["layer_norm_eps"]
        self.layer_norm1 = nn.LayerNorm(C, eps=eps)
        self.self_attn = _ClipAttention(C, c["num_attention_heads"])
        self.layer_norm2 = nn.LayerNorm(C, eps=eps)
        self.mlp = _ClipMLP(C, c["intermediate_size"], c["hidden_act"])

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _ClipEmbeddings(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.token_embedding = nn.Embedding(c["vocab_size"], c["hidden_size"])
        self.position_embedding = nn.Embedding(c["max_position_embeddings"], c["hidden_size"])


class _ClipEncoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layers = nn.ModuleList(_ClipLayer(c) for _ in range(c["num_hidden_layers"]))


class _ClipTransformer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.embeddings = _ClipEmbeddings(c)
        self.encoder = _ClipEncoder(c)
        self.final_layer_norm = nn.LayerNorm(c["hidden_size"], eps=c["layer_norm_eps"])


class ClipTextEncoder(nn.Module):
    """-> {"last_hidden_state", "penultimate_hidden_state", "pooled_output"}:
    the final LayerNorm's output, the second-to-last layer's output, and the
    final state at the first EOS token (through ``text_projection`` when the
    configuration has one)."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.text_model = _ClipTransformer(c)
        if c["use_text_projection"]:
            self.text_projection = nn.Linear(c["hidden_size"], c["projection_dim"], bias=False)

    def forward(self, ids):
        tm = self.text_model
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[
            None, :ids.shape[1]]
        states = []
        for layer in tm.encoder.layers:
            x = layer(x)
            states.append(x)
        last = tm.final_layer_norm(x)
        eos = (ids == self.c["eos_token_id"]).int().argmax(dim=1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos]
        if self.c["use_text_projection"]:
            pooled = self.text_projection(pooled)
        return {"last_hidden_state": last,
                "penultimate_hidden_state": states[-2] if len(states) > 1 else x,
                "pooled_output": pooled}


# -- UNet -----------------------------------------------------------------------

def timestep_embedding(t, dim: int, flip_sin_to_cos: bool = True, freq_shift: float = 0.0):
    """The sinusoidal embedding of ``t`` (B,) in float32."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - freq_shift)))
    emb = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    return F.pad(out, (0, 1)) if dim % 2 else out


class _MLP2(nn.Module):
    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d)
        self.linear_2 = nn.Linear(d, d)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int | None, groups: int, eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb is not None:
            self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class _Attention(nn.Module):
    def __init__(self, C: int, heads: int, ctx: int | None = None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(C, C, bias=False)
        self.to_k = nn.Linear(ctx or C, C, bias=False)
        self.to_v = nn.Linear(ctx or C, C, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(C, C)])

    def forward(self, x, context=None):
        context = x if context is None else context
        B, Sq, C = x.shape
        D = C // self.heads
        q = self.to_q(x).view(B, Sq, -1, D)
        k = self.to_k(context).view(B, context.shape[1], -1, D)
        v = self.to_v(context).view(B, context.shape[1], -1, D)
        return self.to_out[0](attention(q, k, v).reshape(B, Sq, C))


class _GEGLU(nn.Module):
    def __init__(self, C: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(C, 2 * inner)


class _FeedForward(nn.Module):
    def __init__(self, C: int):
        super().__init__()
        self.net = nn.ModuleList([_GEGLU(C, 4 * C), nn.Identity(), nn.Linear(4 * C, C)])

    def forward(self, x):
        a, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](a * _gelu_erf(gate))


class _TransformerBlock(nn.Module):
    def __init__(self, C: int, heads: int, ctx: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(C, eps=1e-6)
        self.attn1 = _Attention(C, heads)
        self.norm2 = nn.LayerNorm(C, eps=1e-6)
        self.attn2 = _Attention(C, heads, ctx)
        self.norm3 = nn.LayerNorm(C, eps=1e-6)
        self.ff = _FeedForward(C)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class _SpatialTransformer(nn.Module):
    def __init__(self, C: int, heads: int, depth: int, ctx: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, C, eps=1e-6)
        self.proj_in = nn.Linear(C, C)
        self.transformer_blocks = nn.ModuleList(
            _TransformerBlock(C, heads, ctx) for _ in range(depth))
        self.proj_out = nn.Linear(C, C)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C))
        for block in self.transformer_blocks:
            h = block(h, context)
        return x + self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)


class _Sampler(nn.Module):
    """``downsamplers.0`` (stride-2 3x3 conv, padding 1) or ``upsamplers.0``
    (nearest 2x, then a 3x3 conv)."""

    def __init__(self, C: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = nn.Conv2d(C, C, 3, stride=2 if down else 1, padding=1)

    def forward(self, x):
        return self.conv(x if self.down else F.interpolate(x, scale_factor=2.0,
                                                            mode="nearest"))


class _Block(nn.Module):
    def __init__(self, resnets, attentions=(), downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class UNet(nn.Module):
    """``forward(sample (B, C, H, W), t (B,), context (B, S, C_ctx),
    text_embeds (B, P) or None, time_ids (B, n) or None)`` -> eps (B, C, H, W)."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        ch = c["block_out_channels"]
        G, eps = c["norm_num_groups"], c["norm_eps"]
        temb = ch[0] * 4
        heads, depth = c["num_attention_heads"], c["transformer_layers_per_block"]
        ctx = c["cross_attention_dim"]
        L = c["layers_per_block"]

        def st(C, bi):
            return _SpatialTransformer(C, heads[bi], depth[bi], ctx, G)

        self.time_embedding = _MLP2(ch[0], temb)
        if c["addition_embed_type"] == "text_time":
            self.add_embedding = _MLP2(c["projection_class_embeddings_input_dim"], temb)
        self.conv_in = nn.Conv2d(c["in_channels"], ch[0], 3, padding=1)
        skips = [ch[0]]
        down, cin = [], ch[0]
        for bi, kind in enumerate(c["down_block_types"]):
            out = ch[bi]
            res, att = [], []
            for li in range(L):
                res.append(_Resnet(cin if li == 0 else out, out, temb, G, eps))
                if kind == "CrossAttnDownBlock2D":
                    att.append(st(out, bi))
                skips.append(out)
            final = bi == len(ch) - 1
            if not final:
                skips.append(out)
            down.append(_Block(res, att, downsample=None if final else _Sampler(out, True)))
            cin = out
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _Block([_Resnet(ch[-1], ch[-1], temb, G, eps) for _ in range(2)],
                                [st(ch[-1], len(ch) - 1)])
        up, h_ch = [], ch[-1]
        for bi, kind in enumerate(c["up_block_types"]):
            out = ch[len(ch) - 1 - bi]
            res, att = [], []
            for _ in range(L + 1):
                res.append(_Resnet(h_ch + skips.pop(), out, temb, G, eps))
                h_ch = out
                if kind == "CrossAttnUpBlock2D":
                    att.append(st(out, len(ch) - 1 - bi))
            final = bi == len(ch) - 1
            up.append(_Block(res, att, upsample=None if final else _Sampler(out, False)))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(G, ch[0], eps=eps)
        self.conv_out = nn.Conv2d(ch[0], c["out_channels"], 3, padding=1)

    def forward(self, x, t, context, text_embeds=None, time_ids=None):
        c = self.c
        B = x.shape[0]
        flip, shift = c["flip_sin_to_cos"], c["freq_shift"]
        emb = self.time_embedding(timestep_embedding(t.expand(B), c["block_out_channels"][0],
                                                     flip, shift))
        if c["addition_embed_type"] == "text_time":
            ids = timestep_embedding(time_ids.reshape(-1), c["addition_time_embed_dim"],
                                     flip, shift)
            emb = emb + self.add_embedding(torch.cat([text_embeds, ids.reshape(B, -1)], -1))
        h = self.conv_in(x)
        skips = [h]
        for block in self.down_blocks:
            for li, resnet in enumerate(block.resnets):
                h = resnet(h, emb)
                if hasattr(block, "attentions"):
                    h = block.attentions[li](h, context)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                skips.append(h)
        m = self.mid_block
        h = m.resnets[1](m.attentions[0](m.resnets[0](h, emb), context), emb)
        for block in self.up_blocks:
            for li, resnet in enumerate(block.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), emb)
                if hasattr(block, "attentions"):
                    h = block.attentions[li](h, context)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


# -- VAE decoder ----------------------------------------------------------------

class _VaeAttention(nn.Module):
    def __init__(self, C: int, groups: int, eps: float):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, C, eps=eps)
        self.to_q = nn.Linear(C, C)
        self.to_k = nn.Linear(C, C)
        self.to_v = nn.Linear(C, C)
        self.to_out = nn.ModuleList([nn.Linear(C, C)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, 1, C)
        h = attention(self.to_q(h), self.to_k(h), self.to_v(h))
        return x + self.to_out[0](h.reshape(B, H * W, C)).reshape(B, H, W, C).permute(
            0, 3, 1, 2)


class _VaeDecoderBody(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        rev = list(reversed(c["block_out_channels"]))
        G, eps = c["norm_num_groups"], c["norm_eps"]
        self.conv_in = nn.Conv2d(c["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = _Block([_Resnet(rev[0], rev[0], None, G, eps) for _ in range(2)],
                                [_VaeAttention(rev[0], G, eps)])
        self.up_blocks = nn.ModuleList(
            _Block([_Resnet(rev[max(bi - 1, 0)] if li == 0 else out, out, None, G, eps)
                    for li in range(c["layers_per_block"] + 1)],
                   upsample=_Sampler(out, False) if bi < len(rev) - 1 else None)
            for bi, out in enumerate(rev))
        self.conv_norm_out = nn.GroupNorm(G, rev[-1], eps=eps)
        self.conv_out = nn.Conv2d(rev[-1], c["out_channels"], 3, padding=1)

    def forward(self, z):
        m = self.mid_block
        h = m.resnets[1](m.attentions[0](m.resnets[0](self.conv_in(z))))
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VaeDecoder(nn.Module):
    """latents (B, C, h, w) -> image (B, 3, 8h, 8w), about [-1, 1]."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        if c["use_quant_conv"]:
            self.post_quant_conv = nn.Conv2d(c["latent_channels"], c["latent_channels"], 1)
        self.decoder = _VaeDecoderBody(c)

    def forward(self, z):
        if self.c["use_quant_conv"]:
            z = self.post_quant_conv(z)
        return self.decoder(z)


def build(kind: str, c: dict) -> nn.Module:
    """The reference module of ``kind`` ("clip", "unet" or "vae_decoder")."""
    return {"clip": ClipTextEncoder, "unet": UNet, "vae_decoder": VaeDecoder}[kind](c)
