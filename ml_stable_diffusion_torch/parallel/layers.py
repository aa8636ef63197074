"""The sharded layers (no JAX counterpart: GSPMD inserts this part in JAX).

Each rank holds plain tensors, and the layers issue ``torch.distributed``
collectives on ``torch.cuda.current_stream()``, so NCCL calls are captured
into the generation's CUDA graph (``pipelines/program.py``) and the port's
CUDA kernels, which take plain tensors, run on the local shards.

Tensor parallelism (``install_tensor_parallel``, which
``sharding.shard_params`` calls; activations stay replicated, as in JAX):

- ``ColumnLinear``: this rank's out-feature rows; the output is all-gathered
  on features (or, in a pair, left local);
- ``RowLinear``: this rank's in-feature columns over its slice of the input
  (or, in a pair, over the local input), one all-reduce in float32, then
  the bias, added once after the reduce;
- ``OutChannelConv2d``: a local conv over this rank's out channels, then a
  gather on the channel axis;
- ``FeatureShardedEmbedding``, ``ShardedPatchEmbed``: T5's ``shared`` table
  and the MMDiT positional table on their feature axis, gathered after use;
- the megatron pair in ``models/unet.py``'s ``Attention`` and
  ``FeedForward``, where the heads (and the GEGLU's inner width) divide tp:
  q, k and v keep the local heads, attention (the flash kernel on the card)
  runs at the local head count, and ``to_out.0`` is row-parallel over them:
  one all-reduce a block.  The GEGLU's ``net.0.proj`` is one Linear whose
  output is split in two by ``chunk(2)``, so a rank keeps matching slices of
  both halves (its rows, not a contiguous 2·inner/tp run, though the rule
  still reads ``Shard(0)``); IP-Adapter's ``to_k_ip``/``to_v_ip`` stay
  replicated and give the local heads only.  Any other attention (a head
  count tp does not divide, a fused ``to_qkv``) runs the generic form.

Spatial parallelism (``spatial_copy``; the latent H axis split over tp):

- ``HaloConv2d``: a 3x3 conv exchanges one row with each neighbour (the
  stride-2 one needs only the row above when each rank's H is even); the
  rows travel by one all-gather of every rank's edge rows;
- ``SpatialGroupNorm``: each (image, group)'s float32 sum and sum of squares
  all-reduced over tp, for the plain and low-memory GroupNorm+SiLU and the
  transformers' ``norm``; the fused GroupNorm+SiLU computes its statistics
  inside the kernel, which GSPMD cannot partition (``pallas_call``) and
  gathers around in JAX, and so does the port: the image is gathered over
  H, the kernel runs on it, and each rank keeps its own rows;
- ``SpatialAttention``: self attention keeps q's local tokens and
  all-gathers k and v over tokens (the flash kernel runs at Sq = local
  tokens over Sk = all of them); cross attention stays local.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from ..models.mmdit import _PatchEmbed
from ..models.unet import Attention, FeedForward
from ..ops.groupnorm import group_norm_silu


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One mesh axis as this rank sees it: the process group, this rank's
    index on the axis and the axis size."""

    group: object
    rank: int
    size: int


def axis_group(mesh, axis: str) -> AxisGroup:
    return AxisGroup(mesh.get_group(axis), mesh.get_local_rank(axis),
                     mesh.size(mesh.mesh_dim_names.index(axis)))


#: ``all_gather_into_tensor`` under its newer name where torch has it
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(x: torch.Tensor, dim: int, g: AxisGroup) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (gloo takes
    only the concatenated form of the output)."""
    d = dim % x.ndim
    out = x.new_empty((g.size * x.shape[0], *x.shape[1:]))
    _gather_into(out, x.contiguous(), group=g.group)
    return out.view(g.size, *x.shape).movedim(0, d).flatten(d, d + 1)


def all_reduce_f32(y: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """The sum over the ranks of ``y``, reduced in float32."""
    y = y.float().contiguous()
    dist.all_reduce(y, group=g.group)
    return y


def _param(t: torch.Tensor, like: nn.Parameter) -> nn.Parameter:
    return nn.Parameter(t.detach().clone().contiguous(), requires_grad=like.requires_grad)


def _own(n: int, g: AxisGroup) -> slice:
    step = n // g.size
    return slice(g.rank * step, (g.rank + 1) * step)


# -- tensor parallelism -----------------------------------------------------------------


class ColumnLinear(nn.Module):
    """A ``Linear`` holding the out-feature rows ``rows`` of this rank;
    ``gather``: all-gather the output on features (the generic form)."""

    placements = {"weight": Shard(0), "bias": Shard(0)}

    def __init__(self, linear: nn.Linear, g: AxisGroup, rows, gather: bool):
        super().__init__()
        self.tp, self.gather = g, gather
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.weight = _param(linear.weight[rows], linear.weight)
        self.bias = None if linear.bias is None else _param(linear.bias[rows], linear.bias)

    def forward(self, x):
        y = F.linear(x, self.weight, self.bias)
        return all_gather(y, -1, self.tp) if self.gather else y


class RowLinear(nn.Module):
    """A ``Linear`` holding the in-feature columns of this rank;
    ``local_input``: the input is already this rank's slice (a pair's second
    half), else the replicated input is sliced here."""

    placements = {"weight": Shard(1), "bias": Replicate()}

    def __init__(self, linear: nn.Linear, g: AxisGroup, local_input: bool):
        super().__init__()
        self.tp, self.local_input = g, local_input
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.cols = _own(linear.in_features, g)
        self.weight = _param(linear.weight[:, self.cols], linear.weight)
        self.bias = None if linear.bias is None else _param(linear.bias, linear.bias)

    def forward(self, x):
        if not self.local_input:
            x = x[..., self.cols]
        y = all_reduce_f32(F.linear(x, self.weight), self.tp)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class LocalRowsLinear(nn.Linear):
    """A replicated ``Linear`` of which this rank computes only its
    out-feature rows ``rows`` (IP-Adapter's k and v in a paired attention)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias[self.rows]
        return F.linear(x, self.weight[self.rows], b)


class OutChannelConv2d(nn.Module):
    """A ``Conv2d`` holding this rank's out channels (the bias stays
    replicated, as the JAX rule leaves it); the output is gathered on the
    channel axis."""

    placements = {"weight": Shard(0), "bias": Replicate()}

    def __init__(self, conv: nn.Conv2d, g: AxisGroup):
        super().__init__()
        if conv.groups != 1 or conv.padding_mode != "zeros":
            raise ValueError(f"out-channel sharding takes a dense zero-padded conv, got {conv}")
        self.tp = g
        self.rows = _own(conv.out_channels, g)
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.weight = _param(conv.weight[self.rows], conv.weight)
        self.bias = None if conv.bias is None else _param(conv.bias, conv.bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias[self.rows]
        y = F.conv2d(x, self.weight, b, self.stride, self.padding, self.dilation)
        return all_gather(y, 1, self.tp)


class FeatureShardedEmbedding(nn.Module):
    """An ``Embedding`` holding this rank's feature columns; the looked-up
    rows are gathered on features."""

    placements = {"weight": Shard(1)}

    def __init__(self, emb: nn.Embedding, g: AxisGroup):
        super().__init__()
        self.tp = g
        self.weight = _param(emb.weight[:, _own(emb.weight.shape[1], g)], emb.weight)

    def forward(self, ids):
        return all_gather(F.embedding(ids, self.weight), -1, self.tp)


class ShardedPatchEmbed(_PatchEmbed):
    """The MMDiT patch embedding with its positional table on this rank's
    feature columns: the cropped table is gathered on features and added."""

    placements = {"pos_embed": Shard(2)}

    def forward(self, latents):
        x = self.proj(latents)
        hp, wp = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)
        M, d = self.max_size, self.pos_embed.shape[-1]
        top, left = (M - hp) // 2, (M - wp) // 2
        pos = self.pos_embed.view(1, M, M, d)[:, top:top + hp, left:left + wp]
        pos = all_gather(pos.reshape(1, hp * wp, d), -1, self.tp)
        return x + pos.to(x.dtype)


def _recast(m: nn.Module, cls, **attrs) -> nn.Module:
    """``m`` as an instance of its subclass ``cls`` sharing its parameters,
    buffers and children (tables of its own), with plain ``attrs``."""
    new = cls.__new__(cls)
    new.__dict__.update(m.__dict__)
    for table in ("_parameters", "_buffers", "_modules"):
        new.__dict__[table] = dict(m.__dict__[table])
    new.__dict__.update(attrs)
    return new


def _rule_of(rules):
    def rule(name: str, leaf: str):
        return rules.get(f"{name}.{leaf}" if name else leaf, Replicate())
    return rule


def _pairs_attention(m: Attention, name: str, rule, g: AxisGroup) -> bool:
    return (not hasattr(m, "to_qkv") and m.heads % g.size == 0
            and all(isinstance(getattr(m, p), nn.Linear)
                    and rule(f"{name}.{p}", "weight") == Shard(0)
                    for p in ("to_q", "to_k", "to_v"))
            and isinstance(m.to_out[0], nn.Linear)
            and rule(f"{name}.to_out.0", "weight") == Shard(1))


def _pairs_feed_forward(m: FeedForward, name: str, rule, g: AxisGroup) -> bool:
    proj, out = m.net[0].proj, m.net[2]
    return (isinstance(proj, nn.Linear) and isinstance(out, nn.Linear)
            and out.in_features % g.size == 0
            and rule(f"{name}.net.0.proj", "weight") == Shard(0)
            and rule(f"{name}.net.2", "weight") == Shard(1))


def _tensor_parallel(m: nn.Module, name: str, rule, g: AxisGroup) -> nn.Module | None:
    """``m``'s replacement (``m`` itself when its children were replaced in
    place), or None to look at its children."""
    if isinstance(m, Attention) and _pairs_attention(m, name, rule, g):
        rows = _own(m.to_q.out_features, g)
        for p in ("to_q", "to_k", "to_v"):
            setattr(m, p, ColumnLinear(getattr(m, p), g, rows, gather=False))
        m.to_out[0] = RowLinear(m.to_out[0], g, local_input=True)
        for p in ("to_k_ip", "to_v_ip"):
            if hasattr(m, p):
                setattr(m, p, _recast(getattr(m, p), LocalRowsLinear, rows=rows))
        return m
    if isinstance(m, FeedForward) and _pairs_feed_forward(m, name, rule, g):
        inner = m.net[2].in_features
        own = torch.arange(inner)[_own(inner, g)]
        m.net[0].proj = ColumnLinear(m.net[0].proj, g, torch.cat([own, inner + own]),
                                     gather=False)
        m.net[2] = RowLinear(m.net[2], g, local_input=True)
        return m
    if isinstance(m, _PatchEmbed) and rule(name, "pos_embed") == Shard(2):
        pos = m.pos_embed
        new = _recast(m, ShardedPatchEmbed, tp=g)
        new.pos_embed = _param(pos[..., _own(pos.shape[-1], g)], pos)
        conv = _tensor_parallel(m.proj, f"{name}.proj", rule, g)
        if conv is not None:
            new.proj = conv
        return new
    if isinstance(m, nn.Linear):
        w = rule(name, "weight")
        if w == Shard(0):
            return ColumnLinear(m, g, _own(m.out_features, g), gather=True)
        if w == Shard(1):
            return RowLinear(m, g, local_input=False)
        return m
    if isinstance(m, nn.Conv2d):
        return OutChannelConv2d(m, g) if rule(name, "weight") == Shard(0) else m
    if isinstance(m, nn.Embedding):
        return FeatureShardedEmbedding(m, g) if rule(name, "weight") == Shard(1) else m
    return None


def install_tensor_parallel(root: nn.Module, rules: dict, mesh):
    """Replace, in place, every module of ``root`` that ``rules`` shards."""
    g, rule = axis_group(mesh, "tp"), _rule_of(rules)

    def visit(m, prefix):
        for child_name, child in list(m.named_children()):
            name = prefix + child_name
            new = _tensor_parallel(child, name, rule, g)
            if new is None:
                visit(child, name + ".")
            elif new is not child:
                setattr(m, child_name, new)

    visit(root, "")


# -- spatial parallelism ----------------------------------------------------------------


def _edge_rows(x: torch.Tensor, g: AxisGroup, below: bool):
    """(the row above this rank's rows, the row below, or None when not
    ``below``): every rank's first and last rows gathered; zeros at the
    image's edges, as the convs' zero padding."""
    edges = all_gather(torch.cat([x[:, :, :1], x[:, :, -1:]], dim=2), 0, g)
    edges = edges.view(g.size, *x.shape[:2], 2, x.shape[3])
    zero = torch.zeros_like(x[:, :, :1])
    above = edges[g.rank - 1, :, :, 1:2] if g.rank > 0 else zero
    if not below:
        return above, None
    return above, edges[g.rank + 1, :, :, 0:1] if g.rank < g.size - 1 else zero


class HaloConv2d(nn.Conv2d):
    """A 3x3 conv (stride 1 or 2, padding 1) over this rank's rows of the
    image, with the neighbours' rows it reads."""

    def forward(self, x):
        if self.stride[0] == 1:
            above, below = _edge_rows(x, self.tp, below=True)
            x = torch.cat([above, x, below], dim=2)
        else:  # an even row count a rank (make_spatial_sharded_forward checks H)
            above, _ = _edge_rows(x, self.tp, below=False)
            x = torch.cat([above, x], dim=2)
        return F.conv2d(x, self.weight, self.bias, self.stride, (0, self.padding[1]))


def _stats(x: torch.Tensor, groups: int, g: AxisGroup, from_dtype: bool):
    """Per (image, group) mean and E[x²] over the whole image: float32 sums
    (of x's own dtype values when ``from_dtype``, as the low-memory
    formulation reduces) all-reduced over the ranks."""
    B = x.shape[0]
    xg = x.reshape(B, groups, -1)
    if not from_dtype:
        xg = xg.float()
    sums = torch.stack([xg.sum(-1, dtype=torch.float32), (xg * xg).sum(-1, dtype=torch.float32)])
    dist.all_reduce(sums, group=g.group)
    n = xg.shape[-1] * g.size
    return sums[0] / n, sums[1] / n


class SpatialGroupNorm(nn.GroupNorm):
    """A GroupNorm over this rank's rows with statistics of the whole
    image; ``gn_silu`` serves ``ResnetBlock2D``'s three GroupNorm+SiLU
    modes."""

    def forward(self, x):
        return self._affine(x, *self._plain_stats(x))

    def _plain_stats(self, x):
        mean, mean2 = _stats(x, self.num_groups, self.tp, from_dtype=False)
        return mean, torch.rsqrt(mean2 - mean * mean + self.eps)

    def _affine(self, x, mean, inv):
        B, C = x.shape[:2]
        xg = x.float().reshape(B, self.num_groups, -1)
        y = ((xg - mean[..., None]) * inv[..., None]).reshape(x.shape)
        y = y * self.weight.float()[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)

    def gn_silu(self, x, mode: str):
        """GroupNorm+SiLU as ``ResnetBlock2D._gn_silu`` computes it in
        ``mode`` ("plain", "lowmem" or "fused")."""
        if mode == "plain":
            return F.silu(self(x))
        if mode == "fused":
            full = all_gather(x, 2, self.tp)
            y = group_norm_silu(full, self.weight, self.bias, self.num_groups, self.eps)
            return y[:, :, _own(full.shape[2], self.tp)].contiguous().to(self.weight.dtype)
        if mode != "lowmem":
            raise ValueError(f"unknown GroupNorm mode {mode!r}")
        x = x.to(self.weight.dtype)
        mean, mean2 = _stats(x, self.num_groups, self.tp, from_dtype=True)
        inv = torch.rsqrt(torch.clamp(mean2 - mean * mean, min=0.0) + self.eps)
        cg = x.shape[1] // self.num_groups
        a = inv.repeat_interleave(cg, dim=1) * self.weight.float()
        b = self.bias.float() - mean.repeat_interleave(cg, dim=1) * a
        return F.silu(x.float() * a[:, :, None, None] + b[:, :, None, None]).to(x.dtype)


class SpatialAttention(Attention):
    """Self attention over this rank's tokens as queries and every rank's
    as keys and values; cross attention as it is."""

    def self_attention_kv(self, k, v):
        return all_gather(k, 1, self.tp), all_gather(v, 1, self.tp)


def spatial_copy(m: nn.Module, g: AxisGroup) -> nn.Module:
    """A copy of ``m`` that runs on this rank's rows of the image, sharing
    every parameter and buffer with ``m`` (which stays as it is)."""
    from ..ops.int8 import Int8Conv2d

    if isinstance(m, nn.GroupNorm):
        new = _recast(m, SpatialGroupNorm, tp=g)
    elif isinstance(m, nn.Conv2d) and m.kernel_size != (1, 1):
        if (m.kernel_size != (3, 3) or m.padding != (1, 1) or m.stride[0] not in (1, 2)
                or m.dilation != (1, 1) or m.groups != 1 or m.padding_mode != "zeros"):
            raise ValueError(f"spatial sharding takes 3x3 convs of padding 1, got {m}")
        new = _recast(m, HaloConv2d, tp=g)
    elif isinstance(m, Int8Conv2d) and m.weight_q.shape[2:] != (1, 1):
        raise ValueError("spatial sharding does not split the rows of a W8A8 conv")
    elif isinstance(m, Attention):
        new = _recast(m, SpatialAttention, tp=g)
    else:
        new = copy.copy(m)
        new._modules = dict(m._modules)
    for name, child in new._modules.items():
        if child is not None:
            new._modules[name] = spatial_copy(child, g)
    return new
