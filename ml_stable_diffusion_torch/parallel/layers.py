"""The sharded layers (no JAX counterpart: GSPMD inserts this part in JAX).

Each rank holds plain tensors, and the layers issue ``torch.distributed``
collectives on ``torch.cuda.current_stream()``, so NCCL calls are captured
into the generation's CUDA graph (``pipelines/program.py``) and the port's
CUDA kernels, which take plain tensors, run on the local shards.

Tensor parallelism (``install_tensor_parallel``, which
``sharding.shard_params`` calls; activations stay replicated, as in JAX),
for inference and for the training step (``train.py``):

- ``ColumnLinear``: this rank's out-feature rows; the output is all-gathered
  on features (or, in a pair, left local);
- ``RowLinear``: this rank's in-feature columns over its slice of the input
  (or, in a pair, over the local input), one all-reduce in float32, then
  the bias, added once after the reduce;
- ``OutChannelConv2d``: a local conv over this rank's out channels, a
  gather on the channel axis, then the whole (replicated) bias;
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

Each sharded layer names, in ``shards``, the dim and the global indices of
every tensor it holds a shard of (``shard_layout`` collects them): its
placements as ``sharding.param_sharding_rules`` reports them, and how
``full_tensors`` and ``take_shards`` put a sharded state back together and
split a whole one (the checkpoint, ``train.full_state_dict``).

The backward follows GSPMD's semantics for the JAX step: activations and
the loss are replicated over tp, so every rank already holds the whole
gradient of a replicated tensor.  The four differentiable collectives are
the megatron f/g pairs for that case: ``copy_to_tp`` (identity; the
backward sums the partial input gradients of a column layer over tp),
``reduce_from_tp`` (the float32 all-reduce; the backward is the identity),
``gather_from_tp`` (all-gather; the backward keeps this rank's slice) and
``scatter_to_tp`` (this rank's slice; the backward all-gathers).
``torch.distributed.nn.functional`` is not used: its all-reduce sums the
gradient again and its all-gather reduce-scatters it, which is right when
each rank has a loss of its own and scales every gradient by tp here.
Replicated parameters thus get equal gradients on every tp rank and stay
equal after an update.  ``LocalRowsLinear`` (IP-Adapter) and the spatial
layers are forward-only: the training step never runs them.

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
    """The sum over the ranks of ``y``, reduced in float32 into a new tensor
    (a gradient handed to a backward may be shared with another branch)."""
    y = y.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=g.group)
    return y


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_f32(grad, ctx.g).to(grad.dtype), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, g):
        ctx.dtype = y.dtype
        return all_reduce_f32(y, g)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g, ctx.n = dim, g, x.shape[dim]
        return all_gather(x, dim, g)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.g.rank * ctx.n, ctx.n).contiguous(), None, None


class _ScatterToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        n = x.shape[dim] // g.size
        return x.narrow(dim, g.rank * n, n)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.dim, ctx.g), None, None


def copy_to_tp(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """``x`` (replicated) into a layer that computes a part of its output on
    each rank; the backward sums the ranks' input gradients."""
    return _CopyToTP.apply(x, g)


def reduce_from_tp(y: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """``all_reduce_f32(y)``, whose backward hands the (replicated) gradient
    to each rank's partial sum as it is."""
    return _ReduceFromTP.apply(y, g)


def gather_from_tp(x: torch.Tensor, dim: int, g: AxisGroup) -> torch.Tensor:
    """``all_gather(x, dim)``, whose backward keeps this rank's slice of the
    (replicated) gradient."""
    return _GatherFromTP.apply(x, dim % x.ndim, g)


def scatter_to_tp(x: torch.Tensor, dim: int, g: AxisGroup) -> torch.Tensor:
    """This rank's equal slice of ``x`` (replicated) on ``dim``, whose
    backward all-gathers the slices' gradients."""
    return _ScatterToTP.apply(x, dim % x.ndim, g)


def _param(t: torch.Tensor, like: nn.Parameter) -> nn.Parameter:
    return nn.Parameter(t.detach().clone().contiguous(), requires_grad=like.requires_grad)


def _own(n: int, g: AxisGroup) -> slice:
    step = n // g.size
    return slice(g.rank * step, (g.rank + 1) * step)


def _index(rows, n: int) -> torch.Tensor:
    """The global indices ``rows`` (a slice or an index tensor) of ``n``."""
    return torch.arange(n)[rows]


def shard_layout(module: nn.Module) -> dict:
    """{state-dict key: (dim, global indices this rank holds, tp group)} of
    every tensor that a sharded layer of ``module`` holds a shard of, as
    the layer's ``shards`` name them."""
    return {f"{name}.{leaf}" if name else leaf: (dim, index, m.tp)
            for name, m in module.named_modules()
            for leaf, (dim, index) in getattr(m, "shards", {}).items()}


def full_tensors(module: nn.Module, tensors: dict) -> dict:
    """``tensors`` (keyed as ``module.state_dict()``, each of its local
    shape) with every sharded one gathered over tp into its whole, unsharded
    shape, its rows in their global order.  Every rank of the tp group
    calls it."""
    out = dict(tensors)
    for key, (dim, index, g) in shard_layout(module).items():
        if out.get(key) is not None:
            parts = all_gather(out[key].movedim(dim, 0), 0, g)
            idx = all_gather(index.to(parts.device), 0, g)
            whole = torch.empty_like(parts).index_copy_(0, idx, parts)
            out[key] = whole.movedim(0, dim).contiguous()
    return out


def take_shards(module: nn.Module, tensors: dict) -> dict:
    """``tensors`` in their whole shapes with every tensor that a layer of
    ``module`` shards cut to this rank's shard (the inverse of
    ``full_tensors``)."""
    out = dict(tensors)
    for key, (dim, index, _) in shard_layout(module).items():
        if out.get(key) is not None:
            out[key] = out[key].index_select(dim, index.to(out[key].device))
    return out


# -- tensor parallelism -----------------------------------------------------------------


class ColumnLinear(nn.Module):
    """A ``Linear`` holding the out-feature rows ``rows`` of this rank;
    ``gather``: all-gather the output on features (the generic form)."""

    def __init__(self, linear: nn.Linear, g: AxisGroup, rows, gather: bool):
        super().__init__()
        self.tp, self.gather = g, gather
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.weight = _param(linear.weight[rows], linear.weight)
        self.bias = None if linear.bias is None else _param(linear.bias[rows], linear.bias)
        index = _index(rows, linear.out_features)
        self.shards = {"weight": (0, index), "bias": (0, index)}

    def forward(self, x):
        y = F.linear(copy_to_tp(x, self.tp), self.weight, self.bias)
        return gather_from_tp(y, -1, self.tp) if self.gather else y


class RowLinear(nn.Module):
    """A ``Linear`` holding the in-feature columns of this rank;
    ``local_input``: the input is already this rank's slice (a pair's second
    half), else the replicated input is sliced here."""

    def __init__(self, linear: nn.Linear, g: AxisGroup, local_input: bool):
        super().__init__()
        self.tp, self.local_input = g, local_input
        self.in_features, self.out_features = linear.in_features, linear.out_features
        cols = _own(linear.in_features, g)
        self.weight = _param(linear.weight[:, cols], linear.weight)
        self.bias = None if linear.bias is None else _param(linear.bias, linear.bias)
        self.shards = {"weight": (1, _index(cols, linear.in_features))}

    def forward(self, x):
        if not self.local_input:
            x = scatter_to_tp(x, -1, self.tp)
        y = reduce_from_tp(F.linear(x, self.weight), self.tp)
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
    """A ``Conv2d`` holding this rank's out channels; the output is gathered
    on the channel axis, then the bias, replicated as the JAX rule leaves
    it, is added whole (so every rank gets all of its gradient)."""

    def __init__(self, conv: nn.Conv2d, g: AxisGroup):
        super().__init__()
        if conv.groups != 1 or conv.padding_mode != "zeros":
            raise ValueError(f"out-channel sharding takes a dense zero-padded conv, got {conv}")
        self.tp = g
        rows = _own(conv.out_channels, g)
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.weight = _param(conv.weight[rows], conv.weight)
        self.bias = None if conv.bias is None else _param(conv.bias, conv.bias)
        self.shards = {"weight": (0, _index(rows, conv.out_channels))}

    def forward(self, x):
        y = F.conv2d(copy_to_tp(x, self.tp), self.weight, None, self.stride, self.padding,
                     self.dilation)
        y = gather_from_tp(y, 1, self.tp)
        return y if self.bias is None else y + self.bias[:, None, None]


class FeatureShardedEmbedding(nn.Module):
    """An ``Embedding`` holding this rank's feature columns; the looked-up
    rows are gathered on features."""

    def __init__(self, emb: nn.Embedding, g: AxisGroup):
        super().__init__()
        self.tp = g
        cols = _own(emb.weight.shape[1], g)
        self.weight = _param(emb.weight[:, cols], emb.weight)
        self.shards = {"weight": (1, _index(cols, emb.weight.shape[1]))}

    def forward(self, ids):
        return gather_from_tp(F.embedding(ids, self.weight), -1, self.tp)


class ShardedPatchEmbed(_PatchEmbed):
    """The MMDiT patch embedding with its positional table on this rank's
    feature columns: the cropped table is gathered on features and added."""

    def forward(self, latents):
        x = self.proj(latents)
        hp, wp = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)
        M, d = self.max_size, self.pos_embed.shape[-1]
        top, left = (M - hp) // 2, (M - wp) // 2
        pos = self.pos_embed.view(1, M, M, d)[:, top:top + hp, left:left + wp]
        pos = gather_from_tp(pos.reshape(1, hp * wp, d), -1, self.tp)
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
        cols = _own(pos.shape[-1], g)
        new = _recast(m, ShardedPatchEmbed, tp=g,
                      shards={"pos_embed": (2, _index(cols, pos.shape[-1]))})
        new.pos_embed = _param(pos[..., cols], pos)
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
