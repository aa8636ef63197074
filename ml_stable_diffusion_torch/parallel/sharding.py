"""Tensor-parallel sharding rules for the port's modules (port of
ml_stable_diffusion_tpu/parallel/sharding.py).

The JAX rules annotate a Flax parameter tree and leave the collectives to
GSPMD.  Here the same rules are keyed by the port's own (diffusers and
transformers) module names, and ``shard_params`` installs the layers of
``parallel/layers.py``, which hold each rank's shard and issue the
collectives themselves:

- megatron column/row pairs for attention and MLP projections: q/k/v and
  the MLP ins split on the output features, the outs on the input features;
  where a UNet attention's heads and a GEGLU's inner width divide tp the
  pair runs with one all-reduce a block (``layers.py``);
- out-channel sharding for conv kernels with at least tp·8 out channels;
- T5's ``shared`` embedding and the MMDiT positional table on their
  feature axis;
- everything else replicated, W8A8 int8 layers and palettized weights too.

No rule covers the MMDiT-X dual-attention blocks' ``attn2`` (SD3.5-medium):
a module that holds one is refused with a ``ValueError`` naming the blocks,
before anything is placed, rather than run with ``attn2`` replicated.

Layouts translate from Flax's: a Dense kernel is (in, out) where a torch
``Linear.weight`` is (out, in), so JAX's column spec ``P(None, "tp")`` is
``Shard(0)`` here and the row spec ``P("tp", None)`` is ``Shard(1)``; an
HWIO conv kernel split on its last axis is ``Shard(0)`` of an OIHW weight;
the (M, M, D) positional table is (1, M·M, D) here, ``Shard(2)``.
"""

from __future__ import annotations

from torch import nn
from torch.distributed.tensor import Replicate, Shard

#: column-parallel modules (output features over tp), the port's names of
#: the JAX ``_COL``: UNet/CLIP attention q/k/v, GEGLU and MLP ins, time
#: embedding ins, proj_in; MMDiT context-stream q/k/v, both FF ins, the adaLN
#: modulation producers, the context embedder; T5 q/k/v and gated-GELU ins
_COL = (
    "to_q", "to_k", "to_v", "fc1", "ff.net.0.proj", "linear_1",
    "q_proj", "k_proj", "v_proj", "proj_in",
    "add_q_proj", "add_k_proj", "add_v_proj", "ff_context.net.0.proj",
    "norm1.linear", "norm1_context.linear", "norm_out.linear", "context_embedder",
    "SelfAttention.q", "SelfAttention.k", "SelfAttention.v", "wi_0", "wi_1",
)
#: row-parallel modules (input features over tp), the port's names of the
#: JAX ``_ROW``: attention outs, MLP outs (the UNet FeedForward's
#: ``proj_out`` is ``ff.net.2``), time embedding outs, every ``proj_out``
_ROW = (
    "to_out.0", "fc2", "linear_2", "out_proj",
    "to_add_out", "ff.net.2", "ff_context.net.2",
    "SelfAttention.o", "wo", "proj_out",
)


def _named(module_name: str, table) -> bool:
    return any(module_name == s or module_name.endswith("." + s) for s in table)


def tp_size(mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("tp"))



def _placement(module_name: str, leaf: str, owner: nn.Module, tensor, tp: int):
    """JAX ``_spec_for`` on the port's names and layouts."""
    own = getattr(owner, "shards", None)
    if own is not None:  # an installed sharded layer reports its own layout
        return Shard(own[leaf][0]) if leaf in own else Replicate()
    col = _named(module_name, _COL)
    # sizes from the modules: a palettized weight in program mode is empty
    if isinstance(owner, nn.Linear):
        out_f, in_f = owner.out_features, owner.in_features
        if leaf == "weight":
            if col and out_f % tp == 0:
                return Shard(0)
            if _named(module_name, _ROW) and in_f % tp == 0:
                return Shard(1)
        elif leaf == "bias" and col and out_f % tp == 0:
            return Shard(0)
        return Replicate()
    if isinstance(owner, nn.Conv2d):
        out_c = owner.out_channels
        if leaf == "weight" and out_c % tp == 0 and out_c >= tp * 8:
            return Shard(0)
        return Replicate()
    if isinstance(owner, nn.Embedding):
        if module_name.rsplit(".", 1)[-1] == "shared" and owner.embedding_dim % tp == 0:
            return Shard(1)
        return Replicate()
    if leaf == "pos_embed" and tensor.ndim == 3 and tensor.shape[-1] % tp == 0:
        return Shard(2)
    return Replicate()


def refuse_dual_attention(module: nn.Module):
    """Raise ``ValueError`` if ``module`` holds MMDiT-X dual-attention
    blocks, whose ``attn2`` no rule shards."""
    from ..models.mmdit import JointTransformerBlock

    dual = [name for name, m in module.named_modules()
            if isinstance(m, JointTransformerBlock) and hasattr(m, "attn2")]
    if dual:
        raise ValueError(f"no sharding rule covers the MMDiT-X dual-attention blocks "
                         f"({', '.join(dual)}): their attn2 would run unsharded")


def param_sharding_rules(module: nn.Module, mesh) -> dict:
    """{state-dict key: ``Shard(dim)`` or ``Replicate()``} over the mesh's tp
    axis, for every parameter and buffer of ``module``; a module with MMDiT-X
    dual-attention blocks raises ``ValueError``."""
    refuse_dual_attention(module)
    tp = tp_size(mesh)
    owners = dict(module.named_modules())
    rules = {}
    for key, tensor in module.state_dict(keep_vars=True).items():
        name, _, leaf = key.rpartition(".")
        rules[key] = _placement(name, leaf, owners[name], tensor, tp)
    return rules


def shard_params(module: nn.Module, mesh, replicate=()) -> nn.Module:
    """Place ``module`` onto the mesh in place by the rules: every sharded
    ``Linear``, ``Conv2d`` or ``Embedding`` (and the UNet attentions and
    feed-forwards whose pairs divide tp) is replaced by its layer of
    ``parallel/layers.py``, which keeps this rank's shard.  ``replicate``:
    state-dict keys held replicated whatever the rules say (a pipeline's
    palettized weights, rebound at every call)."""
    from .layers import install_tensor_parallel

    rules = param_sharding_rules(module, mesh)
    rules.update((k, Replicate()) for k in replicate)
    install_tensor_parallel(module, rules, mesh)
    return module


def batch_sharding(mesh, ndim: int = 4) -> tuple:
    """The placements of an ``ndim``-dimensional batch over the (dp, tp)
    mesh: dim 0 split over dp, replicated over tp."""
    if ndim < 1:
        raise ValueError(f"a batch has a leading axis; got ndim={ndim}")
    return (Shard(0), Replicate())
