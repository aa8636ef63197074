"""The diffusion training step: DDPM epsilon-prediction MSE (port of
ml_stable_diffusion_tpu/parallel/train.py).

The JAX step is one jitted program over a (dp, tp) mesh whose state is
donated.  The port runs the step eagerly, one process a card, and updates
the state in place: float32 parameters, as the JAX step's optax leaves are,
and a ``torch.optim`` optimizer (``sgd`` and ``adamw`` give optax's).

Over a ``mesh`` (``make_mesh``) the state's model is sharded over tp by the
rules that inference uses (``sharding.shard_params``), each rank holding its
shards and the replicated rest, and each rank takes its dp share of the
global batch, replicated over tp.  As under GSPMD, activations and the loss
are replicated over tp: the sharded layers' collectives carry the backward
(``layers.py``), every tp rank gets the same gradient of a replicated
parameter, and the gradients and the loss are averaged over dp only.
``process_group`` is the dp-only form of the same step (no tp axis).
``full_state_dict`` gives the whole parameters back under the unsharded
keys, as the checkpoint (``checkpoint.py``) stores them.

The step runs the plain attention, GEGLU and GroupNorm paths.  The
hand-written kernels have no backward and their wrappers raise under grad,
as the JAX package's Pallas kernels cannot be differentiated either.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
from typing import Callable

import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch import nn

from ..ops import attention
from ..ops.activations import plain_geglu
from ..schedulers.base import SchedulerConfig
from .layers import axis_group, full_tensors
from .sharding import shard_params


def sgd(learning_rate: float):
    """``optax.sgd(learning_rate)``: plain SGD, no momentum."""
    return functools.partial(torch.optim.SGD, lr=learning_rate)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4):
    """``optax.adamw`` with optax's defaults passed explicitly: torch's AdamW
    defaults ``weight_decay`` to 1e-2, optax's to 1e-4.  Both put ``eps``
    outside the square root and decay the weights decoupled from the
    moments: p -= lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p)."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    """``model``: the state's own float32 copy of the denoiser, whose
    parameters are the JAX state's ``params`` (this rank's shards under a
    mesh); ``optimizer``: over them, its ``state_dict()`` the JAX
    ``opt_state``; ``step``: updates applied; ``mesh``: the (dp, tp) mesh
    the model is sharded over, or None."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    mesh: object = None

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def full_state_dict(state: TrainState) -> dict[str, torch.Tensor]:
    """The model's whole state dict under the unsharded keys: each sharded
    tensor gathered over tp (every rank of the mesh calls it) and put in
    its global row order by the layer that holds it; the replicated ones
    are the live tensors, as ``state_dict()`` gives them."""
    return full_tensors(state.model, state.model.state_dict())


def epsilon_mse(model, latents, context, t, noise, alphas_cumprod, added_cond=None,
                remat: bool = False):
    """The loss of JAX ``train.py:60-75`` on given draws: ``t`` (B,) integer
    timesteps and ``noise`` like ``latents`` (B, C, H, W).  ``remat``: the
    denoiser's forward runs again in the backward pass
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` with
    ``nothing_saveable`` wraps the whole apply)."""
    a = alphas_cumprod[t][:, None, None, None]
    noisy = a.sqrt() * latents + (1 - a).sqrt() * noise
    kwargs = {} if added_cond is None else {"added_cond": added_cond}
    if remat:
        pred = torch.utils.checkpoint.checkpoint(model, noisy, t.float(), context,
                                                 use_reentrant=False, **kwargs)
    else:
        pred = model(noisy, t.float(), context, **kwargs)
    return torch.mean((pred - noise) ** 2)


@contextlib.contextmanager
def _plain_kernels():
    """The step's plain paths: attention forced to ``PLAIN`` and the GEGLU
    gate on its chain (``plain_geglu``); the GroupNorm's is the model's
    ``fused_groupnorm=False``."""
    before = attention.ATTENTION_IMPLEMENTATION_IN_EFFECT
    attention.set_attention_implementation(attention.AttentionImpl.PLAIN)
    try:
        with plain_geglu():
            yield
    finally:
        attention.set_attention_implementation(before)


def make_train_step(model: nn.Module, optimizer: Callable, mesh=None, scheduler_config=None,
                    added_cond_fn: Callable | None = None, remat: bool = False,
                    process_group=None, device: str | torch.device = "cuda"):
    """-> (init_fn, step_fn).

    ``model``: a port denoiser built with ``fused_groupnorm=False``;
    ``optimizer``: parameters -> ``torch.optim.Optimizer`` (``sgd``,
    ``adamw``); ``mesh``: a (dp, tp) ``make_mesh``: the model sharded over
    tp, the batch split and the gradients averaged over dp;
    ``added_cond_fn(B)``: SDXL's ``added_cond`` for a batch of B;
    ``process_group`` (no mesh): average the gradients over its ranks, each
    holding an equal share of the batch.

    ``init_fn(state_dict=None)`` -> a ``TrainState`` on ``device``: a
    float32 copy of ``model`` (``state_dict``, the whole unsharded one, when
    given, loaded into it strictly), sharded over the mesh's tp axis, a new
    optimizer over its (local) parameters, step 0.

    ``step_fn(state, batch)`` -> (state, loss) updates ``state`` in place.
    ``batch``: this rank's dp share, the same on every tp rank:
    ``latents`` (B, C, H, W) clean latents, ``context`` (B, S, C_ctx), and
    either ``generator``, a ``torch.Generator`` on ``device`` that draws
    ``t ~ U{0..T-1}`` then ``noise ~ N(0, 1)`` for the global batch (each
    rank seeds it alike and takes its dp share), or the draws themselves,
    ``t`` and ``noise`` for this rank's share.  The loss is the global
    batch's mean.
    """
    if getattr(getattr(model, "config", None), "fused_groupnorm", False):
        raise ValueError("the training step runs the plain GroupNorm path: build the model "
                         "with fused_groupnorm=False (the CUDA kernel has no backward)")
    if mesh is not None and process_group is not None:
        raise ValueError("give the step a mesh or a process group, not both: the mesh's dp "
                         "axis is its process group")
    cfg = scheduler_config or SchedulerConfig()
    device = torch.device(device)
    acp = torch.as_tensor(cfg.alphas_cumprod(), dtype=torch.float32, device=device)
    if mesh is not None:
        dp = axis_group(mesh, "dp")
        rank, world, process_group = dp.rank, dp.size, dp.group
    else:
        rank, world = ((0, 1) if process_group is None
                       else (dist.get_rank(process_group), dist.get_world_size(process_group)))

    def init_fn(state_dict=None) -> TrainState:
        own = copy.deepcopy(model).to(device=device, dtype=torch.float32)
        if state_dict is not None:
            own.load_state_dict(state_dict, strict=True)
        if mesh is not None:
            shard_params(own, mesh)
        own.requires_grad_(True)
        return TrainState(own, optimizer(own.parameters()), mesh=mesh)

    def step_fn(state: TrainState, batch: dict):
        latents = batch["latents"].to(device, torch.float32)
        context = batch["context"].to(device, torch.float32)
        B = latents.shape[0]
        if "generator" in batch:
            gen = batch["generator"]
            t = torch.randint(0, cfg.num_train_timesteps, (B * world,), generator=gen,
                              device=device)
            noise = torch.randn((B * world, *latents.shape[1:]), generator=gen, device=device)
            t, noise = t[rank * B:(rank + 1) * B], noise[rank * B:(rank + 1) * B]
        else:
            t, noise = batch["t"].to(device), batch["noise"].to(device, torch.float32)
        added = None if added_cond_fn is None else added_cond_fn(B)
        state.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad(), _plain_kernels():
            loss = epsilon_mse(state.model, latents, context, t, noise, acp, added, remat)
            loss.backward()
        loss = loss.detach()
        if world > 1:
            grads = [p.grad for p in state.model.parameters() if p.grad is not None]
            works = [dist.all_reduce(x, group=process_group, async_op=True)
                     for x in grads + [loss]]
            for w in works:
                w.wait()
            for x in grads + [loss]:
                x.div_(world)
        state.optimizer.step()
        state.step += 1
        return state, loss

    return init_fn, step_fn
