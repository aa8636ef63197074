"""The diffusion training step: DDPM epsilon-prediction MSE (port of
ml_stable_diffusion_tpu/parallel/train.py).

The JAX step is one jitted program over a (dp, tp) mesh whose state is
donated.  The port runs the step eagerly on one device and updates the state
in place: float32 parameters, as the JAX step's optax leaves are, and a
``torch.optim`` optimizer (``sgd`` and ``adamw`` give optax's).  With a
``torch.distributed`` process group each rank takes its share of the global
batch and the gradients are averaged over the group before the update: the
mesh's ``dp`` axis.  Its ``tp`` axis (tensor parallelism) is not ported.

The step runs the plain attention and plain GroupNorm paths.  The
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
from ..schedulers.base import SchedulerConfig


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
    parameters are the JAX state's ``params``; ``optimizer``: over them, its
    ``state_dict()`` the JAX ``opt_state``; ``step``: updates applied."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


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
def _plain_attention():
    before = attention.ATTENTION_IMPLEMENTATION_IN_EFFECT
    attention.set_attention_implementation(attention.AttentionImpl.PLAIN)
    try:
        yield
    finally:
        attention.set_attention_implementation(before)


def make_train_step(model: nn.Module, optimizer: Callable, scheduler_config=None,
                    added_cond_fn: Callable | None = None, remat: bool = False,
                    process_group=None, device: str | torch.device = "cuda"):
    """-> (init_fn, step_fn).

    ``model``: a port denoiser built with ``fused_groupnorm=False``;
    ``optimizer``: parameters -> ``torch.optim.Optimizer`` (``sgd``,
    ``adamw``); ``added_cond_fn(B)``: SDXL's ``added_cond`` for a batch of
    B; ``process_group``: average the gradients over its ranks, each
    holding an equal share of the batch.

    ``init_fn(state_dict=None)`` -> a ``TrainState`` on ``device``: a
    float32 copy of ``model`` (``state_dict``, when given, loaded into it
    strictly), a new optimizer over it, step 0.

    ``step_fn(state, batch)`` -> (state, loss) updates ``state`` in place.
    ``batch``: ``latents`` (B, C, H, W) clean latents, ``context`` (B, S,
    C_ctx), and either ``generator``, a ``torch.Generator`` on ``device``
    that draws ``t ~ U{0..T-1}`` then ``noise ~ N(0, 1)`` for the global
    batch (each rank seeds it alike and takes its share), or the draws
    themselves, ``t`` and ``noise`` for this rank's share.  The loss is the
    global batch's mean.
    """
    if getattr(getattr(model, "config", None), "fused_groupnorm", False):
        raise ValueError("the training step runs the plain GroupNorm path: build the model "
                         "with fused_groupnorm=False (the CUDA kernel has no backward)")
    cfg = scheduler_config or SchedulerConfig()
    device = torch.device(device)
    acp = torch.as_tensor(cfg.alphas_cumprod(), dtype=torch.float32, device=device)
    rank, world = ((0, 1) if process_group is None
                   else (dist.get_rank(process_group), dist.get_world_size(process_group)))

    def init_fn(state_dict=None) -> TrainState:
        own = copy.deepcopy(model).to(device=device, dtype=torch.float32)
        if state_dict is not None:
            own.load_state_dict(state_dict, strict=True)
        own.requires_grad_(True)
        return TrainState(own, optimizer(own.parameters()))

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
        with torch.enable_grad(), _plain_attention():
            loss = epsilon_mse(state.model, latents, context, t, noise, acp, added, remat)
            loss.backward()
        loss = loss.detach()
        if process_group is not None:
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
