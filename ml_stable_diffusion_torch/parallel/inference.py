"""Multi-card inference sharding (port of
ml_stable_diffusion_tpu/parallel/inference.py).

- ``make_spatial_sharded_forward``: spatial (sequence) parallelism.  The
  latent H axis (NCHW dim 2) is split over the mesh's tp axis and the
  weights stay replicated; the convs exchange halo rows, the GroupNorms
  all-reduce their statistics and self attention gathers its keys and
  values (``layers.py``; GSPMD inserts the same in JAX).  The layout for
  large images, where a step's FLOPs dominate.
- ``make_tensor_sharded_forward``: megatron tensor parallelism over the
  projections (``sharding.param_sharding_rules``) with replicated
  activations: the layout for when weights and step time dominate.

Both batch over the dp axis when dp > 1 and return the full output on every
rank.  Each process runs one rank (SPMD): every rank is called with the same
full inputs, as the JAX functions take the full arrays.
"""

from __future__ import annotations

import torch

from .layers import AxisGroup, all_gather, axis_group, spatial_copy
from .sharding import shard_params


def _batch_slice(value, g: AxisGroup, batch: int):
    """This dp rank's share of every tensor in ``value`` (dicts and lists
    walked) whose leading axis is the batch."""
    if isinstance(value, dict):
        return {k: _batch_slice(v, g, batch) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_batch_slice(v, g, batch) for v in value)
    if isinstance(value, torch.Tensor) and value.ndim and value.shape[0] == batch:
        share = batch // g.size
        return value[g.rank * share:(g.rank + 1) * share]
    return value


def _over_dp(fn, dp: AxisGroup | None):
    """``fn(sample, t, context, **kw)`` on this dp rank's share of the batch,
    the shares gathered back."""
    if dp is None:
        return fn

    def batched(sample, timesteps, context, **kw):
        B = sample.shape[0]
        if B % dp.size:
            raise ValueError(f"a batch of {B} does not split over dp={dp.size}")
        args = _batch_slice([sample, timesteps, context, kw], dp, B)
        return all_gather(fn(*args[:3], **args[3]), 0, dp)

    return batched


def _dp_group(mesh, use: bool = True) -> AxisGroup | None:
    dp = axis_group(mesh, "dp")
    return dp if use and dp.size > 1 else None


def make_spatial_sharded_forward(model, mesh, dp_batch: bool = True):
    """-> ``fn(sample (B, C, H, W), timesteps, context, **kw)``: the UNet on
    this rank's H rows (and, with ``dp_batch`` and dp > 1, its share of the
    batch), the full float32 output gathered on every rank.  ``model`` stays
    as it is: the function runs a copy sharing its weights.  H must split
    into an even row count per rank at every level (a multiple of
    tp·2^(levels-1)); GSPMD would pad, this raises ``ValueError``."""
    config = getattr(model, "config", None)
    if not hasattr(config, "block_out_channels"):
        raise TypeError(f"spatial sharding runs a UNet2DConditionModel, got "
                        f"{type(model).__name__}")
    tp = axis_group(mesh, "tp")
    local = spatial_copy(model, tp)
    multiple = tp.size * 2 ** (len(config.block_out_channels) - 1)

    def fn(sample, timesteps, context, **kw):
        H = sample.shape[2]
        if H % multiple:
            raise ValueError(
                f"latents {tuple(sample.shape)}: H={H} does not split over tp={tp.size} at "
                f"{len(config.block_out_channels)} levels; it must be a multiple of {multiple}")
        h = H // tp.size
        rows = sample[:, :, tp.rank * h:(tp.rank + 1) * h]
        return all_gather(local(rows, timesteps, context, **kw), 2, tp)

    return _over_dp(fn, _dp_group(mesh, dp_batch))


def make_tensor_sharded_forward(model, mesh, state_dict=None):
    """-> (``model`` sharded in place, ``fn(sample, timesteps, context,
    **kw)``).  ``state_dict``: loaded (strictly) before the model is
    sharded.  The projections follow the megatron column/row rules over tp;
    activations are replicated, the batch split over dp when dp > 1; every
    rank returns the full output."""
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    shard_params(model, mesh)
    return model, _over_dp(model, _dp_group(mesh))
