"""Save and resume a training state (port of
ml_stable_diffusion_tpu/parallel/checkpoint.py, which uses orbax).

A state is three torch files in one directory: the parameters
(``params.pt``), the optimizer's ``state_dict`` (``opt_state.pt``) and the
step (``step.pt``).  They hold the global arrays, as orbax's do: a state
sharded over a mesh's tp axis is gathered into the unsharded shapes, its
parameters and every optimizer moment of a sharded parameter (AdamW's
``exp_avg`` and ``exp_avg_sq``), and rank 0 of the mesh writes them while
the other ranks wait.  A restore keeps each rank's shard of the template's
layers, so a state saved at one tp restores at another, or unsharded.
The files load with ``weights_only=True``: tensors and plain containers,
no pickled code.
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.distributed as dist

from .layers import axis_group, full_tensors, take_shards
from .train import TrainState, full_state_dict


def _param_keys(state: TrainState) -> list[str]:
    """The state-dict key of each of the optimizer's parameters, in the
    order its ``state_dict()`` numbers them."""
    names = {id(p): k for k, p in state.model.named_parameters()}
    return [names[id(p)] for group in state.optimizer.param_groups for p in group["params"]]


def _map_moments(state: TrainState, opt: dict, fn) -> dict:
    """``opt`` (an optimizer ``state_dict``) with each kind of per-parameter
    tensor (AdamW's ``exp_avg``, ``exp_avg_sq``; not the scalar step)
    passed, keyed by its parameter, through ``fn`` (``full_tensors`` or
    ``take_shards`` of the model), the kinds in one order on every rank."""
    keys = _param_keys(state)
    out = {i: dict(entry) for i, entry in opt["state"].items()}
    kinds = sorted({name for entry in out.values() for name, x in entry.items()
                    if isinstance(x, torch.Tensor) and x.ndim})
    for name in kinds:
        owner = {keys[i]: i for i, entry in out.items() if name in entry}
        mapped = fn(state.model, {k: out[i][name] for k, i in owner.items()})
        for k, i in owner.items():
            out[i][name] = mapped[k]
    return {"state": out, "param_groups": opt["param_groups"]}


def save_train_state(directory: str | Path, state: TrainState):
    """Write ``state``'s global arrays into ``directory``.  Under a mesh every
    rank calls it; the tp ranks of dp row 0 gather, rank 0 writes and the
    others wait for it."""
    d = Path(directory)
    mesh = state.mesh
    dp = tp = None
    if mesh is not None:
        dp, tp = axis_group(mesh, "dp"), axis_group(mesh, "tp")
    if dp is None or dp.rank == 0:
        params = full_state_dict(state)
        opt = _map_moments(state, state.optimizer.state_dict(), full_tensors)
        if tp is None or tp.rank == 0:
            d.mkdir(parents=True, exist_ok=True)
            torch.save(params, d / "params.pt")
            torch.save(opt, d / "opt_state.pt")
            torch.save(torch.tensor(state.step), d / "step.pt")
    if mesh is not None:
        # rank (0, 0) writes before it meets its tp row; every dp column
        # holds a rank of that row
        dist.barrier(group=tp.group)
        dist.barrier(group=dp.group)


def restore_train_state(directory: str | Path, template: TrainState) -> TrainState:
    """Load a saved state into ``template`` (from an ``init_fn`` at any tp)
    and return it: each rank keeps its shard of every sharded parameter and
    moment, the parameters on the template's device, the optimizer's
    moments read from the mapped file into its parameters' devices by
    ``load_state_dict`` and its step counters kept on the host, as a live
    optimizer keeps them."""
    d = Path(directory)
    device = next(template.model.parameters()).device
    params = torch.load(d / "params.pt", map_location=device, weights_only=True)
    template.model.load_state_dict(take_shards(template.model, params), strict=True)
    opt = torch.load(d / "opt_state.pt", map_location="cpu", weights_only=True, mmap=True)
    template.optimizer.load_state_dict(_map_moments(template, opt, take_shards))
    template.step = int(torch.load(d / "step.pt", weights_only=True))
    return template
