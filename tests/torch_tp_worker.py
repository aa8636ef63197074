"""One rank of tests/test_torch_train.py's tensor-parallel checks: the port's
training step over a (dp, tp) mesh of four gloo processes that meet through
a file store, on the meshes (dp, tp) = (1, 4) and (2, 2).

    python tests/torch_tp_worker.py DIR RANK WORLD LR

``DIR`` holds ``weights.pt`` (the tiny UNet's state dict), ``config.json``
(its ``UNetConfig``), ``batch.pt`` (the global batch with its draws ``t``
and ``noise``) and ``unsharded_ckpt/`` (an unsharded AdamW state after one
step).  Every rank writes ``rank{RANK}.pt``: on each mesh the step's loss,
gathered gradients and parameters (SGD on the draws, on a generator seeded
3, with remat), two AdamW steps with this rank's replicated parameters, the
checkpoint saved into ``ckpt_{mesh}/`` and restored, the unsharded
checkpoint restored at the mesh, and each sharded layer's gradients against
unsharded autograd.
"""

import copy
import datetime
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Shard

from ml_stable_diffusion_torch.models.unet import FeedForward, UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_torch.parallel import (
    adamw,
    full_state_dict,
    make_mesh,
    make_train_step,
    restore_train_state,
    save_train_state,
    sgd,
)
from ml_stable_diffusion_torch.parallel.layers import (
    full_tensors,
    install_tensor_parallel,
    shard_layout,
)

MESHES = {"tp4": 1, "dp2tp2": 2}  # name -> dp


def grads(state) -> dict:
    return full_tensors(state.model, {k: p.grad for k, p in state.params.items()})


def moments(state) -> dict:
    """AdamW's two moments of every parameter, gathered into whole shapes."""
    return {kind: full_tensors(state.model, {k: state.optimizer.state[p][kind].clone()
                                             for k, p in state.params.items()})
            for kind in ("exp_avg", "exp_avg_sq")}


def local(state) -> dict:
    return {k: p.detach().clone() for k, p in state.params.items()}


def same(state, other) -> bool:
    """This rank's parameters of ``state`` bit-equal to ``other``'s (a state
    or a dict of them)."""
    other = other.params if hasattr(other, "params") else other
    return all(torch.equal(p, other[k]) for k, p in state.params.items())


def whole(state) -> dict:
    """``full_state_dict(state)`` apart from the live parameters (its
    replicated tensors are the parameters themselves, as ``state_dict``'s)."""
    return {k: v.clone() for k, v in full_state_dict(state).items()}


def layer_cases():
    """name -> (module, its rules, input): one sharded layer each, between
    them every differentiable collective (layers.py)."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 5, 16, generator=gen)
    cases = {
        "column": (nn.Linear(16, 8), {"m.weight": Shard(0), "m.bias": Shard(0)}, x),
        "row": (nn.Linear(16, 8), {"m.weight": Shard(1)}, x),
        "pair": (FeedForward(16), {"m.net.0.proj.weight": Shard(0),
                                   "m.net.0.proj.bias": Shard(0),
                                   "m.net.2.weight": Shard(1)}, x),
        "conv": (nn.Conv2d(4, 16, 3, padding=1), {"m.weight": Shard(0)},
                 torch.randn(2, 4, 6, 6, generator=gen)),
        "embedding": (nn.Embedding(10, 16), {"m.weight": Shard(1)},
                      torch.randint(0, 10, (2, 5), generator=gen)),
    }
    for module, _, _ in cases.values():
        for p in module.parameters():
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return cases


def layer_gradients(mesh) -> dict:
    """Each case's output, input gradient and whole parameter gradients,
    sharded and unsharded, under one upstream gradient."""
    out = {}
    for name, (module, rules, x) in layer_cases().items():
        runs = {}
        for mode in ("unsharded", "sharded"):
            root = nn.ModuleDict({"m": copy.deepcopy(module)})
            if mode == "sharded":
                install_tensor_parallel(root, rules, mesh)
            xi = x.clone().requires_grad_(x.is_floating_point())
            y = root["m"](xi)
            upstream = torch.randn(y.shape, generator=torch.Generator().manual_seed(6))
            (y * upstream).sum().backward()
            runs[mode] = {"y": y.detach(),
                          "x_grad": None if xi.grad is None else xi.grad,
                          "grads": full_tensors(root, {k: p.grad for k, p in
                                                       root.named_parameters()})}
        out[name] = runs
    return out


def main(directory: Path, rank: int, world: int, lr: float):
    torch.set_num_threads(1)  # four ranks beside the test process; the UNet is tiny
    dist.init_process_group("gloo", init_method=f"file://{directory / 'store'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        cfg = json.loads((directory / "config.json").read_text())
        cfg = UNetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()})
        model = UNet2DConditionModel(cfg)
        model.load_state_dict(torch.load(directory / "weights.pt", weights_only=True))
        batch = torch.load(directory / "batch.pt", weights_only=True)
        out = {}
        for mesh_name, dp in MESHES.items():
            mesh = make_mesh(world, dp=dp, device_type="cpu")
            share = batch["latents"].shape[0] // dp
            row = mesh.get_local_rank("dp")
            mine = {k: v[row * share:(row + 1) * share] for k, v in batch.items()}
            with_gen = {"latents": mine["latents"], "context": mine["context"]}
            res = {}
            init_fn, step_fn = make_train_step(model, sgd(lr), mesh, device="cpu")
            state = init_fn()
            res["init"] = whole(state)
            state, res["loss"] = step_fn(state, mine)
            res["grads"], res["params"] = grads(state), whole(state)
            state, res["generator_loss"] = step_fn(init_fn(), {
                **with_gen, "generator": torch.Generator().manual_seed(3)})
            res["generator_params"] = whole(state)
            plain = local(step_fn(init_fn(), mine)[0])
            init_r, step_r = make_train_step(model, sgd(lr), mesh, remat=True, device="cpu")
            state_r, res["remat_loss"] = step_r(init_r(), mine)
            res["remat_equal"] = same(state_r, plain)

            init_a, step_a = make_train_step(model, adamw(lr), mesh, device="cpu")
            sa = init_a()
            res["adamw_losses"] = [float(step_a(sa, mine)[1]) for _ in range(2)]
            shard = shard_layout(sa.model)
            res["replicated"] = {k: p.detach().clone() for k, p in sa.params.items()
                                 if k not in shard}
            ckpt = directory / f"ckpt_{mesh_name}"
            save_train_state(ckpt, sa)
            res["saved_params"], res["saved_moments"] = whole(sa), moments(sa)
            back = restore_train_state(ckpt, init_a())
            res["restored_equal"] = back.step == sa.step and same(back, sa)
            live, again = step_a(sa, mine)[1], step_a(back, mine)[1]
            res["next_step_equal"] = bool(torch.equal(live, again)) and same(back, sa)
            unsharded = restore_train_state(directory / "unsharded_ckpt", init_a())
            res["from_unsharded"] = (unsharded.step, full_state_dict(unsharded),
                                     moments(unsharded))
            res["layers"] = layer_gradients(mesh)
            out[mesh_name] = res
        if rank != 0:  # the other ranks' replicated parameters and losses only
            out = {m: {k: r[k] for k in ("replicated", "adamw_losses", "loss")}
                   for m, r in out.items()}
        torch.save(out, directory / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4]))
