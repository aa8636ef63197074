"""One rank of tests/test_torch_train.py's data-parallel check: the port's
training step on half of a batch, gradients averaged over two gloo
processes that meet through a file store.

    python tests/torch_dp_worker.py DIR RANK WORLD LR

``DIR`` holds ``weights.pt`` (the UNet's state dict), ``config.json`` (its
``UNetConfig``) and ``batch.pt`` (the global batch with its draws ``t`` and
``noise``).  Rank 0 writes ``draws_rank0.pt`` (one SGD step on those draws)
and ``generator_rank0.pt`` (one on draws from a generator seeded 3), each
``{"loss", "params"}``.
"""

import datetime
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_torch.parallel import make_train_step, sgd


def main(directory: Path, rank: int, world: int, lr: float):
    torch.set_num_threads(1)  # two ranks beside the test process; the UNet is tiny
    dist.init_process_group("gloo", init_method=f"file://{directory / 'store'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        cfg = json.loads((directory / "config.json").read_text())
        cfg = UNetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()})
        model = UNet2DConditionModel(cfg)
        model.load_state_dict(torch.load(directory / "weights.pt", weights_only=True))
        batch = torch.load(directory / "batch.pt", weights_only=True)
        share = batch["latents"].shape[0] // world
        mine = {k: v[rank * share:(rank + 1) * share] for k, v in batch.items()}
        init_fn, step_fn = make_train_step(model, sgd(lr), process_group=dist.group.WORLD,
                                           device="cpu")
        runs = {"draws": mine,
                "generator": {"latents": mine["latents"], "context": mine["context"],
                              "generator": torch.Generator().manual_seed(3)}}
        for mode, b in runs.items():
            state, loss = step_fn(init_fn(), b)
            if rank == 0:
                torch.save({"loss": loss,
                            "params": {k: p.detach() for k, p in state.params.items()}},
                           directory / f"{mode}_rank0.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4]))
