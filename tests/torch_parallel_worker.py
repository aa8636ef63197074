"""One rank of tests/test_torch_parallel.py: the port's tensor and spatial
parallelism in four gloo processes that meet through a file store.

    python tests/torch_parallel_worker.py DIR RANK WORLD

``DIR/inputs.pt`` (written by the test process) holds the tiny modules, the
inputs and the pipelines with their generation settings.  Every rank runs
every mode on two meshes, (dp, tp) = (1, 4) and (2, 2), and writes its
results to ``DIR/rank{RANK}.pt``; rank 0 adds the sharding rules of every
module at tp = 4.
"""

import copy
import datetime
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from ml_stable_diffusion_torch.parallel import (
    make_mesh,
    make_spatial_sharded_forward,
    make_tensor_sharded_forward,
    param_sharding_rules,
    shard_params,
)
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration


def _with_gn(unet, mode: str):
    """A copy of ``unet`` whose resnets run GroupNorm+SiLU in ``mode``."""
    unet = copy.deepcopy(unet)
    for m in unet.modules():
        if hasattr(m, "gn"):
            m.gn = mode
    return unet


def main(directory: Path, rank: int, world: int):
    torch.set_num_threads(1)  # four ranks beside the test process; the models are tiny
    dist.init_process_group("gloo", init_method=f"file://{directory / 'store'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        data = torch.load(directory / "inputs.pt", weights_only=False)
        meshes = {"tp4": make_mesh(device_type="cpu"),
                  "dp2tp2": make_mesh(world, dp=2, device_type="cpu")}
        out = {"mesh_calls": []}
        for n, dp, tp in data["mesh_calls"]:
            try:
                mesh = make_mesh(n, dp=dp, tp=tp, device_type="cpu")
                out["mesh_calls"].append(dict(zip(mesh.mesh_dim_names, mesh.shape)))
            except ValueError:
                out["mesh_calls"].append("ValueError")
        if rank == 0:
            out["rules"] = {name: {k: repr(p) for k, p in
                                   param_sharding_rules(m, meshes["tp4"]).items()}
                            for name, m in data["rules"].items()}
        unet, x, t, ctx = data["unet"], data["x"], data["t"], data["ctx"]
        with torch.no_grad():
            for mesh_name, mesh in meshes.items():
                sharded, fn = make_tensor_sharded_forward(copy.deepcopy(unet), mesh)
                out[f"tensor_{mesh_name}"] = fn(x, t, ctx)
                if rank == 0:
                    out[f"sharded_rules_{mesh_name}"] = {
                        k: repr(p) for k, p in param_sharding_rules(sharded, mesh).items()}
                for gn in ("plain", "lowmem", "fused"):
                    fn = make_spatial_sharded_forward(_with_gn(unet, gn), mesh)
                    out[f"spatial_{gn}_{mesh_name}"] = fn(x, t, ctx)
            try:
                make_spatial_sharded_forward(unet, meshes["tp4"])(x[:, :, :12], t, ctx)
            except ValueError as e:
                out["uneven_rows"] = str(e)
            t5 = shard_params(copy.deepcopy(data["t5"]), meshes["tp4"])
            out["t5"] = t5(data["t5_ids"], data["t5_mask"])["encoder_hidden_states"]
        for name, (pipe, mesh_name, kw) in data["pipes"].items():
            pipe.shard(meshes[mesh_name])
            out[f"pipe_{name}"] = pipe.generate_images(PipelineConfiguration(**kw),
                                                       image_hw=data["hw"]).latents
        torch.save(out, directory / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
