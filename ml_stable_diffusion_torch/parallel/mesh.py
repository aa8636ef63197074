"""The device mesh (port of ml_stable_diffusion_tpu/parallel/mesh.py).

The JAX package builds a ``jax.sharding.Mesh`` over the chips one
controller drives.  The port runs one process per card (SPMD): the caller,
or ``torchrun``, initialises ``torch.distributed`` in every process, and
every rank builds the same (dp, tp) ``DeviceMesh`` over the ranks of the
default group.  Data parallel is over the batch ("dp"), tensor or spatial
parallel over hidden, head or image-row dims ("tp"); tp is the default axis,
as diffusion inference is small-batch and latency-bound.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(n_devices: int | None = None, dp: int | None = None, tp: int | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A (dp, tp) mesh with ``mesh_dim_names=("dp", "tp")`` over the first
    ``n_devices`` ranks of the default group (all of them by default).
    Defaults as JAX's: dp=1, tp=n (pure tensor parallel).  Uses the default
    group as it is (NCCL, or gloo on CUDA tensors); the sub-groups of the
    two axes are made from it.  Tests pass ``device_type="cpu"`` over gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised in every process "
                           "(torchrun, or dist.init_process_group with a rank and world size)")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if dp is None and tp is None:
        dp, tp = 1, n_devices
    elif dp is None:
        dp = n_devices // tp
    elif tp is None:
        tp = n_devices // dp
    if dp * tp != n_devices:
        raise ValueError(f"dp({dp}) * tp({tp}) != n_devices({n_devices})")
    if world < n_devices:
        raise ValueError(
            f"make_mesh needs {n_devices} ranks but the process group holds {world}: run one "
            f"process per card (torchrun --nproc-per-node {n_devices})")
    return DeviceMesh(device_type, torch.arange(n_devices).reshape(dp, tp),
                      mesh_dim_names=("dp", "tp"))
