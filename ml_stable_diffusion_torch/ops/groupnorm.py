"""GroupNorm(+SiLU) on the H100: the port of the Pallas kernel
``ml_stable_diffusion_tpu/ops/groupnorm.py:_gn_silu_kernel`` (launched by
``_gn_silu_pallas``) and of the XLA formulation ``group_norm_silu_lowmem``.

The port's activations are NCHW, so one group of one image is a single
contiguous run of (C/G)·H·W elements.  The function of the Pallas kernel:

- x in float32; per (image, group) the float32 sum and sum of squares;
- ``var = E[x²] − E[x]²`` with no clamp, as the kernel computes it;
- ``(x − mean)·rsqrt(var + eps)·γ + β`` with γ and β widened to float32;
- an optional SiLU, ``y·sigmoid(y)``;
- the result cast back to x's dtype.

The kernel is hand-written CUDA, ``csrc/groupnorm_silu.cu``, built for
``sm_90a`` on first use (utils/cuda_build.py) and called through ctypes; its
header says what bounds it and how it is laid out.  Its launch plan (blocks a
group, and whether a block's slice of x stays in shared memory between the
two passes) is ``launch_plan``, a pure function of the shape here, passed to
the C entry.  Entry points:

- ``group_norm_silu_reference``: the plain PyTorch version of the kernel's
  function, which the tests and ``chip_smoke.py`` hold the kernel against;
- ``group_norm_silu_cuda``: the kernel wrapper.  It launches the kernel on
  CUDA tensors or raises, and counts its launches in ``.launches``;
- ``group_norm_silu``: the dispatch.  A CPU tensor takes the plain version,
  a CUDA tensor the kernel.  Unlike the JAX ``_qualifies``, which sends a
  call to the Pallas kernel only on a TPU, only for H·W % 8 == 0 and only
  when one image fits 4 MB of VMEM, the card's kernel takes every call with
  C % groups == 0: the JAX fallback computes the same function;
- ``group_norm_silu_lowmem``: plain PyTorch, as its JAX counterpart is plain
  XLA (statistics reduced from the compute dtype, folded into a per-(B, C)
  affine).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from ..utils import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: streaming multiprocessors of the H100 SXM
SMS = 132
#: shared memory of one SM (228 KB), and what each block takes beside its
#: slice (the 1 KB the system reserves a block, the kernel's static arrays)
SMEM_PER_SM = 233472
BLOCK_SMEM_OVERHEAD = 1280
#: blocks of the kernel an SM holds by registers and threads (kMinBlocks)
BLOCKS_PER_SM = 5
#: the largest slice a block keeps in shared memory (kMaxSliceBytes)
MAX_SLICE_BYTES = 224 * 1024

_fns: dict = {}


@dataclasses.dataclass(frozen=True)
class GroupNormPlan:
    """How the kernel covers a call: ``cluster`` blocks a (image, group),
    each holding a slice of at most ``slice_bytes`` of the group's run in
    shared memory (``resident``), or streaming it twice from device memory."""
    cluster: int
    resident: bool
    slice_bytes: int  # the largest block slice: whole 16-byte vectors
    blocks: int
    waves: int        # ceil(blocks / the blocks the card holds at once)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory a block takes."""
        return self.slice_bytes if self.resident else 0


def launch_plan(B: int, C: int, groups: int, hw: int, dtype) -> GroupNormPlan:
    """Clusters of 8 or 16 blocks a group, whichever needs fewer waves of
    resident blocks (16 on a tie: smaller slices pack the card better),
    among those whose slice fits ``MAX_SLICE_BYTES``; the streaming plan
    (clusters of 8) when neither fits.  A slice is the block's share of the
    group's whole 16-byte vectors (``slice_bytes`` in the source); an SM
    holds ``BLOCKS_PER_SM`` blocks, fewer when their slices fill its shared
    memory."""
    n = C // groups * hw
    vectors = n * torch.tensor([], dtype=dtype).element_size() // 16
    plans = []
    for cluster in (16, 8):
        slice_bytes = -(-vectors // cluster) * 16
        blocks = B * groups * cluster
        per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (slice_bytes + BLOCK_SMEM_OVERHEAD))
        if slice_bytes <= MAX_SLICE_BYTES and per_sm:
            plans.append(GroupNormPlan(cluster, True, slice_bytes, blocks,
                                       -(-blocks // (SMS * per_sm))))
    if plans:
        return min(plans, key=lambda p: p.waves)
    blocks = B * groups * 8
    return GroupNormPlan(8, False, -(-vectors // 8) * 16, blocks,
                         -(-blocks // (SMS * BLOCKS_PER_SM)))


def _check_groups(x, groups: int):
    if x.ndim != 4:
        raise ValueError(f"group norm takes (B, C, H, W), got {tuple(x.shape)}")
    if x.shape[1] % groups:
        raise ValueError(f"{x.shape[1]} channels do not split into {groups} groups")


def group_norm_silu_reference(x, gamma, beta, groups: int = 32, eps: float = 1e-5,
                              apply_silu: bool = True):
    """Plain PyTorch version of the kernel's function over NCHW ``x``."""
    _check_groups(x, groups)
    B, C, H, W = x.shape
    xf = x.float().reshape(B, groups, -1)
    n = xf.shape[-1]
    mean = xf.sum(-1, keepdim=True) / n
    var = (xf * xf).sum(-1, keepdim=True) / n - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, C, H, W)
    y = y * gamma.float()[:, None, None] + beta.float()[:, None, None]
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_silu_lowmem(x, gamma, beta, groups: int = 32, eps: float = 1e-5,
                           apply_silu: bool = True):
    """GroupNorm(+SiLU) with the mean and the mean of squares reduced from
    x's own dtype into float32 accumulators, var clamped at 0, and
    everything folded into a per-(B, C) affine ``x·a + b`` (+SiLU)."""
    _check_groups(x, groups)
    B, C, H, W = x.shape
    cg = C // groups
    xg = x.reshape(B, groups, cg, H * W)
    mean = torch.mean(xg, dim=(2, 3), dtype=torch.float32)              # (B, G)
    mean2 = torch.mean(xg * xg, dim=(2, 3), dtype=torch.float32)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    a = inv.repeat_interleave(cg, dim=1) * gamma.float()                 # (B, C)
    b = beta.float() - mean.repeat_interleave(cg, dim=1) * a
    y = x.float() * a[:, :, None, None] + b[:, :, None, None]
    if apply_silu:
        y = F.silu(y)
    return y.to(x.dtype)


def _kernel():
    fn = _fns.get("fwd")
    if fn is None:
        fn = cuda_build.load("groupnorm_silu").group_norm_silu_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
                       + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns["fwd"] = fn
    return fn


def group_norm_silu_cuda(x, gamma, beta, groups: int = 32, eps: float = 1e-5,
                         apply_silu: bool = True):
    """GroupNorm(+SiLU) of a contiguous NCHW CUDA tensor by the hand-written
    kernel.  Raises for anything the kernel does not take."""
    cuda_build.refuse_grad("group_norm_silu_cuda", "the plain path (a UNet built with "
                           "fused_groupnorm=False, or group_norm_silu_reference)", x, gamma, beta)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu_cuda needs CUDA tensors; x is on {x.device}")
    _check_groups(x, groups)
    B, C, H, W = x.shape
    if not x.is_contiguous():
        # a channels-last tensor would silently give the wrong groups
        raise ValueError("group_norm_silu_cuda takes contiguous NCHW x, got strides "
                         f"{x.stride()} for shape {tuple(x.shape)}")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.device != x.device or p.shape != (C,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({C},) tensor on {x.device}, "
                             f"got {tuple(p.shape)} on {p.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"group_norm_silu_cuda takes float32 or bfloat16 x, got {x.dtype}")
    if gamma.dtype not in _DTYPE_CODES or beta.dtype != gamma.dtype:
        raise ValueError(f"gamma and beta must be float32 or bfloat16 of one dtype, got "
                         f"{gamma.dtype} and {beta.dtype}")
    if x.numel() == 0:
        raise ValueError("group_norm_silu_cuda needs a non-empty x")
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel's 16-byte loads need an aligned base
    y = torch.empty_like(x)
    plan = launch_plan(B, C, groups, H * W, x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                       B, C, groups, _DTYPE_CODES[x.dtype], _DTYPE_CODES[gamma.dtype],
                       H * W, eps, int(apply_silu), plan.cluster, int(plan.resident), stream)
    if rc != 0:
        raise RuntimeError(f"group norm kernel launch failed with CUDA error {rc} at "
                           f"x {tuple(x.shape)} {x.dtype}")
    group_norm_silu_cuda.launches += 1
    return y


group_norm_silu_cuda.launches = 0


def group_norm_silu(x, gamma, beta, groups: int = 32, eps: float = 1e-5,
                    apply_silu: bool = True):
    """Fused GroupNorm(+SiLU) over NCHW ``x``: the kernel on a CUDA tensor,
    its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, gamma, beta, groups, eps, apply_silu)
    return group_norm_silu_cuda(x, gamma, beta, groups, eps, apply_silu)
