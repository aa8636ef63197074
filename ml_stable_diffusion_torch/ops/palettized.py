"""Palettized (LUT-compressed) weights: the port of
``ml_stable_diffusion_tpu/ops/palettized.py``.

A palettized weight is a flat uint8 index per element and a float32 LUT of
``2**nbits`` centroids (compress/palettize.py makes them).  This module holds:

- ``pack_bits``/``unpack_bits``: the on-disk bitstream, ``nbits`` bits an
  index, little-endian within and across bytes, byte for byte the JAX
  package's (``np.packbits(..., bitorder="little")``); ``pack_4bit``/
  ``unpack_4bit``: two nibbles a byte.  They run in torch on the tensor's
  own device;
- ``palettized_dense``: the plain gather + matmul, ``x @ lut[idx]`` with the
  weight cast to x's dtype, which also takes 4-bit-packed indices;
- the fused op, the port of the Pallas kernel ``_dequant_matmul_kernel``
  (launched by ``_dequant_matmul``, wrapped by ``palettized_dense_fused``).
  Its kernel is hand-written CUDA, ``csrc/palettized_matmul.cu``, built for
  ``sm_90a`` on first use (utils/cuda_build.py) and called through ctypes;
  the source's header says what bounds it and how it is laid out.  Its
  bf16 launch plan (tile sizes and the K split) is ``launch_plan``, a pure
  function of (M, K, N) here, passed to the C entry.  Entry
  points, all with the JAX contract: ``x (..., K)``, flat unpacked uint8
  ``indices`` of the (K, N) Dense layout, ``lut (2**nbits,)``,
  ``shape=(K, N)``, an optional ``bias`` added after the product, the
  result in x's dtype before the bias and promoted by it as in JAX (bf16 x
  with an f32 bias gives f32):

  - ``palettized_dense_fused_reference``: the plain PyTorch version,
    ``(x.float() @ lut[idx].to(x.dtype).float()).to(x.dtype)`` (the LUT
    value is rounded to x's dtype before the product, as the TPU kernel's
    ``w.astype(x_ref.dtype)``; an index at or past the LUT's length reads 0,
    as the TPU kernel's select-sum and the CUDA kernel give it);
  - ``palettized_dense_fused_cuda``: the kernel wrapper.  It launches the
    kernel on CUDA tensors or raises, and counts its launches in
    ``.launches``;
  - ``palettized_dense_fused``: the dispatch.  A CPU tensor takes the plain
    version, a CUDA tensor the kernel.

No generation path calls the fused op, as in the JAX package: the pipelines
serve palettized weights dequantized (``install_palettized``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..utils import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: LUT entries the kernel holds in shared memory (8-bit indices)
MAX_LUT = 256
#: streaming multiprocessors of the H100 SXM: the grid the launch plan fills
SMS = 132
#: depth of one k tile of the bf16 kernel (csrc/palettized_matmul.cu kBK)
K_TILE = 64
#: rows of x a bf16 block may take (the wgmma N of the swapped product)
TILE_M = (32, 64, 128, 256)

_fns: dict = {}


def _as_uint8(indices) -> torch.Tensor:
    t = indices if isinstance(indices, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(indices, np.uint8)))
    return t.reshape(-1).to(torch.uint8)


def pack_bits(indices, nbits: int) -> torch.Tensor:
    """uint8 indices -> their low ``nbits`` bits as one little-endian
    bitstream, ``ceil(count * nbits / 8)`` bytes (uint8)."""
    idx = _as_uint8(indices)
    count = idx.numel()
    if nbits == 8:
        return idx.clone()
    # 8 indices make nbits whole bytes: pack each group into one int64
    groups = -(-count // 8)
    padded = torch.zeros(groups * 8, dtype=torch.int64, device=idx.device)
    padded[:count] = idx.to(torch.int64) & ((1 << nbits) - 1)
    shifts = torch.arange(8, device=idx.device) * nbits
    word = (padded.reshape(groups, 8) << shifts).sum(dim=1)
    byte_shifts = torch.arange(nbits, device=idx.device) * 8
    out = (word[:, None] >> byte_shifts) & 0xFF
    return out.reshape(-1)[: -(-count * nbits // 8)].to(torch.uint8)


def unpack_bits(packed, nbits: int, count: int) -> torch.Tensor:
    """Inverse of ``pack_bits`` -> uint8 indices (count,)."""
    data = _as_uint8(packed)
    if nbits == 8:
        return data[:count].clone()
    groups = -(-count // 8)
    padded = torch.zeros(groups * nbits, dtype=torch.int64, device=data.device)
    n = min(data.numel(), padded.numel())
    padded[:n] = data[:n].to(torch.int64)
    byte_shifts = torch.arange(nbits, device=data.device) * 8
    word = (padded.reshape(groups, nbits) << byte_shifts).sum(dim=1)
    shifts = torch.arange(8, device=data.device) * nbits
    out = (word[:, None] >> shifts) & ((1 << nbits) - 1)
    return out.reshape(-1)[:count].to(torch.uint8)


def pack_4bit(indices) -> torch.Tensor:
    """uint8 values < 16 -> packed uint8, two nibbles a byte (low first)."""
    flat = _as_uint8(indices)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    return flat[0::2] | (flat[1::2] << 4)


def unpack_4bit(packed, n: int) -> torch.Tensor:
    packed = _as_uint8(packed)
    return torch.stack([packed & 0xF, packed >> 4], dim=1).reshape(-1)[:n]


def palettized_dense(x, indices, lut, shape, bias=None):
    """x (..., K) @ lut[indices].reshape(K, N) in x's dtype.  ``indices``
    uint8 flat, or 4-bit packed when it holds fewer than K*N entries."""
    n = math.prod(shape)
    idx = indices
    if indices.numel() < n:
        idx = unpack_4bit(indices, n)
    w = lut[idx.long()].reshape(shape)
    y = x @ w.to(x.dtype)
    if bias is not None:
        y = y + bias
    return y


def _check(x, indices, lut, shape):
    K, N = shape
    if x.shape[-1] != K:
        raise ValueError(f"x's last axis {x.shape[-1]} != K = {K} of shape {tuple(shape)}")
    if indices.numel() != K * N:
        # the kernel reads one byte an index; 4-bit or bit-packed indices are
        # unpacked first (unpack_4bit, unpack_bits)
        raise ValueError(f"palettized_dense_fused takes unpacked uint8 indices, {K * N} of "
                         f"them for shape {tuple(shape)}; got {indices.numel()}")
    if lut.ndim != 1 or not 1 <= lut.numel() <= MAX_LUT:
        raise ValueError(f"lut must be 1-D with 1..{MAX_LUT} entries, got {tuple(lut.shape)}")


def _finish(y, lead, N, bias):
    y = y.reshape(*lead, N)
    if bias is not None:
        y = y + bias
    return y


def palettized_dense_fused_reference(x, indices, lut, shape, bias=None):
    """Plain PyTorch version of the fused op's function."""
    _check(x, indices, lut, shape)
    K, N = shape
    # entries past the LUT read 0: gather from the LUT padded to 256 entries
    lut256 = torch.zeros(MAX_LUT, dtype=torch.float32, device=lut.device)
    lut256[:lut.numel()] = lut.float()
    w = lut256[indices.reshape(-1).long()].reshape(K, N).to(x.dtype).float()
    y = (x.reshape(-1, K).float() @ w).to(x.dtype)
    return _finish(y, x.shape[:-1], N, bias)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the bf16 kernel covers y (M, N): blocks of ``bm`` rows of x by
    ``bn`` columns of W, K cut into ``splits`` ranges of ``tiles_per_split``
    ``K_TILE``-deep tiles (the last range may be shorter)."""

    bm: int
    bn: int
    splits: int
    tiles_per_split: int
    grid: tuple  # (n tiles, m tiles, splits)

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)

    def workspace_floats(self, M: int, N: int) -> int:
        """f32 partial sums the split-K pass needs (0 without a split)."""
        return self.splits * M * N if self.splits > 1 else 0


def launch_plan(M: int, K: int, N: int) -> LaunchPlan:
    """The bf16 kernel's plan for x (M, K) @ W (K, N).  The block takes the
    smallest row tile that covers M (at most 256) and 128 columns of W; while
    the grid holds fewer than ``SMS`` blocks it takes narrower tiles (rows
    down to 64, then 64 columns), then splits K, each split at least one
    tile deep, until the grid reaches ``SMS`` blocks or K runs out of
    tiles."""
    bm = next((t for t in TILE_M if t >= M), TILE_M[-1])
    bn = 128

    def tiles():
        return -(-N // bn) * -(-M // bm)

    while tiles() < SMS and bm > 64:
        bm //= 2
    if tiles() < SMS:
        bn = 64
    k_tiles = -(-K // K_TILE)
    tiles_per_split = k_tiles
    if tiles() < SMS:
        need = -(-SMS // tiles())
        tiles_per_split = max(1, k_tiles // need)
    splits = -(-k_tiles // tiles_per_split)
    return LaunchPlan(bm, bn, splits, tiles_per_split, (-(-N // bn), -(-M // bm), splits))


def _kernel():
    fn = _fns.get("fwd")
    if fn is None:
        fn = cuda_build.load("palettized_matmul").palettized_matmul_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["fwd"] = fn
    return fn


def palettized_dense_fused_cuda(x, indices, lut, shape, bias=None):
    """The fused op on CUDA tensors by the hand-written kernel.  Raises for
    anything the kernel does not take."""
    cuda_build.refuse_grad("palettized_dense_fused_cuda",
                           "palettized_dense (the gathered weight's matmul)", x, lut, bias)
    if x.device.type != "cuda":
        raise ValueError(f"palettized_dense_fused_cuda needs CUDA tensors; x is on {x.device}")
    _check(x, indices, lut, shape)
    K, N = shape
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"palettized_dense_fused_cuda takes float32 or bfloat16 x, got {x.dtype}")
    if indices.dtype != torch.uint8:
        raise ValueError(f"indices must be uint8, got {indices.dtype}")
    for name, t in (("indices", indices), ("lut", lut)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if M == 0:
        raise ValueError("palettized_dense_fused_cuda needs a non-empty x")
    idx = indices.reshape(-1).contiguous()
    lut32 = lut.to(torch.float32).contiguous()
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    plan = launch_plan(M, K, N)
    ws_floats = plan.workspace_floats(M, N) if x.dtype == torch.bfloat16 else 0
    ws = torch.empty(ws_floats, dtype=torch.float32, device=x.device) if ws_floats else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernel()(x2.data_ptr(), idx.data_ptr(), lut32.data_ptr(), y.data_ptr(),
                       None if ws is None else ws.data_ptr(), M, K, N, lut32.numel(),
                       _DTYPE_CODES[x.dtype], plan.bm, plan.bn, plan.splits,
                       plan.tiles_per_split, stream)
    if rc != 0:
        raise RuntimeError(f"palettized matmul kernel launch failed with CUDA error {rc} at "
                           f"x {tuple(x2.shape)} {x.dtype}, shape {(K, N)}")
    palettized_dense_fused_cuda.launches += 1
    return _finish(y, lead, N, bias)


palettized_dense_fused_cuda.launches = 0


def palettized_dense_fused(x, indices, lut, shape, bias=None):
    """Fused dequant-matmul ``x (..., K) @ lut[indices].reshape(K, N)``
    (+ bias): the kernel on a CUDA tensor, its plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return palettized_dense_fused_reference(x, indices, lut, shape, bias)
    return palettized_dense_fused_cuda(x, indices, lut, shape, bias)
