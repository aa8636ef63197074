"""K-means weight palettization (port of
ml_stable_diffusion_tpu/compress/palettize.py).

Each palettized tensor is a flat uint8 index per element and a float32 LUT
of ``2**nbits`` centroids, fitted by 1-D k-means: quantile initialisation,
then 12 Lloyd steps in float32 (sort the centroids, bucketize by their
midpoints, segment means), in torch on the tensor's own device.  A tensor of
more than ``1 << 22`` elements is fitted on a subsample, the JAX package's
``np.random.RandomState(0).choice(flat, 1 << 22, replace=False)``, which is
the first ``1 << 22`` entries of ``RandomState(0).permutation(n)``: drawn on
the host once per size and gathered on the tensor's device.

Two things differ from a Flax parameter tree and are handled here:

- **Eligibility.**  JAX palettizes the leaves named ``kernel``.  A torch
  state dict names norms and embeddings ``weight`` as well, so the port
  selects by module type: the weights of ``nn.Linear`` and ``nn.Conv2d`` of
  at least ``min_size`` elements.  Statistics count parameters only.
- **Layout.**  The subsample is drawn in the flat order of the tensor.  The
  port fits each weight in the JAX layout's order (a Linear weight (N, K)
  as the Dense kernel (K, N), a conv OIHW as HWIO), so it draws the same
  subsample and gets the same LUT as the JAX package, then permutes the
  indices to the torch layout, as ``convert/from_jax.py`` does.

A "tree" here is a flat state dict ``{key: tensor}`` whose palettized
entries are ``PalettizedTensor``s in the torch layout.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn

#: the bit widths the mixed-bit sweeps try (JAX compress/palettize.py)
NBITS = (1, 2, 4, 6, 8)
#: do not palettize tensors smaller than this
PALETTIZE_MIN_SIZE = 100_000
#: elements a LUT is fitted on at most
FIT_MAX = 1 << 22
LLOYD_STEPS = 12


@dataclasses.dataclass
class PalettizedTensor:
    indices: torch.Tensor  # uint8, flat
    lut: torch.Tensor      # float32 (2**nbits,)
    shape: tuple[int, ...]
    nbits: int

    @property
    def compressed_bytes(self) -> int:
        return math.prod(self.shape) * self.nbits // 8 + self.lut.numel() * 4

    def dequantize(self) -> torch.Tensor:
        return self.lut.float()[self.indices.long()].reshape(self.shape)

    def to(self, device) -> "PalettizedTensor":
        return dataclasses.replace(self, indices=self.indices.to(device),
                                   lut=self.lut.to(device))


def _lloyd_step(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration for 1-D k-means without the N x K distance
    matrix: sort centroids, bucketize by midpoints, segment-mean."""
    k = c.numel()
    c = torch.sort(c).values
    mid = (c[1:] + c[:-1]) / 2
    assign = torch.searchsorted(mid, x)
    sums = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(0, assign, x)
    counts = torch.bincount(assign, minlength=k).to(x.dtype)
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1), c)


def _kmeans_1d(x: torch.Tensor, k: int) -> torch.Tensor:
    """-> sorted float32 centroids (k,); quantile init (numpy's linear
    interpolation, in float64 as np.quantile computes it)."""
    qs = torch.linspace(0, 1, k, dtype=torch.float64, device=x.device)
    c = torch.quantile(x.double(), qs).float()
    for _ in range(LLOYD_STEPS):
        c = _lloyd_step(c, x)
    return torch.sort(c).values


@functools.lru_cache(maxsize=16)
def _subsample(n: int) -> torch.Tensor:
    """The positions ``RandomState(0).choice(n, FIT_MAX, replace=False)``
    draws: legacy ``choice`` without replacement is ``permutation(n)[:size]``."""
    return torch.from_numpy(np.random.RandomState(0).permutation(n)[:FIT_MAX])


def palettize_array(w, nbits: int) -> PalettizedTensor:
    """k-means palettization of ``w`` (tensor or array) in its flat order."""
    flat = torch.as_tensor(w).detach().reshape(-1).float()
    k = 2 ** nbits
    n = flat.numel()
    if n <= k:
        lut = torch.cat([flat, flat.new_zeros(k - n)])
        return PalettizedTensor(torch.arange(n, dtype=torch.uint8, device=flat.device), lut,
                                tuple(w.shape), nbits)
    fit = flat if n <= FIT_MAX else flat[_subsample(n).to(flat.device)]
    lut = _kmeans_1d(fit, k)
    mid = (lut[1:] + lut[:-1]) / 2
    assign = torch.searchsorted(mid, flat).to(torch.uint8)
    return PalettizedTensor(assign, lut, tuple(w.shape), nbits)


# -- layouts ---------------------------------------------------------------------

def jax_layout(w: torch.Tensor) -> torch.Tensor:
    """A torch weight as the JAX package holds it: Linear (N, K) -> Dense
    (K, N), conv OIHW -> HWIO; anything else as it is."""
    if w.ndim == 2:
        return w.t()
    if w.ndim == 4:
        return w.permute(2, 3, 1, 0)
    return w


def to_torch_layout(pt: PalettizedTensor) -> PalettizedTensor:
    """A tensor palettized in the JAX layout -> the same in the torch
    layout: the indices permuted as ``from_jax`` permutes a kernel, the
    shape swapped, the LUT as it is."""
    if len(pt.shape) not in (2, 4):
        return pt
    idx = pt.indices.reshape(pt.shape)
    idx = idx.t() if idx.ndim == 2 else idx.permute(3, 2, 0, 1)
    return PalettizedTensor(idx.contiguous().reshape(-1), pt.lut, tuple(idx.shape), pt.nbits)


def palettize_weight(w: torch.Tensor, nbits: int) -> PalettizedTensor:
    """A torch-layout weight palettized with the JAX package's LUT: fitted
    in the JAX layout's order, indices returned in the torch layout."""
    return to_torch_layout(palettize_array(jax_layout(w), nbits))


def eligible_weights(module: nn.Module, min_size: int = PALETTIZE_MIN_SIZE) -> list[str]:
    """State-dict keys of the ``nn.Linear`` and ``nn.Conv2d`` weights of at
    least ``min_size`` elements (the JAX ``kernel`` leaves of that size)."""
    return [f"{name}.weight" if name else "weight" for name, m in module.named_modules()
            if isinstance(m, (nn.Linear, nn.Conv2d)) and m.weight.numel() >= min_size]


def palettize_tree(module: nn.Module, nbits: int, min_size: int = PALETTIZE_MIN_SIZE):
    """Parameters of ``module`` -> (``{key: tensor or PalettizedTensor}``,
    stats)."""
    stats = {"palettized": 0, "skipped": 0, "orig_bytes": 0, "new_bytes": 0}
    chosen = set(eligible_weights(module, min_size))
    out = {}
    with torch.no_grad():
        for key, p in module.named_parameters():
            nbytes = p.numel() * 2  # fp16/bf16 storage baseline
            stats["orig_bytes"] += nbytes
            if key not in chosen:
                stats["skipped"] += 1
                stats["new_bytes"] += nbytes
                out[key] = p.detach()
                continue
            pt = palettize_weight(p.detach(), nbits)
            stats["palettized"] += 1
            stats["new_bytes"] += pt.compressed_bytes
            out[key] = pt
    return out, stats


def dequantize_tree(tree: dict) -> dict:
    """Inverse of ``palettize_tree``: dense float32 where palettized."""
    return {k: v.dequantize() if isinstance(v, PalettizedTensor) else v
            for k, v in tree.items()}


def palettize_weights(module: nn.Module, nbits: int, min_size: int = PALETTIZE_MIN_SIZE):
    """Global palettization -> (dense fake-quantized state dict, stats)."""
    tree, stats = palettize_tree(module, nbits, min_size)
    return dequantize_tree(tree), stats


# -- compressed serving -------------------------------------------------------------

def split_palettized_tree(tree: dict):
    """-> (dense rest, side ``{key: {"idx": uint8, "lut": float32}}``, meta
    ``{key: (shape, nbits)}``)."""
    dense, side, meta = {}, {}, {}
    for key, v in tree.items():
        if isinstance(v, PalettizedTensor):
            side[key] = {"idx": v.indices.to(torch.uint8), "lut": v.lut.float()}
            meta[key] = (tuple(v.shape), v.nbits)
        else:
            dense[key] = v
    return dense, side, meta


def materialize_palettized(dense: dict, side: dict, meta: dict, dtype=None) -> dict:
    """Re-insert the dequantized palettized tensors into ``dense`` (a LUT
    gather on the tensors' device), cast to ``dtype`` when given."""
    out = dict(dense)
    for key, arrs in side.items():
        shape, _ = meta[key]
        w = arrs["lut"][arrs["idx"].long()].reshape(shape)
        out[key] = w if dtype is None else w.to(dtype)
    return out
