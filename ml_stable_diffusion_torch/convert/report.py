"""Conversion-fidelity metrics (port of ml_stable_diffusion_tpu/convert/report.py)."""

from __future__ import annotations

import numpy as np
import torch

#: minimum acceptable parity between a converted model and its reference, in dB
ABSOLUTE_MIN_PSNR = 35.0


def _float64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, dtype=np.float64).ravel()


def compute_psnr(a, b) -> float:
    """PSNR in dB between two tensors or arrays, in float64 on the host."""
    a, b = _float64(a), _float64(b)
    max_ab = max(np.abs(a).max(), np.abs(b).max(), 1e-10)
    mse = np.mean((a - b) ** 2)
    return float(20 * np.log10(max_ab / (np.sqrt(mse) + 1e-10)))
