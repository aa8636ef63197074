#!/usr/bin/env python3
"""Least device time of the TPU kernels that have no port yet, on the H100,
worked out from the shapes they would run at on the SD-2.1 512x512 path.

    python3 kernel_bounds.py

Runs on the CPU (the UNet is built on the meta device) and prints one JSON
line.  The bound of a call is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the bf16
tensor-core peak, 989 TFLOP/s (H100 SXM data sheet, as chip_smoke.py).

- GroupNorm+SiLU (``ml_stable_diffusion_tpu/ops/groupnorm.py:_gn_silu_pallas``)
  runs, with ``UNetConfig.fused_groupnorm=True``, on each resnet GroupNorm
  whose image fits its 4 MB per-image budget (``_qualifies``): the calls are
  recorded from the port's UNet at CFG batch 2 in bf16, x read once and y
  written once.
- The palettized dequant-matmul (``ops/palettized.py:_dequant_matmul``):
  y = x @ lut[idx] with bf16 x and y and one uint8 index per weight, at two
  SD-2.1 GEGLU projections.
"""

from __future__ import annotations

import json

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
#: the Pallas GroupNorm kernel's per-image budget (ops/groupnorm.py)
GN_IMAGE_BYTES = 4 * 1024 * 1024


def groupnorm_bound():
    from ml_stable_diffusion_torch.models.unet import (
        ResnetBlock2D,
        UNet2DConditionModel,
        UNetConfig,
    )

    with torch.device("meta"):
        unet = UNet2DConditionModel(UNetConfig.sd21()).to(torch.bfloat16)
    shapes = []
    for m in unet.modules():
        if isinstance(m, ResnetBlock2D):
            for gn in (m.norm1, m.norm2):
                gn.register_forward_hook(
                    lambda mod, inp, out: shapes.append(tuple(inp[0].shape)))
    with torch.device("meta"):
        unet(torch.empty(2, 4, 64, 64), torch.tensor(500.0), torch.empty(2, 77, 1024))
    fits = [s for s in shapes if s[1] * s[2] * s[3] * 2 <= GN_IMAGE_BYTES]
    nbytes = sum(2 * 2 * B * C * H * W for B, C, H, W in fits)
    return dict(calls_per_unet=len(shapes), kernel_calls_per_unet=len(fits),
                bytes_per_unet=nbytes, bound_ms_per_unet=1e3 * nbytes / PEAK_BYTES_PER_S,
                bound_by="bytes")


def palettized_bound(M, K, N):
    nbytes = M * K * 2 + K * N + M * N * 2
    flops = 2 * M * K * N
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return dict(M=M, K=K, N=N, bytes=nbytes, flops=flops, bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def main():
    print(json.dumps({
        "groupnorm_silu": groupnorm_bound(),
        # the 64x64 and 16x16 GEGLU input projections at CFG batch 2
        "dequant_matmul": [palettized_bound(2 * 4096, 320, 2560),
                           palettized_bound(2 * 256, 1280, 10240)],
    }))


if __name__ == "__main__":
    main()
