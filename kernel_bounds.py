#!/usr/bin/env python3
"""Least device time of the TPU kernels' work on the H100, worked out from
the shapes the port's main paths give them.

    python3 kernel_bounds.py

Runs on the CPU (the UNets are built on the meta device) and prints one JSON
line.  The bound of a call is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the card's
peak for their type (H100 SXM data sheet, as chip_smoke.py).

- GroupNorm+SiLU (``ml_stable_diffusion_tpu/ops/groupnorm.py:_gn_silu_pallas``,
  ported as ``csrc/groupnorm_silu.cu``): every resnet GroupNorm+SiLU call of
  the SDXL base and refiner UNets at 1024x1024 (128x128 latents), CFG batch
  2, bf16, recorded from the port's UNets, per shape; x and y once, gamma
  and beta once.  The card's kernel takes every call.  Beside it, the SD-2.1
  512x512 figure of earlier records: only the calls whose image fits the TPU
  kernel's 4 MB per-image budget (``_qualifies``), the subset the Pallas
  kernel would have taken.
- The palettized dequant-matmul (``ops/palettized.py:_dequant_matmul``):
  y = x @ lut[idx] with bf16 x and y and one uint8 index per weight, at two
  SD-2.1 GEGLU projections.
"""

from __future__ import annotations

import collections
import dataclasses
import json

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
#: the Pallas GroupNorm kernel's per-image budget (ops/groupnorm.py)
GN_IMAGE_BYTES = 4 * 1024 * 1024
#: SDXL steps of each UNet per generation: base alone, and base + refiner at
#: refiner_start 0.8
SDXL_STEPS = {"sdxl": (20, 0), "sdxl_refiner": (16, 4)}


def gn_calls(cfg, latent_hw, context_dim, n_time_ids=0) -> collections.Counter:
    """(B, C, H, W) -> calls of the resnet GroupNorm+SiLU in one UNet call
    at CFG batch 2, bf16 (``n_time_ids``: SDXL's added conditioning)."""
    from ml_stable_diffusion_torch.models.unet import ResnetBlock2D, UNet2DConditionModel

    with torch.device("meta"):
        unet = UNet2DConditionModel(dataclasses.replace(cfg, fused_groupnorm=False))
        unet = unet.to(torch.bfloat16)
    shapes = []
    for m in unet.modules():
        if isinstance(m, ResnetBlock2D):
            for gn in (m.norm1, m.norm2):
                gn.register_forward_hook(
                    lambda mod, inp, out: shapes.append(tuple(inp[0].shape)))
    with torch.device("meta"):
        added = ({"text_embeds": torch.empty(2, 1280), "time_ids": torch.empty(2, n_time_ids)}
                 if n_time_ids else None)
        unet(torch.empty(2, 4, *latent_hw), torch.tensor(500.0),
             torch.empty(2, 77, context_dim), added)
    return collections.Counter(shapes)


def gn_bytes(shape, itemsize=2) -> int:
    B, C, H, W = shape
    return 2 * B * C * H * W * itemsize + 2 * C * itemsize


def groupnorm_sd21_tpu_subset():
    from ml_stable_diffusion_torch.models.unet import UNetConfig

    calls = gn_calls(UNetConfig.sd21(), (64, 64), 1024)
    fits = {s: n for s, n in calls.items() if s[1] * s[2] * s[3] * 2 <= GN_IMAGE_BYTES}
    nbytes = sum(n * (gn_bytes(s) - 4 * s[1]) for s, n in fits.items())  # x and y only
    return dict(what="SD-2.1 512x512 resnet calls within the TPU kernel's 4 MB per image",
                calls_per_unet=sum(calls.values()), kernel_calls_per_unet=sum(fits.values()),
                bytes_per_unet=nbytes, bound_ms_per_unet=1e3 * nbytes / PEAK_BYTES_PER_S,
                bound_by="bytes")


def groupnorm_sdxl():
    from ml_stable_diffusion_torch.models.unet import UNetConfig

    unets = {"base": gn_calls(UNetConfig.sdxl(), (128, 128), 2048, 6),
             "refiner": gn_calls(UNetConfig.sdxl_refiner(), (128, 128), 1280, 5)}
    out = {}
    for name, calls in unets.items():
        shapes = [dict(shape=list(s), calls_per_unet=n, bytes_per_call=gn_bytes(s),
                       bound_ms_per_call=1e3 * gn_bytes(s) / PEAK_BYTES_PER_S)
                  for s, n in sorted(calls.items(), key=lambda kv: (-kv[0][2], kv[0][1]))]
        nbytes = sum(r["bytes_per_call"] * r["calls_per_unet"] for r in shapes)
        out[name] = dict(calls_per_unet=sum(calls.values()), bytes_per_unet=nbytes,
                         bound_ms_per_unet=1e3 * nbytes / PEAK_BYTES_PER_S, shapes=shapes)
    for path, (n_base, n_ref) in SDXL_STEPS.items():
        out[path] = dict(
            calls_per_generation=(n_base * out["base"]["calls_per_unet"]
                                  + n_ref * out["refiner"]["calls_per_unet"]),
            bound_ms_per_generation=(n_base * out["base"]["bound_ms_per_unet"]
                                     + n_ref * out["refiner"]["bound_ms_per_unet"]))
    out["bound_by"] = "bytes"  # ~11 f32 operations per element against 4 bytes
    return out


def palettized_bound(M, K, N):
    nbytes = M * K * 2 + K * N + M * N * 2
    flops = 2 * M * K * N
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return dict(M=M, K=K, N=N, bytes=nbytes, flops=flops, bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def main():
    print(json.dumps({
        "groupnorm_silu": {"sdxl": groupnorm_sdxl(),
                           "sd21_tpu_subset": groupnorm_sd21_tpu_subset()},
        # the 64x64 and 16x16 GEGLU input projections at CFG batch 2
        "dequant_matmul": [palettized_bound(2 * 4096, 320, 2560),
                           palettized_bound(2 * 256, 1280, 10240)],
    }))


if __name__ == "__main__":
    main()
