"""The work a generation asks for, counted by the benchmark from the
configuration's shapes, never read from the program or its profiler.  A
family file (``sdbench/families/<family>.py``) says which of these counts
fits its models; the ones here fit a CFG pipeline of CLIP text encoders, a
conditional UNet and a VAE decoder.

- ``unet_model_flops``: operations of one text row, one UNet sample (a CFG call
  of batch 2N is 2N samples) and one VAE decode of an image, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on
  the ``meta`` device (matrix products, convolutions and attention's two
  products; elementwise work is not counted).
- ``unet_flash_calls`` and ``least_seconds``: the attention calls that the
  port's dispatch sends to its flash kernel (self attention over at least
  256 tokens: the UNet's in bfloat16 at D = 64, and the VAE's one head of
  512 in float32; cross attention over 77 tokens and smaller levels stay
  out), and the least time the card could take for each: the larger of its
  bytes (q, k, v and o, each once) over the memory bandwidth and its
  4 B H Sq Sk D operations over the peak for its dtype.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s bf16, 495 TF32 (the
f32 attention's tensor-core path), 3.35 TB/s HBM3.
"""

from __future__ import annotations

import functools
import json

import torch

from ..reference import models

PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_BYTES_PER_S = 3.35e12
#: the port's flash dispatch threshold on query and key lengths
FLASH_MIN_TOKENS = 256


@functools.lru_cache(maxsize=None)
def _model_flops(cfg_json: str) -> dict[str, float]:
    from torch.utils.flop_counter import FlopCounterMode

    cfg = json.loads(cfg_json)
    H, W = cfg["image_hw"]
    h, w = H // 8, W // 8
    meta = torch.device("meta")
    out = {}
    with torch.device(meta):
        encs = [models.build("clip", e["config"]) for e in cfg["text_encoders"]]
        unet = models.build("unet", cfg["unet"]["config"])
        vae = models.build("vae_decoder", cfg["vae_decoder"]["config"])
    ids = torch.zeros(1, cfg["tokenizer"]["max_length"], dtype=torch.long, device=meta)
    with FlopCounterMode(display=False) as fc:
        for enc in encs:
            enc(ids)
    out["text_row"] = float(fc.get_total_flops())
    c = cfg["unet"]["config"]
    extra = {}
    if c["addition_embed_type"] == "text_time":
        extra = {"text_embeds": torch.zeros(1, cfg["text_encoders"][-1]["config"]["projection_dim"],
                                            device=meta),
                 "time_ids": torch.zeros(1, len(cfg["time_ids"]), device=meta)}
    ctx_dim = c["cross_attention_dim"]
    with FlopCounterMode(display=False) as fc:
        unet(torch.zeros(1, c["in_channels"], h, w, device=meta),
             torch.zeros((), device=meta),
             torch.zeros(1, cfg["tokenizer"]["max_length"], ctx_dim, device=meta), **extra)
    out["unet_sample"] = float(fc.get_total_flops())
    lat = cfg["vae_decoder"]["config"]["latent_channels"]
    with FlopCounterMode(display=False) as fc:
        vae(torch.zeros(1, lat, h, w, device=meta))
    out["vae_image"] = float(fc.get_total_flops())
    return out


def unet_model_flops(cfg: dict) -> dict[str, float]:
    """{"text_row", "unet_sample", "vae_image"}: operations of each."""
    return dict(_model_flops(json.dumps(cfg, sort_keys=True)))


def generation_flops(f: dict, text_rows: int, images: int, steps: int) -> float:
    """Operations of one generation, ``f`` a family's ``model_flops``:
    ``text_rows`` encoded prompt rows, ``steps`` denoiser calls at CFG batch
    2 x ``images``, one decode an image."""
    return text_rows * f["text_row"] + steps * 2 * images * f["unet_sample"] + \
        images * f["vae_image"]


def unet_flash_calls(cfg: dict, images: int) -> list[tuple[int, int, int, int, str, int]]:
    """(B, S, H, D, dtype, calls) of a generation of ``images`` images: the
    UNet's flash self-attention for every step, then the VAE's head."""
    c = cfg["unet"]["config"]
    ch, heads, depth = c["block_out_channels"], c["num_attention_heads"], \
        c["transformer_layers_per_block"]
    h = cfg["image_hw"][0] // 8 * cfg["image_hw"][1] // 8
    L = c["layers_per_block"]
    n = len(ch)
    per_level = [0] * n
    for bi, kind in enumerate(c["down_block_types"]):
        if kind == "CrossAttnDownBlock2D":
            per_level[bi] += L * depth[bi]
    for bi, kind in enumerate(c["up_block_types"]):
        if kind == "CrossAttnUpBlock2D":
            per_level[n - 1 - bi] += (L + 1) * depth[n - 1 - bi]
    per_level[n - 1] += depth[n - 1]  # the mid block, at the last level
    steps = cfg["step_count"]
    out = []
    for lv, count in enumerate(per_level):
        S = h // 4 ** lv
        if count and S >= FLASH_MIN_TOKENS:
            out.append((2 * images, S, heads[lv], ch[lv] // heads[lv], "bfloat16",
                        count * steps))
    v = cfg["vae_decoder"]["config"]
    S_vae = h  # the decoder's mid block runs at the latent resolution
    if S_vae >= FLASH_MIN_TOKENS:
        out.append((images, S_vae, 1, v["block_out_channels"][-1], "float32", 1))
    return out


def least_seconds(B: int, S: int, H: int, D: int, dtype: str) -> float:
    """The least time of one self-attention call (Sq = Sk = S)."""
    size = 2 if dtype == "bfloat16" else 4
    moved = 4 * B * S * H * D * size
    ops = 4 * B * H * S * S * D
    peak = PEAK_BF16 if dtype == "bfloat16" else PEAK_TF32
    return max(moved / PEAK_BYTES_PER_S, ops / peak)


def attention_least_seconds(calls) -> float:
    """The least time of a generation's flash calls, (B, S, H, D, dtype,
    calls) each."""
    return sum(n * least_seconds(B, S, H, D, dt) for B, S, H, D, dt, n in calls)
