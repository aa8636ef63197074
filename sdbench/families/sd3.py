"""Stable Diffusion 3 and 3.5: CLIP-L, OpenCLIP bigG and T5-XXL, the
MMDiT (MMDiT-X with ``dual_attention_layers``), rectified flow and the
16-channel VAE decoder in the port's ``StableDiffusion3Pipeline``.

What the benchmark counts of a generation:

- ``model_flops``: operations of one text row (both CLIPs and T5), one MMDiT
  sample (a CFG call of batch 2N is 2N samples) and one VAE decode, counted
  by ``FlopCounterMode`` over the plain reference on the ``meta`` device;
- ``flash_calls``: the self-attention calls the port sends to its flash
  kernel, in ``work``'s format: the dual blocks' ``attn2`` at every step
  (bf16, D = 64, over the 4096 latent tokens at 1024x1024) and the VAE's
  one float32 head of 512 over the latent tokens;
- ``joint_least_seconds``: the least time of the joint attention calls (the
  kernel's multi-stream entry), one a block a step, whose two query streams
  are each shorter than the keys they attend over.
"""

from __future__ import annotations

import functools
import json

import torch

from sdbench.harness import build, work
from sdbench.reference import mmdit as ref_mmdit
from sdbench.reference.sd3 import Reference, t5_tokenize

#: the port's configuration class and module of each kind
KINDS = dict(build.KINDS,
             mmdit=("ml_stable_diffusion_torch.models.mmdit", "MMDiTConfig", "MMDiT"),
             t5=("ml_stable_diffusion_torch.models.t5", "T5Config", "T5Encoder"))


class LettersT5Tokenizer:
    """The port's T5 tokenizer interface over the letters vocabulary of
    ``sdbench.reference.sd3.t5_tokenize``."""

    def __init__(self, tok: dict):
        self.tok = tok

    def tokenize(self, text: str, max_length: int):
        return t5_tokenize(text, dict(self.tok, max_length=max_length))


def pipeline(cfg: dict, seed: int, device):
    from ml_stable_diffusion_torch.pipelines import PipelineConfiguration, \
        StableDiffusion3Pipeline

    def module(kind, spec):
        return build.port_module(kind, spec, seed, device, KINDS, ref_mmdit.build)

    if {e["output"] for e in cfg["text_encoders"]} != {"penultimate_hidden_state"}:
        raise ValueError("the SD3 pipeline conditions on the CLIPs' penultimate states")
    # the denoiser first: a port without its preset fails before any allocation
    mmdit = ref_mmdit.scale_positions_(module("mmdit", cfg["mmdit"]),
                                       getattr(torch, cfg["mmdit"]["dtype"]))
    enc = {e["role"]: module("clip", e) for e in cfg["text_encoders"]}
    tok = build.tokenizer(cfg["tokenizer"])
    pipe = StableDiffusion3Pipeline(
        tokenizer=tok, tokenizer2=tok, text_encoder=enc["text_encoder"],
        text_encoder2=enc["text_encoder2"], mmdit=mmdit,
        vae_decoder=module("vae_decoder", cfg["vae_decoder"]),
        t5_tokenizer=LettersT5Tokenizer(cfg["t5_tokenizer"]), t5_encoder=module("t5", cfg["t5"]),
        t5_sequence_length=cfg["t5_tokenizer"]["max_length"], device=device)
    stated = {"latent_scale": (cfg["latent_scale"], pipe.default_latent_scale),
              "latent_shift": (cfg["latent_shift"], pipe.default_latent_shift),
              "timestep_shift": (cfg["timestep_shift"], PipelineConfiguration.timestep_shift)}
    wrong = {k: v for k, v in stated.items() if v[0] != v[1]}
    if wrong:
        raise ValueError(f"the pipeline differs from the file: {wrong} (file, pipeline)")
    return pipe


def reference(cfg: dict, seed: int, device) -> Reference:
    return Reference(cfg, seed, device)


def _tokens(cfg: dict) -> tuple[int, int]:
    """(latent tokens, context tokens) of one MMDiT call."""
    m = cfg["mmdit"]["config"]
    H, W = cfg["image_hw"]
    p = 8 * m["patch_size"]
    return (H // p) * (W // p), cfg["tokenizer"]["max_length"] + cfg["t5_tokenizer"]["max_length"]


@functools.lru_cache(maxsize=None)
def _model_flops(cfg_json: str) -> dict[str, float]:
    from torch.utils.flop_counter import FlopCounterMode

    cfg = json.loads(cfg_json)
    H, W = cfg["image_hw"]
    meta = torch.device("meta")
    with torch.device(meta):
        clips = [ref_mmdit.build("clip", e["config"]) for e in cfg["text_encoders"]]
        t5 = ref_mmdit.build("t5", cfg["t5"]["config"])
        mm = ref_mmdit.build("mmdit", cfg["mmdit"]["config"])
        vae = ref_mmdit.build("vae_decoder", cfg["vae_decoder"]["config"])
    L, L5 = cfg["tokenizer"]["max_length"], cfg["t5_tokenizer"]["max_length"]
    out = {}
    with FlopCounterMode(display=False) as fc:
        for enc in clips:
            enc(torch.zeros(1, L, dtype=torch.long, device=meta))
        t5(torch.zeros(1, L5, dtype=torch.long, device=meta),
           torch.ones(1, L5, dtype=torch.long, device=meta))
    out["text_row"] = float(fc.get_total_flops())
    c = cfg["mmdit"]["config"]
    with FlopCounterMode(display=False) as fc:
        mm(torch.zeros(1, c["in_channels"], H // 8, W // 8, device=meta),
           torch.zeros((), device=meta), torch.zeros(1, L + L5, c["context_dim"], device=meta),
           torch.zeros(1, c["pooled_dim"], device=meta))
    out["unet_sample"] = float(fc.get_total_flops())
    lat = cfg["vae_decoder"]["config"]["latent_channels"]
    with FlopCounterMode(display=False) as fc:
        vae(torch.zeros(1, lat, H // 8, W // 8, device=meta))
    out["vae_image"] = float(fc.get_total_flops())
    return out


def model_flops(cfg: dict) -> dict[str, float]:
    """{"text_row", "unet_sample", "vae_image"}: operations of each, under
    ``work.generation_flops``' keys (the MMDiT's under "unet_sample")."""
    return dict(_model_flops(json.dumps(cfg, sort_keys=True)))


def flash_calls(cfg: dict, images: int) -> list[tuple[int, int, int, int, str, int]]:
    """(B, S, H, D, dtype, calls) of a generation of ``images`` images: the
    dual blocks' ``attn2`` for every step, then the VAE's head."""
    m = cfg["mmdit"]["config"]
    S, _ = _tokens(cfg)
    heads = m["num_heads"]
    out = []
    dual = len(m["dual_attention_layers"]) * cfg["step_count"]
    if dual and S >= work.FLASH_MIN_TOKENS:
        out.append((2 * images, S, heads, m["hidden_size"] // heads,
                    cfg["mmdit"]["dtype"], dual))
    S_vae = cfg["image_hw"][0] // 8 * cfg["image_hw"][1] // 8
    if S_vae >= work.FLASH_MIN_TOKENS:
        out.append((images, S_vae, 1, cfg["vae_decoder"]["config"]["block_out_channels"][-1],
                    "float32", 1))
    return out


def joint_least_seconds(cfg: dict, images: int) -> float:
    """The least time of a generation's joint attention calls, one a block a
    step: B = 2N rows, the latent and context query streams (4096 + 154 at
    1024x1024) over the keys of both (4250), so ``work.least_seconds`` of
    a 4250-token call, each query stream's output written once."""
    m = cfg["mmdit"]["config"]
    heads = m["num_heads"]
    one = work.least_seconds(2 * images, sum(_tokens(cfg)), heads, m["hidden_size"] // heads,
                             cfg["mmdit"]["dtype"])
    return one * m["depth"] * cfg["step_count"]
