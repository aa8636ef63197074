"""Pipelines from converted artifact bundles (port of
``ml_stable_diffusion_tpu/convert/load.py:load_pipeline_from_artifacts`` and
``scheduler_config_from_diffusers``).

A bundle is a directory of ``convert/artifacts`` modules (``Unet``,
``TextEncoder``, ``VAEDecoder``, ...; SDXL adds ``TextEncoder2`` and
``RefinerUnet``, SD3 ``MMDiT``) with the tokenizer files and a
``bundle.json`` naming the pipeline family, the scheduler config and the
ControlNets.  Each module's config comes from its manifest.  Its weights are
a Flax tree as the JAX package writes them, converted by
``convert/from_jax.py``, or a port state dict (flat keys), taken as it is.

As in the JAX package's code, a palettized denoiser is loaded with its
``PalettizedTensor``s and installed with ``install_palettized`` in the
default install mode (host dequantization to ``compute_dtype``), and the
other modules are dequantized to float32 as they load.  (The JAX function's
docstring speaks of program mode; its code installs with the default.)

A bundle's VAE encoder and safety checker are loaded in float32 like the
decoder, its ControlNets (``bundle.json``'s ``"controlnets"``: module names;
SD and SD3 bundles, the SDXL branch takes none, as in JAX) in
``compute_dtype``.  An SD3 ControlNet (manifest ``config_class``
``SD3ControlNetConfig``) and a T5 encoder raise ``NotImplementedError``
(ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import json
from collections.abc import Mapping
from pathlib import Path

import torch

from ..models.clip import CLIPTextConfig, CLIPTextEncoder
from ..models.controlnet import ControlNetModel
from ..models.mmdit import MMDiT, MMDiTConfig
from ..models.safety import SafetyChecker, SafetyCheckerConfig
from ..models.unet import UNet2DConditionModel, UNetConfig
from ..models.vae import VAEConfig, VAEDecoder, VAEEncoder
from ..schedulers.base import BetaSchedule, PredictionType, SchedulerConfig, TimestepSpacing
from ..tokenizer import CLIPTokenizer
from .artifacts import load_module
from .from_jax import (
    clip_text_state_dict,
    controlnet_state_dict,
    mmdit_state_dict,
    safety_checker_state_dict,
    unet_state_dict,
    vae_decoder_state_dict,
    vae_encoder_state_dict,
)


def scheduler_config_from_diffusers(cfg: dict) -> SchedulerConfig:
    """A diffusers ``scheduler_config.json`` -> ``SchedulerConfig``."""
    beta_schedule = {
        "linear": BetaSchedule.LINEAR,
        "scaled_linear": BetaSchedule.SCALED_LINEAR,
        "scaledLinear": BetaSchedule.SCALED_LINEAR,
    }.get(cfg.get("beta_schedule", "scaled_linear"))
    if beta_schedule is None:
        raise ValueError(f"unsupported beta_schedule {cfg.get('beta_schedule')!r}")
    return SchedulerConfig(
        num_train_timesteps=cfg.get("num_train_timesteps", 1000),
        beta_start=cfg.get("beta_start", 0.00085),
        beta_end=cfg.get("beta_end", 0.012),
        beta_schedule=beta_schedule,
        prediction_type=PredictionType(cfg.get("prediction_type", "epsilon")),
        steps_offset=cfg.get("steps_offset", 1),
        timestep_spacing=TimestepSpacing(cfg.get("timestep_spacing", "leading")),
    )


def _config(cfg_cls, conf: dict):
    return cfg_cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in conf.items()})


def _state_dict(params: dict, convert) -> dict:
    """A Flax tree (nested) through ``convert``; a port state dict as it is."""
    if any(isinstance(v, Mapping) for v in params.values()):
        return convert(params)
    return params


def load_pipeline_from_artifacts(artifact_dir: str | Path, compute_dtype=torch.bfloat16,
                                 device: str | torch.device = "cuda"):
    """Assemble an SD / SDXL / SD3 pipeline from an artifact bundle on
    ``device``: the denoisers in ``compute_dtype``, the text encoders and
    the VAE decoder and encoder in float32."""
    from ..pipelines import (
        StableDiffusion3Pipeline,
        StableDiffusionPipeline,
        StableDiffusionXLPipeline,
    )

    root = Path(artifact_dir)
    bundle = {}
    if (root / "bundle.json").exists():
        bundle = json.loads((root / "bundle.json").read_text())
    family = bundle.get("family", "StableDiffusionPipeline")
    sched_cfg = (scheduler_config_from_diffusers(bundle["scheduler"])
                 if bundle.get("scheduler") else None)

    def has(name):
        return (root / f"{name}.safetensors").exists()

    def module(name, model_cls, cfg_cls, convert, dtype, dequantize=True):
        """-> (module on ``device`` in ``dtype``, state dict, palettized?);
        a palettized module's storage is left for install_palettized."""
        params, manifest = load_module(root, name=name, dequantize=dequantize, device=device)
        with torch.device("meta"):
            model = model_cls(_config(cfg_cls, manifest["config"]))
        model = model.to_empty(device=device).to(dtype)
        sd = _state_dict(params, convert)
        is_pal = bool(manifest.get("palettized")) and not dequantize
        if not is_pal:
            model.load_state_dict(sd, strict=True)
        return model, sd, is_pal

    def denoiser(name, model_cls, cfg_cls, convert):
        """-> (module, its palettized state dict or None)."""
        model, sd, is_pal = module(name, model_cls, cfg_cls, convert, compute_dtype,
                                   dequantize=False)
        return model, sd if is_pal else None

    def text_encoder(name):
        return module(name, CLIPTextEncoder, CLIPTextConfig, clip_text_state_dict,
                      torch.float32)[0]

    def finish(pipe, pal_map):
        for key, pal in pal_map.items():
            if pal is not None:
                pipe.install_palettized(key, pal, dtype=compute_dtype)
        return pipe

    def controlnet(name):
        manifest = json.loads((root / f"{name}.json").read_text())
        if manifest.get("config_class") == "SD3ControlNetConfig":
            raise NotImplementedError("SD3 ControlNet: ROADMAP Queue 1 item 14")
        return module(name, ControlNetModel, UNetConfig, controlnet_state_dict,
                      compute_dtype)[0]

    safety = (module("SafetyChecker", SafetyChecker, SafetyCheckerConfig,
                     safety_checker_state_dict, torch.float32)[0]
              if has("SafetyChecker") else None)
    dec = module("VAEDecoder", VAEDecoder, VAEConfig, vae_decoder_state_dict, torch.float32)[0]
    enc = (module("VAEEncoder", VAEEncoder, VAEConfig, vae_encoder_state_dict,
                  torch.float32)[0] if has("VAEEncoder") else None)

    if "XL" in family:
        tok = CLIPTokenizer.from_pretrained_dir(root) if (root / "vocab.json").exists() else None
        tok2 = CLIPTokenizer.from_pretrained_dir(root / "tokenizer_2", pad_token="!")
        te = text_encoder("TextEncoder") if has("TextEncoder") else None
        unet, unet_pal = denoiser("Unet", UNet2DConditionModel, UNetConfig, unet_state_dict)
        refiner = refiner_pal = None
        if has("RefinerUnet"):
            refiner, refiner_pal = denoiser("RefinerUnet", UNet2DConditionModel, UNetConfig,
                                            unet_state_dict)
        pipe = StableDiffusionXLPipeline(
            tokenizer=tok, tokenizer2=tok2, text_encoder=te,
            text_encoder2=text_encoder("TextEncoder2"), unet=unet, refiner_unet=refiner,
            vae_decoder=dec, vae_encoder=enc, safety_checker=safety, scheduler_config=sched_cfg,
            force_zeros_for_empty_prompt=bundle.get("force_zeros_for_empty_prompt", True),
            device=device)
        return finish(pipe, {"unet": unet_pal, "refiner": refiner_pal})

    if "StableDiffusion3" in family:
        if has("TextEncoderT5"):
            raise NotImplementedError("the T5 encoder and tokenizer: ROADMAP Queue 1 item 14")
        tok = CLIPTokenizer.from_pretrained_dir(root)
        tok2 = CLIPTokenizer.from_pretrained_dir(root / "tokenizer_2", pad_token="!")
        mmdit, mmdit_pal = denoiser("MMDiT", MMDiT, MMDiTConfig, mmdit_state_dict)
        pipe = StableDiffusion3Pipeline(
            tokenizer=tok, tokenizer2=tok2, text_encoder=text_encoder("TextEncoder"),
            text_encoder2=text_encoder("TextEncoder2"), mmdit=mmdit, vae_decoder=dec,
            vae_encoder=enc, safety_checker=safety, scheduler_config=sched_cfg,
            controlnets=[controlnet(n) for n in bundle.get("controlnets", ())], device=device)
        return finish(pipe, {"unet": mmdit_pal})

    tok = CLIPTokenizer.from_pretrained_dir(root)
    unet, unet_pal = denoiser("Unet", UNet2DConditionModel, UNetConfig, unet_state_dict)
    pipe = StableDiffusionPipeline(
        tokenizer=tok, text_encoder=text_encoder("TextEncoder"), unet=unet, vae_decoder=dec,
        vae_encoder=enc, safety_checker=safety, scheduler_config=sched_cfg,
        controlnets=[controlnet(n) for n in bundle.get("controlnets", ())], device=device)
    return finish(pipe, {"unet": unet_pal})
