"""Convert-time correctness gates (port of
ml_stable_diffusion_tpu/convert/verify.py).

Every converted model is run against an independent torch forward on the
same checkpoint state dict and must reach 35 dB (``convert/report.py``): the
UNet, VAE, ControlNets and MMDiT against ``convert/torch_mirrors.py``'s
diffusers mirrors, as in the JAX package, and the CLIP text encoder, the T5
encoder and the safety checker's CLIP vision tower against that file's
transformers mirrors, where the JAX package runs ``transformers`` itself
(which the port does not import).  Each gate runs the port's module as it is
given (loaded in float32 by the caller), on the module's device: the
inputs, drawn on the host from ``np.random.RandomState(0)`` in the JAX
gates' order and shapes, and the state dict go there.
``element_count_matches`` catches silently dropped weights, which the
numerics could mask on tensors of little effect.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from .report import report_correctness

logger = logging.getLogger(__name__)


def _element_count(params) -> int:
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return sum(int(np.prod(tuple(v.shape))) for v in params.values())


def element_count_matches(state_dict: dict, params, name: str,
                          exclude: tuple[str, ...] = ("position_ids",)):
    """Assert the port consumed every source tensor: ``params`` a port
    module or its state dict."""
    src = sum(int(np.prod(tuple(v.shape))) for k, v in state_dict.items()
              if not any(e in k for e in exclude))
    dst = _element_count(params)
    if src != dst:
        raise AssertionError(f"{name}: ported element count {dst} != source {src} — "
                             "the port dropped or duplicated tensors")
    logger.info("%s: element count matches source (%d)", name, src)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _rand(rng, *shape) -> np.ndarray:
    return np.asarray(rng.randn(*shape), np.float32)


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _nchw(x, device) -> torch.Tensor:
    return _t(np.asarray(x, np.float32).transpose(0, 3, 1, 2), device)


def _xl_added_cond(cfg, rng, B, text_embed_dim=None) -> dict:
    """SDXL/refiner micro-conditioning inputs sized from the config, as the
    JAX gate draws them (1280 pooled text width for the published XL and
    refiner checkpoints; tiny configurations pass theirs)."""
    if text_embed_dim is None:
        cand = cfg.projection_class_embeddings_input_dim - 1280
        if cand > 0 and cand % cfg.addition_time_embed_dim == 0:
            text_embed_dim = 1280
        else:  # the XL convention of 6 time ids
            text_embed_dim = (cfg.projection_class_embeddings_input_dim
                              - 6 * cfg.addition_time_embed_dim)
    n_ids = ((cfg.projection_class_embeddings_input_dim - text_embed_dim)
             // cfg.addition_time_embed_dim)
    return {"text_embeds": _rand(rng, B, text_embed_dim),
            "time_ids": rng.randint(0, 1024, size=(B, n_ids)).astype(np.float32)}


@torch.no_grad()
def torch_parity_unet(state_dict, model, label="unet", text_embed_dim=None, hw=16) -> float:
    """The port's UNet against the diffusers mirror on the same state dict."""
    from .torch_mirrors import torch_unet_forward

    cfg, dev = model.config, _device(model)
    rng = np.random.RandomState(0)
    B = 2
    sample = _rand(rng, B, hw, hw, cfg.in_channels)
    t = _t(np.asarray([500.0, 10.0], np.float32), dev)
    ctx = _t(_rand(rng, B, 77, cfg.cross_attention_dim), dev)
    added = (None if cfg.addition_embed_type is None
             else {k: _t(v, dev) for k, v in _xl_added_cond(cfg, rng, B, text_embed_dim).items()})
    tc = (None if not cfg.time_cond_proj_dim
          else _t(_rand(rng, B, cfg.time_cond_proj_dim), dev))  # LCM guidance input
    out = model(_nchw(sample, dev), t, ctx, added_cond=added, timestep_cond=tc)
    ref = torch_unet_forward(state_dict, cfg, _nchw(sample, dev), t, ctx, added_cond=added,
                             timestep_cond=tc)
    return report_correctness(out, ref, f"convert:{label}")


@torch.no_grad()
def torch_parity_controlnet(state_dict, model, label="controlnet") -> float:
    from .torch_mirrors import torch_controlnet_forward

    cfg, dev = model.config, _device(model)
    rng = np.random.RandomState(0)
    B, hw = 2, 16
    sample = _nchw(_rand(rng, B, hw, hw, cfg.in_channels), dev)
    t = _t(np.asarray([500.0, 10.0], np.float32), dev)
    ctx = _t(_rand(rng, B, 77, cfg.cross_attention_dim), dev)
    cond = _nchw(np.asarray(rng.rand(B, hw * 8, hw * 8, 3), np.float32), dev)
    down, mid = model(sample, t, ctx, cond)
    rdown, rmid = torch_controlnet_forward(state_dict, cfg, sample, t, ctx, cond)
    got = torch.cat([d.float().ravel() for d in down] + [mid.float().ravel()])
    ref = torch.cat([r.ravel() for r in rdown] + [rmid.ravel()])
    return report_correctness(got, ref, f"convert:{label}")


@torch.no_grad()
def torch_parity_vae_decoder(state_dict, model, label="vae_decoder", hw=8) -> float:
    from .torch_mirrors import torch_vae_decoder_forward

    dev = _device(model)
    z = _nchw(_rand(np.random.RandomState(0), 2, hw, hw, model.config.latent_channels), dev)
    return report_correctness(model(z), torch_vae_decoder_forward(state_dict, model.config, z),
                              f"convert:{label}")


@torch.no_grad()
def torch_parity_vae_encoder(state_dict, model, label="vae_encoder", hw=64) -> float:
    from .torch_mirrors import torch_vae_encoder_forward

    dev = _device(model)
    x = _nchw(_rand(np.random.RandomState(0), 2, hw, hw, model.config.in_channels) * 0.5, dev)
    return report_correctness(model(x), torch_vae_encoder_forward(state_dict, model.config, x),
                              f"convert:{label}")


def _mmdit_inputs(mcfg, dev, hw):
    rng = np.random.RandomState(0)
    B = 2
    latents = _nchw(_rand(rng, B, hw, hw, mcfg.in_channels), dev)
    t = _t(np.asarray([800.0, 200.0], np.float32), dev)
    ctx = _t(_rand(rng, B, 20, mcfg.context_dim), dev)
    pooled = _t(_rand(rng, B, mcfg.pooled_dim), dev)
    return rng, latents, t, ctx, pooled


@torch.no_grad()
def torch_parity_mmdit(state_dict, model, label="mmdit", hw=16) -> float:
    from .torch_mirrors import torch_mmdit_forward

    _, latents, t, ctx, pooled = _mmdit_inputs(model.config, _device(model), hw)
    out = model(latents, t, ctx, pooled)
    ref = torch_mmdit_forward(state_dict, model.config, latents, t, ctx, pooled)
    return report_correctness(out, ref, f"convert:{label}")


@torch.no_grad()
def torch_parity_sd3_controlnet(state_dict, model, label="sd3_controlnet", hw=16) -> float:
    from .torch_mirrors import torch_sd3_controlnet_forward

    cfg, dev = model.config, _device(model)
    rng, latents, t, ctx, pooled = _mmdit_inputs(cfg.mmdit, dev, hw)
    cond = _nchw(_rand(rng, 2, hw, hw, cfg.mmdit.in_channels), dev)
    down, _ = model(latents, t, ctx, pooled, cond)
    ref = torch_sd3_controlnet_forward(state_dict, cfg.mmdit, cfg.num_layers, latents, t, ctx,
                                       pooled, cond)
    got = torch.cat([d.float().ravel() for d in down])
    return report_correctness(got, torch.cat([r.ravel() for r in ref]), f"convert:{label}")


@torch.no_grad()
def torch_parity_text_encoder(module_dir: str | Path, model) -> float:
    """The port's CLIP text encoder against the transformers mirror on the
    checkpoint's state dict (``last_hidden_state``)."""
    from .load import load_safetensors_state_dict
    from .torch_mirrors import torch_clip_text_forward

    module_dir = Path(module_dir)
    cfg, dev = model.config, _device(model)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, cfg.vocab_size - 2, size=(2, 77))
    ids[:, 0] = min(49406, cfg.vocab_size - 2)
    ids[0, 20:] = cfg.eos_token_id
    ids[1, 50:] = cfg.eos_token_id
    ids = _t(ids, dev)
    ref = torch_clip_text_forward(load_safetensors_state_dict(module_dir), cfg, ids)
    return report_correctness(model(ids)["last_hidden_state"], ref["last_hidden_state"],
                              f"convert:{module_dir.name}")


@torch.no_grad()
def torch_parity_t5(module_dir: str | Path, model) -> float:
    """The port's T5 encoder against the transformers mirror."""
    from ..models.t5 import hf_state_dict
    from .load import load_safetensors_state_dict
    from .torch_mirrors import torch_t5_encoder_forward

    module_dir = Path(module_dir)
    dev = _device(model)
    rng = np.random.RandomState(0)
    ids = rng.randint(3, model.config.vocab_size - 1, size=(2, 77))
    mask = np.ones_like(ids)
    ids[1, 40:] = 0
    mask[1, 40:] = 0
    ids, mask = _t(ids, dev), _t(mask, dev)
    ref = torch_t5_encoder_forward(hf_state_dict(load_safetensors_state_dict(module_dir)),
                                   model.config, ids, mask)
    return report_correctness(model(ids, mask)["encoder_hidden_states"], ref,
                              f"convert:{module_dir.name}")


@torch.no_grad()
def torch_parity_safety(module_dir: str | Path, model) -> float:
    """The safety checker's CLIP vision tower and projection against the
    transformers mirror on the checkpoint's weights (the concept scores
    past the normalized embedding are covered by the unit tests)."""
    from ..models.safety import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
    from .load import load_safetensors_state_dict
    from .torch_mirrors import torch_clip_vision_forward

    module_dir = Path(module_dir)
    cfg, dev = model.config, _device(model)
    rng = np.random.RandomState(0)
    imgs = rng.rand(2, cfg.image_size, cfg.image_size, 3).astype(np.float32)
    x = (imgs - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD
    ref = torch_clip_vision_forward(load_safetensors_state_dict(module_dir), cfg,
                                    _nchw(x, dev))["image_embeds"]
    ref = ref / ref.norm(dim=-1, keepdim=True)
    out = model(_nchw(imgs, dev))["image_embeds"]
    return report_correctness(out, ref, f"convert:{module_dir.name}")
