"""Pipelines from diffusers-layout checkpoint directories and from converted
artifact bundles (port of ml_stable_diffusion_tpu/convert/load.py).

``load_pipeline``: a diffusers checkout (``model_index.json`` names the
family by its ``_class_name``: SD, SDXL or SD3), each module read from its
``config.json`` and its (possibly sharded, ``*.safetensors.index.json``)
safetensors, and loaded with ``load_state_dict(strict=True)``: the
denoisers and ControlNets in ``compute_dtype``, the T5 encoder in
``compute_dtype`` with its relative-position table in float32, the CLIP
encoders, the VAE and the safety checker in float32, as the JAX loader
loads them.  Two kinds of checkpoint entry are not weights and are adapted
as the JAX loader's porting does: a 1x1 convolution kernel stored for a
linear layer (SD-1.x ``proj_in``/``proj_out``) is squeezed, and the
``embeddings.position_ids`` index buffers of older transformers checkpoints
are dropped (as is T5's tied ``encoder.embed_tokens.weight``).
``fuse_qkv=True`` serves the SD and SDXL UNets (the refiner too) on fused
self-attention projections (``convert/optimize.py:fuse_qkv_params``,
``UNetConfig.fuse_qkv``), as the JAX loader does; their ControlNets and the
SD3 MMDiT stay as they are.  There is no ``mesh`` argument.

``load_pipeline_from_artifacts``: a directory of ``convert/artifacts``
modules (``Unet``, ``TextEncoder``, ``VAEDecoder``, ...; SDXL adds
``TextEncoder2`` and ``RefinerUnet``, SD3 ``MMDiT`` and ``TextEncoderT5``
with ``tokenizer_3/tokenizer.json``) with the tokenizer files and a
``bundle.json`` naming the pipeline family, the scheduler config and the
ControlNets.  Each module's config comes from its manifest.  Its weights are
a Flax tree as the JAX package writes them, converted by
``convert/from_jax.py``, or a port state dict (flat keys), taken as it is.
As in the JAX package's code, a palettized denoiser is loaded with its
``PalettizedTensor``s and installed with ``install_palettized`` in the
default install mode (host dequantization to ``compute_dtype``), and the
other modules are dequantized to float32 as they load.  (The JAX function's
docstring speaks of program mode; its code installs with the default.)  A
bundle's VAE encoder and safety checker load in float32 like the decoder,
its ControlNets (``bundle.json``'s ``"controlnets"``: module names; SD and
SD3 bundles, the SDXL branch takes none, as in JAX; manifest
``config_class`` ``SD3ControlNetConfig`` for an SD3 net) and its T5 encoder
in ``compute_dtype``.

Neither loader's SDXL branch takes ControlNets, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from collections.abc import Mapping
from pathlib import Path

import torch

from ..models.clip import CLIPTextConfig, CLIPTextEncoder
from ..models.controlnet import ControlNetModel
from ..models.controlnet_sd3 import SD3ControlNetConfig, SD3ControlNetModel
from ..models.mmdit import MMDiT, MMDiTConfig
from ..models.safety import SafetyChecker, SafetyCheckerConfig
from ..models.t5 import T5Config, T5Encoder, hf_state_dict
from ..models.unet import UNet2DConditionModel, UNetConfig
from ..models.vae import VAEConfig, VAEDecoder, VAEEncoder
from ..schedulers.base import BetaSchedule, PredictionType, SchedulerConfig, TimestepSpacing
from ..tokenizer import CLIPTokenizer
from ..tokenizer.t5 import T5Tokenizer
from .artifacts import load_module
from .from_jax import (
    clip_text_state_dict,
    controlnet_state_dict,
    mmdit_state_dict,
    safety_checker_state_dict,
    sd3_controlnet_state_dict,
    t5_state_dict,
    unet_state_dict,
    vae_decoder_state_dict,
    vae_encoder_state_dict,
)
from .optimize import fuse_qkv_params


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


def load_safetensors_state_dict(module_dir: str | Path) -> dict[str, torch.Tensor]:
    """A module directory's state dict: the files its
    ``*.safetensors.index.json`` maps to, else every ``*.safetensors``."""
    from .native_io import load_file

    module_dir = Path(module_dir)
    index = next(iter(sorted(module_dir.glob("*.safetensors.index.json"))), None)
    if index is not None:
        files = sorted(set(json.loads(index.read_text())["weight_map"].values()))
        files = [module_dir / f for f in files]
    else:
        files = sorted(module_dir.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no safetensors in {module_dir}")
    sd = {}
    for f in files:
        sd.update(load_file(f))
    return sd


def _config_json(module_dir: Path) -> dict:
    return json.loads((Path(module_dir) / "config.json").read_text())


def unet_config_from_diffusers(cfg: dict) -> UNetConfig:
    """A diffusers UNet (or ControlNet) ``config.json`` -> ``UNetConfig``.
    diffusers' ``attention_head_dim`` is the SD family's head count where
    ``num_attention_heads`` is absent."""
    n = len(cfg["block_out_channels"])

    def per_block(key, default):
        v = cfg.get(key, default)
        return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n

    heads = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
    heads = tuple(heads) if isinstance(heads, (list, tuple)) else (heads,) * n
    return UNetConfig(
        in_channels=cfg["in_channels"],
        out_channels=cfg.get("out_channels", cfg["in_channels"]),
        block_out_channels=tuple(cfg["block_out_channels"]),
        down_block_types=tuple(cfg["down_block_types"]),
        # ControlNet checkpoints have no up blocks
        up_block_types=tuple(cfg.get("up_block_types", ())),
        layers_per_block=cfg.get("layers_per_block", 2),
        transformer_layers_per_block=per_block("transformer_layers_per_block", 1),
        num_attention_heads=heads,
        cross_attention_dim=cfg["cross_attention_dim"],
        norm_num_groups=cfg.get("norm_num_groups", 32),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        freq_shift=cfg.get("freq_shift", 0),
        addition_embed_type=cfg.get("addition_embed_type"),
        addition_time_embed_dim=cfg.get("addition_time_embed_dim", 256),
        projection_class_embeddings_input_dim=cfg.get(
            "projection_class_embeddings_input_dim", 2816),
        time_cond_proj_dim=cfg.get("time_cond_proj_dim"),
    )


def vae_config_from_diffusers(cfg: dict) -> VAEConfig:
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        use_quant_conv=cfg.get("use_quant_conv", True),
    )


def clip_config_from_diffusers(cfg: dict, with_projection: bool = False) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        eos_token_id=cfg.get("eos_token_id", 49407),
        use_text_projection=with_projection,
        projection_dim=cfg.get("projection_dim", 1280),
    )


def t5_config_from_diffusers(cfg: dict) -> T5Config:
    return T5Config(
        vocab_size=cfg["vocab_size"],
        d_model=cfg["d_model"],
        d_kv=cfg["d_kv"],
        d_ff=cfg["d_ff"],
        num_layers=cfg["num_layers"],
        num_heads=cfg["num_heads"],
    )


def mmdit_config_from_diffusers(cfg: dict) -> MMDiTConfig:
    return MMDiTConfig(
        patch_size=cfg.get("patch_size", 2),
        in_channels=cfg.get("in_channels", 16),
        out_channels=cfg.get("out_channels", 16),
        depth=cfg["num_layers"],
        hidden_size=cfg.get("attention_head_dim", 64) * cfg["num_attention_heads"],
        num_heads=cfg["num_attention_heads"],
        context_dim=cfg.get("joint_attention_dim", 4096),
        pooled_dim=cfg.get("pooled_projection_dim", 2048),
        pos_embed_max_size=cfg.get("pos_embed_max_size", 192),
        qk_norm=cfg.get("qk_norm") is not None,
        dual_attention_layers=tuple(cfg.get("dual_attention_layers") or ()),
    )


def safety_config_from_diffusers(cfg: dict) -> SafetyCheckerConfig:
    """An HF ``StableDiffusionSafetyChecker`` ``config.json`` (its
    ``vision_config``); the concept-bank sizes are read off the buffers'
    shapes by ``load_safety_checker``."""
    v = cfg.get("vision_config", cfg)
    return SafetyCheckerConfig(
        image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 14),
        hidden_size=v.get("hidden_size", 1024),
        intermediate_size=v.get("intermediate_size", 4096),
        num_hidden_layers=v.get("num_hidden_layers", 24),
        num_attention_heads=v.get("num_attention_heads", 16),
        projection_dim=cfg.get("projection_dim", 768),
    )


def load_scheduler_config(checkpoint_dir: str | Path) -> SchedulerConfig | None:
    """``<checkpoint>/scheduler/scheduler_config.json``, or None without one
    (the pipelines then take the SD defaults)."""
    path = Path(checkpoint_dir) / "scheduler" / "scheduler_config.json"
    if not path.exists():
        return None
    return scheduler_config_from_diffusers(json.loads(path.read_text()))


def _empty(model_cls, cfg, dtype, device):
    """``model_cls(cfg)`` on ``device`` in ``dtype``, uninitialised: built on
    the meta device, so the weights are allocated once, in ``dtype``."""
    with torch.device("meta"):
        model = model_cls(cfg)
    return model.to(dtype).to_empty(device=device)


def _build(model_cls, cfg, sd: dict, dtype, device):
    """``model_cls(cfg)`` on ``device`` in ``dtype`` with a diffusers state
    dict ``sd`` loaded strictly."""
    model = _empty(model_cls, cfg, dtype, device)
    params = dict(model.named_parameters())
    sd = {k: v for k, v in sd.items() if not k.endswith("embeddings.position_ids")}
    for key, value in sd.items():
        p = params.get(key)
        # a 1x1 convolution kernel stored for a linear layer
        if p is not None and p.ndim == 2 and value.ndim == 4 and value.shape[2:] == (1, 1):
            sd[key] = value[:, :, 0, 0]
    model.load_state_dict(sd, strict=True)
    return model.eval()


def load_safety_checker(module_dir: str | Path, device: str | torch.device = "cuda"):
    """An HF ``safety_checker/`` directory -> ``SafetyChecker`` (float32)."""
    module_dir = Path(module_dir)
    sd = load_safetensors_state_dict(module_dir)
    cfg = dataclasses.replace(safety_config_from_diffusers(_config_json(module_dir)),
                              num_concepts=sd["concept_embeds"].shape[0],
                              num_special_care=sd["special_care_embeds"].shape[0])
    return _build(SafetyChecker, cfg, sd, torch.float32, device)


def load_text_encoder(module_dir: str | Path, with_projection: bool | None = None,
                      device: str | torch.device = "cuda"):
    """A transformers CLIP text model directory -> ``CLIPTextEncoder``
    (float32); ``with_projection`` None reads it off ``architectures``
    (``CLIPTextModelWithProjection``)."""
    module_dir = Path(module_dir)
    raw = _config_json(module_dir)
    if with_projection is None:
        with_projection = "CLIPTextModelWithProjection" in (raw.get("architectures") or [])
    return _build(CLIPTextEncoder, clip_config_from_diffusers(raw, with_projection),
                  load_safetensors_state_dict(module_dir), torch.float32, device)


def load_unet(module_dir: str | Path, dtype=torch.bfloat16, fuse_qkv: bool = False,
              device: str | torch.device = "cuda"):
    """A diffusers ``unet/`` directory -> ``UNet2DConditionModel`` in
    ``dtype``; with ``fuse_qkv`` its self attentions on one fused
    projection."""
    module_dir = Path(module_dir)
    cfg = unet_config_from_diffusers(_config_json(module_dir))
    sd = load_safetensors_state_dict(module_dir)
    if fuse_qkv:
        cfg = dataclasses.replace(cfg, fuse_qkv=True)
        sd = fuse_qkv_params(sd)
    return _build(UNet2DConditionModel, cfg, sd, dtype, device)


def load_vae(module_dir: str | Path, device: str | torch.device = "cuda"):
    """A diffusers ``vae/`` directory -> (``VAEDecoder``, ``VAEEncoder``),
    float32: the one state dict split into the decoder's and the
    encoder's."""
    module_dir = Path(module_dir)
    cfg = vae_config_from_diffusers(_config_json(module_dir))
    sd = load_safetensors_state_dict(module_dir)

    def part(prefixes):
        return {k: v for k, v in sd.items() if k.startswith(prefixes)}

    return (_build(VAEDecoder, cfg, part(("decoder.", "post_quant_conv.")), torch.float32,
                   device),
            _build(VAEEncoder, cfg, part(("encoder.", "quant_conv.")), torch.float32, device))


def load_controlnet(module_dir: str | Path, dtype=torch.bfloat16,
                    device: str | torch.device = "cuda"):
    """A diffusers ControlNet directory, by its ``_class_name``: an
    ``SD3ControlNetModel`` or a UNet-family ``ControlNetModel``."""
    module_dir = Path(module_dir)
    raw = _config_json(module_dir)
    sd = load_safetensors_state_dict(module_dir)
    if "SD3" in raw.get("_class_name", ""):
        # mmdit.depth is the branch's own num_layers: the config records no
        # depth of the paired MMDiT
        cfg = SD3ControlNetConfig(
            mmdit=mmdit_config_from_diffusers(raw), num_layers=raw["num_layers"],
            force_zeros_for_pooled_projection=raw.get("force_zeros_for_pooled_projection",
                                                      True))
        return _build(SD3ControlNetModel, cfg, sd, dtype, device)
    return _build(ControlNetModel, unet_config_from_diffusers(raw), sd, dtype, device)


def load_mmdit(module_dir: str | Path, dtype=torch.bfloat16,
               device: str | torch.device = "cuda"):
    """A diffusers SD3 ``transformer/`` directory -> ``MMDiT``."""
    module_dir = Path(module_dir)
    return _build(MMDiT, mmdit_config_from_diffusers(_config_json(module_dir)),
                  load_safetensors_state_dict(module_dir), dtype, device)


def load_t5(module_dir: str | Path, dtype=torch.bfloat16,
            device: str | torch.device = "cuda"):
    """A transformers ``T5EncoderModel`` directory (SD3's
    ``text_encoder_3/``) -> ``T5Encoder`` in ``dtype``, its relative-position
    table float32."""
    module_dir = Path(module_dir)
    return _build(T5Encoder, t5_config_from_diffusers(_config_json(module_dir)),
                  hf_state_dict(load_safetensors_state_dict(module_dir)), dtype, device)


def load_pipeline(checkpoint_dir: str | Path, custom_vae_dir=None, refiner_dir=None,
                  controlnet_dirs=(), compute_dtype=torch.bfloat16, fuse_qkv: bool = False,
                  multilingual_encoder=None, device: str | torch.device = "cuda", mesh=None):
    """An SD / SDXL / SD3 pipeline on ``device`` from a diffusers-layout
    checkpoint directory, the family read from ``model_index.json``.
    ``custom_vae_dir`` replaces the checkpoint's VAE; ``refiner_dir`` (SDXL)
    is a checkpoint whose ``unet/`` is the refiner; ``controlnet_dirs`` (SD
    and SD3) are ControlNet directories; ``multilingual_encoder`` is the SD
    pipeline's ``(MultilingualProjection, embed_fn)`` (an SD 1.x/2.x
    feature: SDXL and SD3 raise ``ValueError``); ``mesh``: a
    ``parallel.make_mesh`` mesh the assembled pipeline is sharded over
    (``pipe.shard(mesh)``)."""
    pipe = _assemble_pipeline(checkpoint_dir, custom_vae_dir, refiner_dir, controlnet_dirs,
                              compute_dtype, fuse_qkv, multilingual_encoder, device)
    return pipe if mesh is None else pipe.shard(mesh)


def _assemble_pipeline(checkpoint_dir, custom_vae_dir, refiner_dir, controlnet_dirs,
                       compute_dtype, fuse_qkv, multilingual_encoder, device):
    from ..pipelines import (
        StableDiffusion3Pipeline,
        StableDiffusionPipeline,
        StableDiffusionXLPipeline,
    )

    root = Path(checkpoint_dir)
    index = json.loads((root / "model_index.json").read_text())
    family = index["_class_name"]
    if multilingual_encoder is not None and ("XL" in family or "StableDiffusion3" in family):
        raise ValueError("multilingual text encoding is an SD 1.x/2.x feature "
                         "(reference Resources.swift:73-88)")
    tok = CLIPTokenizer.from_pretrained_dir(root / "tokenizer")
    dec, enc = load_vae(Path(custom_vae_dir) if custom_vae_dir else root / "vae", device)
    sched_cfg = load_scheduler_config(root)
    safety = (load_safety_checker(root / "safety_checker", device)
              if (root / "safety_checker" / "config.json").exists() else None)

    if "XL" in family:
        tok2 = CLIPTokenizer.from_pretrained_dir(root / "tokenizer_2", pad_token="!")
        te = (load_text_encoder(root / "text_encoder", device=device)
              if (root / "text_encoder").exists() else None)
        refiner = (load_unet(Path(refiner_dir) / "unet", compute_dtype, fuse_qkv, device)
                   if refiner_dir else None)
        return StableDiffusionXLPipeline(
            tokenizer=tok, tokenizer2=tok2, text_encoder=te,
            text_encoder2=load_text_encoder(root / "text_encoder_2", True, device),
            unet=load_unet(root / "unet", compute_dtype, fuse_qkv, device), refiner_unet=refiner,
            vae_decoder=dec, vae_encoder=enc, safety_checker=safety, scheduler_config=sched_cfg,
            force_zeros_for_empty_prompt=index.get("force_zeros_for_empty_prompt", True),
            device=device)

    controlnets = [load_controlnet(d, compute_dtype, device) for d in controlnet_dirs]
    if "StableDiffusion3" in family:
        t5 = t5_tok = None
        if (root / "text_encoder_3").exists():
            t5 = load_t5(root / "text_encoder_3", compute_dtype, device)
            t5_tok = T5Tokenizer(root / "tokenizer_3" / "tokenizer.json")
        return StableDiffusion3Pipeline(
            tokenizer=tok, tokenizer2=CLIPTokenizer.from_pretrained_dir(
                root / "tokenizer_2", pad_token="!"),
            text_encoder=load_text_encoder(root / "text_encoder", True, device),
            text_encoder2=load_text_encoder(root / "text_encoder_2", True, device),
            t5_tokenizer=t5_tok, t5_encoder=t5,
            mmdit=load_mmdit(root / "transformer", compute_dtype, device), vae_decoder=dec,
            vae_encoder=enc, safety_checker=safety, scheduler_config=sched_cfg,
            controlnets=controlnets, device=device)

    return StableDiffusionPipeline(
        tokenizer=tok, text_encoder=load_text_encoder(root / "text_encoder", device=device),
        unet=load_unet(root / "unet", compute_dtype, fuse_qkv, device), vae_decoder=dec,
        vae_encoder=enc, safety_checker=safety, scheduler_config=sched_cfg,
        multilingual_encoder=multilingual_encoder, controlnets=controlnets, device=device)


# -- artifact bundles ----------------------------------------------------------------

def _config(cfg_cls, conf: dict):
    """A manifest's config (``dataclasses.asdict``) -> ``cfg_cls``; an
    ``SD3ControlNetConfig`` holds its MMDiT config nested."""
    if cfg_cls is SD3ControlNetConfig:
        return SD3ControlNetConfig(
            mmdit=_config(MMDiTConfig, conf["mmdit"]), num_layers=conf["num_layers"],
            force_zeros_for_pooled_projection=conf.get("force_zeros_for_pooled_projection",
                                                       True))
    return cfg_cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in conf.items()})


def _state_dict(params: dict, convert) -> dict:
    """A Flax tree (nested) through ``convert``; a port state dict as it is."""
    if any(isinstance(v, Mapping) for v in params.values()):
        return convert(params)
    return params


def load_pipeline_from_artifacts(artifact_dir: str | Path, compute_dtype=torch.bfloat16,
                                 device: str | torch.device = "cuda", mesh=None):
    """Assemble an SD / SDXL / SD3 pipeline from an artifact bundle on
    ``device``: the denoisers in ``compute_dtype``, the text encoders and
    the VAE decoder and encoder in float32; with ``mesh``, sharded over it
    once assembled (``pipe.shard(mesh)``)."""
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
        model = _empty(model_cls, _config(cfg_cls, manifest["config"]), dtype, device)
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
        return pipe if mesh is None else pipe.shard(mesh)

    def controlnet(name):
        manifest = json.loads((root / f"{name}.json").read_text())
        if manifest.get("config_class") == "SD3ControlNetConfig":
            return module(name, SD3ControlNetModel, SD3ControlNetConfig,
                          sd3_controlnet_state_dict, compute_dtype)[0]
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
        tok = CLIPTokenizer.from_pretrained_dir(root)
        tok2 = CLIPTokenizer.from_pretrained_dir(root / "tokenizer_2", pad_token="!")
        t5 = t5_tok = None
        if has("TextEncoderT5"):
            t5 = module("TextEncoderT5", T5Encoder, T5Config, t5_state_dict, compute_dtype)[0]
            t5_tok = T5Tokenizer(root / "tokenizer_3" / "tokenizer.json")
        mmdit, mmdit_pal = denoiser("MMDiT", MMDiT, MMDiTConfig, mmdit_state_dict)
        pipe = StableDiffusion3Pipeline(
            tokenizer=tok, tokenizer2=tok2, text_encoder=text_encoder("TextEncoder"),
            text_encoder2=text_encoder("TextEncoder2"), t5_tokenizer=t5_tok, t5_encoder=t5,
            mmdit=mmdit, vae_decoder=dec, vae_encoder=enc, safety_checker=safety,
            scheduler_config=sched_cfg,
            controlnets=[controlnet(n) for n in bundle.get("controlnets", ())], device=device)
        return finish(pipe, {"unet": mmdit_pal})

    tok = CLIPTokenizer.from_pretrained_dir(root)
    unet, unet_pal = denoiser("Unet", UNet2DConditionModel, UNetConfig, unet_state_dict)
    pipe = StableDiffusionPipeline(
        tokenizer=tok, text_encoder=text_encoder("TextEncoder"), unet=unet, vae_decoder=dec,
        vae_encoder=enc, safety_checker=safety, scheduler_config=sched_cfg,
        controlnets=[controlnet(n) for n in bundle.get("controlnets", ())], device=device)
    return finish(pipe, {"unet": unet_pal})
