"""Tiny JAX models and their port counterparts on the same weights, for the
tests/test_torch_*.py parity tests."""

import dataclasses

import jax
import numpy as np

from ml_stable_diffusion_tpu.pipelines.sd import StableDiffusionPipeline as JaxPipeline

from ml_stable_diffusion_torch.convert.from_jax import (
    clip_text_state_dict,
    controlnet_state_dict,
    safety_checker_state_dict,
    unet_state_dict,
    vae_decoder_state_dict,
    vae_encoder_state_dict,
)
from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from ml_stable_diffusion_torch.models.controlnet import ControlNetModel
from ml_stable_diffusion_torch.models.multilingual import (
    MultilingualProjection,
    port_multilingual_projection,
)
from ml_stable_diffusion_torch.models.safety import SafetyChecker, SafetyCheckerConfig
from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEDecoder, VAEEncoder
from ml_stable_diffusion_torch.pipelines import StableDiffusionPipeline
from ml_stable_diffusion_torch.tokenizer import CLIPTokenizer

from helpers import randomize_params, tiny_text_encoder, tiny_tokenizer, tiny_unet, tiny_vae


def _load(cls, cfg_cls, jax_model, params, convert):
    module = cls(cfg_cls(**dataclasses.asdict(jax_model.config)))
    module.load_state_dict(convert(jax.tree.map(np.asarray, params)), strict=True)
    return module


def port_vae_encoder(enc, enc_p):
    """The port's ``VAEEncoder`` on the weights of a Flax encoder."""
    return _load(VAEEncoder, VAEConfig, enc, enc_p, vae_encoder_state_dict)


def port_controlnet(model, params):
    """The port's ``ControlNetModel`` on the weights of a Flax ControlNet."""
    return _load(ControlNetModel, UNetConfig, model, params, controlnet_state_dict)


def port_safety_checker(model, params):
    """The port's ``SafetyChecker`` on the weights of a Flax one."""
    return _load(SafetyChecker, SafetyCheckerConfig, model, params, safety_checker_state_dict)


def port_multilingual(params):
    """The port's ``MultilingualProjection`` on a Flax one's params."""
    w = np.asarray(params["linear"]["kernel"])
    module = MultilingualProjection(w.shape[1])
    module.load_state_dict(port_multilingual_projection(
        {"weight": w.T, "bias": np.asarray(params["linear"]["bias"])}), strict=True)
    return module


def pipelines(tmp_path, weight_seed=None, unet=None, encoder=False, controlnets=(),
              safety_checker=None, multilingual=None):
    """-> (JAX pipeline, port pipeline on the CPU) over the tiny models of
    tests/helpers.py.  ``weight_seed``: replace every weight with seeded
    N(0, 0.2) values (helpers.randomize_params); None keeps the Flax init.
    ``unet``: a (Flax UNet, params) pair in place of ``tiny_unet()``;
    ``encoder``: give both pipelines the tiny VAE encoder; ``controlnets``
    and ``safety_checker``: (Flax module, params) pairs, taken as they are;
    ``multilingual``: (Flax MultilingualProjection, params, embed_fn)."""
    jax_tok = tiny_tokenizer(tmp_path)
    te, te_p = tiny_text_encoder()
    unet, unet_p = unet or tiny_unet()
    (dec, dec_p), (enc, enc_p) = tiny_vae()
    if weight_seed is not None:
        te_p = randomize_params(te_p, weight_seed)
        unet_p = randomize_params(unet_p, weight_seed + 1)
        dec_p = randomize_params(dec_p, weight_seed + 2)
        enc_p = randomize_params(enc_p, weight_seed + 3)
    jax_pipe = JaxPipeline(tokenizer=jax_tok, text_encoder=(te, te_p),
                           unet=(unet, unet_p), vae_decoder=(dec, dec_p),
                           vae_encoder=(enc, enc_p) if encoder else None,
                           controlnets=list(controlnets), safety_checker=safety_checker,
                           multilingual_encoder=multilingual)
    port_pipe = StableDiffusionPipeline(
        tokenizer=CLIPTokenizer.from_pretrained_dir(tmp_path),
        text_encoder=_load(CLIPTextEncoder, CLIPTextConfig, te, te_p, clip_text_state_dict),
        unet=_load(UNet2DConditionModel, UNetConfig, unet, unet_p, unet_state_dict),
        vae_decoder=_load(VAEDecoder, VAEConfig, dec, dec_p, vae_decoder_state_dict),
        vae_encoder=port_vae_encoder(enc, enc_p) if encoder else None,
        controlnets=[port_controlnet(*net) for net in controlnets],
        safety_checker=None if safety_checker is None else port_safety_checker(*safety_checker),
        multilingual_encoder=(None if multilingual is None
                              else (port_multilingual(multilingual[1]), multilingual[2])),
        device="cpu")
    return jax_pipe, port_pipe


def sdxl_pipelines(tmp_path, refiner=False):
    """-> (JAX SDXL pipeline, port SDXL pipeline on the CPU) over
    tests/test_torch_sdxl.py's tiny models and seeded weights: CLIP-L, the
    projected CLIP-G, the base UNet and, with ``refiner``, the refiner."""
    from ml_stable_diffusion_tpu.pipelines.sdxl import StableDiffusionXLPipeline as JaxSDXL

    from ml_stable_diffusion_torch.pipelines import StableDiffusionXLPipeline

    import test_torch_sdxl as xlt

    (te1, p1), (te2, p2) = tiny_text_encoder(), tiny_text_encoder(use_projection=True)
    unet, up = tiny_unet(cross_dim=xlt.XL_CTX, xl=True)
    (dec, dp), _ = tiny_vae()
    p1, p2, up, dp = (randomize_params(p, s) for p, s in ((p1, 41), (p2, 42), (up, 43), (dp, 45)))
    ref = None
    if refiner:
        ref, rp = xlt._tiny_refiner()
        rp = randomize_params(rp, 44)
    for d in ("l", "g"):
        (tmp_path / d).mkdir(exist_ok=True)
    jax_pipe = JaxSDXL(tokenizer=tiny_tokenizer(tmp_path / "l"),
                       tokenizer2=tiny_tokenizer(tmp_path / "g"), text_encoder=(te1, p1),
                       text_encoder2=(te2, p2), unet=(unet, up),
                       refiner_unet=None if ref is None else (ref, rp), vae_decoder=(dec, dp))
    port_pipe = StableDiffusionXLPipeline(
        tokenizer=CLIPTokenizer.from_pretrained_dir(tmp_path / "l"),
        tokenizer2=CLIPTokenizer.from_pretrained_dir(tmp_path / "g"),
        text_encoder=_load(CLIPTextEncoder, CLIPTextConfig, te1, p1, clip_text_state_dict),
        text_encoder2=_load(CLIPTextEncoder, CLIPTextConfig, te2, p2, clip_text_state_dict),
        unet=_load(UNet2DConditionModel, UNetConfig, unet, up, unet_state_dict),
        refiner_unet=(None if ref is None else
                      _load(UNet2DConditionModel, UNetConfig, ref, rp, unet_state_dict)),
        vae_decoder=_load(VAEDecoder, VAEConfig, dec, dp, vae_decoder_state_dict), device="cpu")
    return jax_pipe, port_pipe


def sd3_pipelines(tmp_path):
    """-> (JAX SD3 pipeline, port SD3 pipeline on the CPU) over
    tests/test_torch_sd3.py's tiny models and seeded weights, without T5."""
    from ml_stable_diffusion_tpu.pipelines.sd3 import StableDiffusion3Pipeline as JaxSD3

    from ml_stable_diffusion_torch.convert.from_jax import mmdit_state_dict
    from ml_stable_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
    from ml_stable_diffusion_torch.pipelines import StableDiffusion3Pipeline

    import test_torch_sd3 as sd3t

    (te1, p1), (te2, p2) = tiny_text_encoder(), tiny_text_encoder(use_projection=True)
    mm, mp = sd3t._tiny_mmdit()
    dec, dp = sd3t._tiny_vae16()
    p1, p2, mp, dp = (randomize_params(p, s) for p, s in ((p1, 31), (p2, 32), (mp, 33), (dp, 34)))
    for d in ("l", "g"):
        (tmp_path / d).mkdir(exist_ok=True)
    jax_pipe = JaxSD3(tokenizer=tiny_tokenizer(tmp_path / "l"),
                      tokenizer2=tiny_tokenizer(tmp_path / "g"), text_encoder=(te1, p1),
                      text_encoder2=(te2, p2), mmdit=(mm, mp), vae_decoder=(dec, dp),
                      t5_sequence_length=sd3t.T5_LEN)
    port_pipe = StableDiffusion3Pipeline(
        tokenizer=CLIPTokenizer.from_pretrained_dir(tmp_path / "l"),
        tokenizer2=CLIPTokenizer.from_pretrained_dir(tmp_path / "g"),
        text_encoder=_load(CLIPTextEncoder, CLIPTextConfig, te1, p1, clip_text_state_dict),
        text_encoder2=_load(CLIPTextEncoder, CLIPTextConfig, te2, p2, clip_text_state_dict),
        mmdit=_load(MMDiT, MMDiTConfig, mm, mp, mmdit_state_dict),
        vae_decoder=_load(VAEDecoder, VAEConfig, dec, dp, vae_decoder_state_dict),
        t5_sequence_length=sd3t.T5_LEN, device="cpu")
    return jax_pipe, port_pipe
