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
