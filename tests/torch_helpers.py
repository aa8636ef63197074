"""Tiny JAX models and their port counterparts on the same weights, for the
tests/test_torch_*.py parity tests."""

import dataclasses

import jax
import numpy as np

from ml_stable_diffusion_tpu.pipelines.sd import StableDiffusionPipeline as JaxPipeline

from ml_stable_diffusion_torch.convert.from_jax import (
    clip_text_state_dict,
    unet_state_dict,
    vae_decoder_state_dict,
    vae_encoder_state_dict,
)
from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
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


def pipelines(tmp_path, weight_seed=None, unet=None, encoder=False):
    """-> (JAX pipeline, port pipeline on the CPU) over the tiny models of
    tests/helpers.py.  ``weight_seed``: replace every weight with seeded
    N(0, 0.2) values (helpers.randomize_params); None keeps the Flax init.
    ``unet``: a (Flax UNet, params) pair in place of ``tiny_unet()``;
    ``encoder``: give both pipelines the tiny VAE encoder."""
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
                           vae_encoder=(enc, enc_p) if encoder else None)
    port_pipe = StableDiffusionPipeline(
        tokenizer=CLIPTokenizer.from_pretrained_dir(tmp_path),
        text_encoder=_load(CLIPTextEncoder, CLIPTextConfig, te, te_p, clip_text_state_dict),
        unet=_load(UNet2DConditionModel, UNetConfig, unet, unet_p, unet_state_dict),
        vae_decoder=_load(VAEDecoder, VAEConfig, dec, dec_p, vae_decoder_state_dict),
        vae_encoder=port_vae_encoder(enc, enc_p) if encoder else None,
        device="cpu")
    return jax_pipe, port_pipe
