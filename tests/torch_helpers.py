"""Tiny JAX models and their port counterparts on the same weights, for the
tests/test_torch_*.py parity tests."""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import functools

import flax.linen
import jax
import numpy as np
import torch

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

import helpers
from helpers import CTX_DIM, VOCAB, randomize_params, tiny_tokenizer


def _once(make):
    """``make`` from tests/helpers.py, run once a process for each set of
    arguments: a tiny Flax model and its initial params, whose jitted
    ``init`` costs 1 to 9 s a call.  Each caller gets containers of its own
    around the same (immutable) arrays."""
    made = functools.cache(make)

    @functools.wraps(make)
    def tiny(*args, **kw):
        return jax.tree.map(lambda x: x, made(*args, **kw))

    return tiny


tiny_text_encoder = _once(helpers.tiny_text_encoder)
tiny_unet = _once(helpers.tiny_unet)
tiny_vae = _once(helpers.tiny_vae)


def traced(make, *args, **kw):
    """``make(*args, **kw)`` with the Flax inits inside it traced by
    ``jax.eval_shape``, not compiled: the same structure, every param a
    ``ShapeDtypeStruct``.  For callers that replace every weight
    (``randomize_params``), which need the shapes only.  A maker made
    ``_once`` is traced through its uncached original: a cache filled
    under the trace would hand out its abstract values."""
    make = getattr(make, "__wrapped__", make)
    modules = {}

    def arrays():
        leaves, modules["tree"] = jax.tree_util.tree_flatten(make(*args, **kw))
        modules.update((i, x) for i, x in enumerate(leaves) if isinstance(x, flax.linen.Module))
        return [None if i in modules else x for i, x in enumerate(leaves)]

    leaves = jax.eval_shape(arrays)
    tree = modules.pop("tree")
    return jax.tree_util.tree_unflatten(tree, [modules.get(i, x) for i, x in enumerate(leaves)])


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
    # seeded weights replace the init's: its shapes are enough
    made = tiny_text_encoder, tiny_unet, tiny_vae
    if weight_seed is not None:
        made = [functools.partial(traced, m) for m in made]
    te, te_p = made[0]()
    unet, unet_p = unet or made[1]()
    (dec, dec_p), (enc, enc_p) = made[2]()
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

    (te1, p1), (te2, p2) = traced(tiny_text_encoder), traced(tiny_text_encoder,
                                                             use_projection=True)
    unet, up = traced(tiny_unet, cross_dim=xlt.XL_CTX, xl=True)
    (dec, dp), _ = traced(tiny_vae)
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

    (te1, p1), (te2, p2) = traced(tiny_text_encoder), traced(tiny_text_encoder,
                                                             use_projection=True)
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


# -- port-only tiny pipelines (no JAX model): the port held against itself --------

#: the tiny text encoders' and UNets' geometry, as tests/helpers.py's
_CLIP = dict(vocab_size=VOCAB, hidden_size=CTX_DIM, intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=2, eos_token_id=VOCAB - 1, projection_dim=32)
_UNET = dict(block_out_channels=(16, 32), layers_per_block=1, transformer_layers_per_block=(1, 1),
             num_attention_heads=(2, 2), norm_num_groups=8)
_VAE = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4)


def _seeded(module, seed):
    """``module`` in eval mode with variance-preserving weights from ``seed``."""
    from ml_stable_diffusion_torch.models.init import init_random_

    return init_random_(module, torch.Generator().manual_seed(seed)).eval()


def _sd_unet_config(**kw):
    return UNetConfig(down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                      up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                      cross_attention_dim=CTX_DIM, **_UNET, **kw)


def _xl_unet_config(cross_dim, time_ids, **kw):
    return UNetConfig(down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                      up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
                      cross_attention_dim=cross_dim, addition_embed_type="text_time",
                      addition_time_embed_dim=8,
                      projection_class_embeddings_input_dim=32 + time_ids * 8, **_UNET, **kw)


def port_sd_pipeline(tmp_path, seed=0, encoder=True, controlnets=0):
    """A port SD pipeline on the CPU over tiny modules with seeded weights:
    CLIP, the UNet, the VAE decoder and (``encoder``) encoder, and
    ``controlnets`` ControlNets."""
    tiny_tokenizer(tmp_path)
    return StableDiffusionPipeline(
        tokenizer=CLIPTokenizer.from_pretrained_dir(tmp_path),
        text_encoder=_seeded(CLIPTextEncoder(CLIPTextConfig(**_CLIP)), seed),
        unet=_seeded(UNet2DConditionModel(_sd_unet_config()), seed + 1),
        vae_decoder=_seeded(VAEDecoder(VAEConfig(**_VAE)), seed + 2),
        vae_encoder=_seeded(VAEEncoder(VAEConfig(**_VAE)), seed + 3) if encoder else None,
        controlnets=[_seeded(ControlNetModel(_sd_unet_config()), seed + 4 + i)
                     for i in range(controlnets)],
        device="cpu")


def port_sdxl_pipeline(tmp_path, seed=0, refiner=True):
    """A port SDXL pipeline on the CPU over tiny modules: CLIP-L, a
    projected CLIP-G, the base UNet and (``refiner``) the refiner."""
    from ml_stable_diffusion_torch.pipelines import StableDiffusionXLPipeline

    for d in ("l", "g"):
        (tmp_path / d).mkdir(exist_ok=True)
        tiny_tokenizer(tmp_path / d)
    return StableDiffusionXLPipeline(
        tokenizer=CLIPTokenizer.from_pretrained_dir(tmp_path / "l"),
        tokenizer2=CLIPTokenizer.from_pretrained_dir(tmp_path / "g"),
        text_encoder=_seeded(CLIPTextEncoder(CLIPTextConfig(**_CLIP)), seed),
        text_encoder2=_seeded(CLIPTextEncoder(CLIPTextConfig(**_CLIP, use_text_projection=True)),
                              seed + 1),
        unet=_seeded(UNet2DConditionModel(_xl_unet_config(2 * CTX_DIM, 6)), seed + 2),
        refiner_unet=(_seeded(UNet2DConditionModel(_xl_unet_config(CTX_DIM, 5)), seed + 3)
                      if refiner else None),
        vae_decoder=_seeded(VAEDecoder(VAEConfig(**_VAE)), seed + 4), device="cpu")


def port_sd3_pipeline(tmp_path, seed=0, t5=True):
    """A port SD3 pipeline on the CPU over tiny modules: CLIP-L, a projected
    CLIP-G, the MMDiT, the 16-channel VAE decoder and (``t5``) a two-layer
    T5 with a unigram tokenizer, at a T5 length of 16."""
    from ml_stable_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
    from ml_stable_diffusion_torch.models.t5 import T5Config, T5Encoder
    from ml_stable_diffusion_torch.pipelines import StableDiffusion3Pipeline
    from ml_stable_diffusion_torch.tokenizer.t5 import T5Tokenizer

    from test_native_t5 import _unigram_json

    for d in ("l", "g", "t5"):
        (tmp_path / d).mkdir(exist_ok=True)
    for d in ("l", "g"):
        tiny_tokenizer(tmp_path / d)
    mm = MMDiTConfig(patch_size=2, in_channels=16, out_channels=16, depth=2, hidden_size=32,
                     num_heads=4, context_dim=128, pooled_dim=CTX_DIM + 32,
                     pos_embed_max_size=16)
    vae = VAEConfig(**_VAE, latent_channels=16, use_quant_conv=False)
    t5_cfg = T5Config(vocab_size=256, d_model=128, d_kv=16, d_ff=64, num_layers=2, num_heads=4)
    return StableDiffusion3Pipeline(
        tokenizer=CLIPTokenizer.from_pretrained_dir(tmp_path / "l"),
        tokenizer2=CLIPTokenizer.from_pretrained_dir(tmp_path / "g"),
        text_encoder=_seeded(CLIPTextEncoder(CLIPTextConfig(**_CLIP)), seed),
        text_encoder2=_seeded(CLIPTextEncoder(CLIPTextConfig(**_CLIP, use_text_projection=True)),
                              seed + 1),
        mmdit=_seeded(MMDiT(mm), seed + 2), vae_decoder=_seeded(VAEDecoder(vae), seed + 3),
        t5_tokenizer=T5Tokenizer(_unigram_json(tmp_path / "t5")) if t5 else None,
        t5_encoder=_seeded(T5Encoder(t5_cfg), seed + 4) if t5 else None,
        t5_sequence_length=16, device="cpu")
