"""The port's convert-time gates (``ml_stable_diffusion_torch/convert/verify.py``)
and its torch mirrors (``convert/torch_mirrors.py``), on the CPU:

- each diffusers mirror copied from the JAX package equals the JAX
  ``convert/torch_mirrors.py`` on the same state dict and inputs, bit for
  bit (both are torch);
- the three mirrors written for the port (CLIP text encoder, T5 encoder,
  CLIP vision tower with its projection) agree with ``transformers`` to
  1e-5 on tiny configurations;
- every ``torch_parity_*`` gate passes (>= 35 dB) on a correct port module
  and trips below 35 dB on one with two blocks swapped, and
  ``element_count_matches`` trips on a dropped tensor.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import numpy as np
import pytest
import torch
import transformers

from ml_stable_diffusion_tpu.convert import torch_mirrors as jax_mirrors
from ml_stable_diffusion_tpu.models.mmdit import MMDiTConfig as JaxMMDiTConfig
from ml_stable_diffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from ml_stable_diffusion_tpu.models.vae import VAEConfig as JaxVAEConfig

from ml_stable_diffusion_torch.convert import torch_mirrors, verify
from ml_stable_diffusion_torch.convert.native_io import save_file
from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from ml_stable_diffusion_torch.models.controlnet import ControlNetModel
from ml_stable_diffusion_torch.models.controlnet_sd3 import (
    SD3ControlNetConfig,
    SD3ControlNetModel,
)
from ml_stable_diffusion_torch.models.init import init_random_
from ml_stable_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
from ml_stable_diffusion_torch.models.safety import SafetyChecker, SafetyCheckerConfig
from ml_stable_diffusion_torch.models.t5 import T5Config, T5Encoder
from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEDecoder, VAEEncoder

TINY_SD = UNetConfig(block_out_channels=(32, 64),
                     down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                     up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
                     transformer_layers_per_block=(1, 1), num_attention_heads=(2, 4),
                     cross_attention_dim=48, norm_num_groups=8)
TINY_XL = dataclasses.replace(
    TINY_SD, down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"), transformer_layers_per_block=(1, 2),
    addition_embed_type="text_time", projection_class_embeddings_input_dim=32 + 6 * 16,
    addition_time_embed_dim=16)
TINY_LCM = dataclasses.replace(TINY_SD, time_cond_proj_dim=16)
TINY_VAE = VAEConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)
TINY_MMDIT = MMDiTConfig(patch_size=2, in_channels=16, out_channels=16, depth=3, hidden_size=32,
                         num_heads=4, context_dim=24, pooled_dim=20, pos_embed_max_size=16)
TINY_CLIP = CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                           num_hidden_layers=3, num_attention_heads=2, hidden_act="quick_gelu",
                           eos_token_id=99, projection_dim=16)
TINY_T5 = T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=3, num_heads=4)
TINY_VISION = SafetyCheckerConfig(image_size=32, patch_size=8, hidden_size=32,
                                  intermediate_size=64, num_hidden_layers=3,
                                  num_attention_heads=2, projection_dim=16, num_concepts=3,
                                  num_special_care=2)


def _seeded(module, seed):
    """Variance-preserving weights, the 1-D parameters moved off their 1 / 0
    by N(0, 0.1): every norm scale and bias matters."""
    gen = torch.Generator().manual_seed(seed)
    init_random_(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return module.eval()


def _jax_cfg(cls, cfg):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen)


def _unet_inputs(cfg, gen, hw=8):
    added = None
    if cfg.addition_embed_type:
        added = {"text_embeds": _randn(gen, 2, 32),
                 "time_ids": torch.randint(0, 1024, (2, 6), generator=gen).float()}
    tc = _randn(gen, 2, cfg.time_cond_proj_dim) if cfg.time_cond_proj_dim else None
    return (_randn(gen, 2, cfg.in_channels, hw, hw), torch.tensor([500.0, 10.0]),
            _randn(gen, 2, 7, cfg.cross_attention_dim)), dict(added_cond=added, timestep_cond=tc)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return torch.cat([_flat(o) for o in out])
    return out.ravel()


# -- the copied mirrors against the JAX package's ------------------------------------

def _mirror_cases():
    gen = torch.Generator().manual_seed(0)
    cases = {}
    for name, cfg in (("unet_sd", TINY_SD), ("unet_xl", TINY_XL), ("unet_lcm", TINY_LCM)):
        args, kw = _unet_inputs(cfg, gen)
        cases[name] = (UNet2DConditionModel, cfg, JaxUNetConfig, "torch_unet_forward", args, kw)
    args, _ = _unet_inputs(TINY_SD, gen)
    cases["controlnet"] = (ControlNetModel, TINY_SD, JaxUNetConfig, "torch_controlnet_forward",
                           args + (torch.rand(2, 3, 64, 64, generator=gen),), {})
    cases["vae_decoder"] = (VAEDecoder, TINY_VAE, JaxVAEConfig, "torch_vae_decoder_forward",
                            (_randn(gen, 2, 4, 8, 8),), {})
    cases["vae_encoder"] = (VAEEncoder, TINY_VAE, JaxVAEConfig, "torch_vae_encoder_forward",
                            (_randn(gen, 2, 3, 16, 16),), {})
    mm_args = (_randn(gen, 2, 16, 8, 8), torch.tensor([800.0, 200.0]), _randn(gen, 2, 5, 24),
               _randn(gen, 2, 20))
    for qk in (False, True):
        cases[f"mmdit_qk{int(qk)}"] = (MMDiT, dataclasses.replace(TINY_MMDIT, qk_norm=qk),
                                       JaxMMDiTConfig, "torch_mmdit_forward", mm_args, {})
    return cases


MIRROR_CASES = _mirror_cases()


@pytest.mark.parametrize("name", sorted(MIRROR_CASES))
def test_mirror_equals_jax_mirror(name):
    model_cls, cfg, jax_cls, fn, args, kw = MIRROR_CASES[name]
    sd = _seeded(model_cls(cfg), 1).state_dict()
    got = getattr(torch_mirrors, fn)(sd, cfg, *args, **kw)
    want = getattr(jax_mirrors, fn)(sd, _jax_cfg(jax_cls, cfg), *args, **kw)
    assert torch.isfinite(_flat(got)).all()
    assert torch.equal(_flat(got), _flat(want))


def test_sd3_controlnet_mirror_equals_jax_mirror():
    cfg = SD3ControlNetConfig(mmdit=TINY_MMDIT, num_layers=2)
    sd = _seeded(SD3ControlNetModel(cfg), 2).state_dict()
    gen = torch.Generator().manual_seed(3)
    args = (_randn(gen, 2, 16, 8, 8), torch.tensor([800.0, 200.0]), _randn(gen, 2, 5, 24),
            _randn(gen, 2, 20), _randn(gen, 2, 16, 8, 8))
    got = torch_mirrors.torch_sd3_controlnet_forward(sd, cfg.mmdit, 2, *args)
    want = jax_mirrors.torch_sd3_controlnet_forward(sd, _jax_cfg(JaxMMDiTConfig, TINY_MMDIT), 2,
                                                    *args)
    assert torch.equal(_flat(got), _flat(want))


# -- the new mirrors against transformers --------------------------------------------

def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("act,projection,eos", [("quick_gelu", False, 99),
                                                ("gelu", True, 99), ("quick_gelu", False, 2)])
def test_clip_text_mirror_matches_transformers(act, projection, eos):
    cfg = dataclasses.replace(TINY_CLIP, hidden_act=act, use_text_projection=projection,
                              eos_token_id=eos)
    hf_cfg = transformers.CLIPTextConfig(
        vocab_size=100, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=2, max_position_embeddings=77, hidden_act=act, eos_token_id=eos,
        bos_token_id=98, projection_dim=16)
    cls = (transformers.CLIPTextModelWithProjection if projection
           else transformers.CLIPTextModel)
    torch.manual_seed(0)
    hf = cls(hf_cfg).eval()
    ids = torch.randint(3, 98, (2, 77), generator=torch.Generator().manual_seed(1))
    ids[0, 20:], ids[1, 50:] = 99, 99
    if eos == 2:  # legacy pooling: at the largest id
        ids[0, 30] = 99
    with torch.no_grad():
        ref = hf(input_ids=ids)
    got = torch_mirrors.torch_clip_text_forward(hf.state_dict(), cfg, ids)
    _close(got["last_hidden_state"], ref.last_hidden_state)
    _close(got["pooled_output"], ref.text_embeds if projection else ref.pooler_output)


def test_t5_mirror_matches_transformers():
    hf_cfg = transformers.T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=3,
                                   num_heads=4, feed_forward_proj="gated-gelu",
                                   relative_attention_num_buckets=32,
                                   relative_attention_max_distance=128, dropout_rate=0.0)
    torch.manual_seed(0)
    hf = transformers.T5EncoderModel(hf_cfg).eval()
    with torch.no_grad():  # a trained model's layer norms are not ones
        for name, p in hf.named_parameters():
            if "layer_norm" in name:
                p.add_(0.1 * torch.randn(p.shape))
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(3, 63, (2, 40), generator=gen)
    mask = torch.ones_like(ids)
    ids[1, 25:], mask[1, 25:] = 0, 0
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=mask).last_hidden_state
    got = torch_mirrors.torch_t5_encoder_forward(hf.state_dict(), TINY_T5, ids, mask)
    _close(got, ref)


def test_clip_vision_mirror_matches_transformers():
    hf_cfg = transformers.CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=32,
                                           intermediate_size=64, num_hidden_layers=3,
                                           num_attention_heads=2, projection_dim=16)
    torch.manual_seed(0)
    hf = transformers.CLIPVisionModelWithProjection(hf_cfg).eval()
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = hf(pixel_values=x)
    got = torch_mirrors.torch_clip_vision_forward(hf.state_dict(), TINY_VISION, x, prefix="")
    _close(got["image_embeds"], ref.image_embeds)
    _close(got["pooled_output"], hf.vision_model(pixel_values=x).pooler_output)


# -- the gates ------------------------------------------------------------------------

def _swap(module, a: str, b: str):
    """``module`` with submodules ``a`` and ``b`` holding each other's
    weights: a mis-wired port."""
    sd = module.state_dict()
    out = dict(sd)
    for k in sd:
        if k.startswith(a + "."):
            out[k], out[b + k[len(a):]] = sd[b + k[len(a):]], sd[k]
    module.load_state_dict(out)
    return module


GATES = {
    "unet_sd": (lambda: UNet2DConditionModel(TINY_SD), "torch_parity_unet",
                ("up_blocks.1.attentions.0", "up_blocks.1.attentions.1")),
    "unet_xl": (lambda: UNet2DConditionModel(TINY_XL), "torch_parity_unet",
                ("down_blocks.1.attentions.0.transformer_blocks.0",
                 "down_blocks.1.attentions.0.transformer_blocks.1")),
    "unet_lcm": (lambda: UNet2DConditionModel(TINY_LCM), "torch_parity_unet",
                 ("up_blocks.1.attentions.1", "up_blocks.1.attentions.0")),
    "controlnet": (lambda: ControlNetModel(TINY_SD), "torch_parity_controlnet",
                   ("controlnet_down_blocks.0", "controlnet_down_blocks.1")),
    "vae_decoder": (lambda: VAEDecoder(TINY_VAE), "torch_parity_vae_decoder",
                    ("decoder.up_blocks.0.resnets.0", "decoder.up_blocks.0.resnets.1")),
    "vae_encoder": (lambda: VAEEncoder(TINY_VAE), "torch_parity_vae_encoder",
                    ("encoder.mid_block.resnets.0", "encoder.mid_block.resnets.1")),
    "mmdit": (lambda: MMDiT(TINY_MMDIT), "torch_parity_mmdit",
              ("transformer_blocks.0", "transformer_blocks.1")),
    "sd3_controlnet": (lambda: SD3ControlNetModel(SD3ControlNetConfig(TINY_MMDIT, 2)),
                       "torch_parity_sd3_controlnet",
                       ("transformer_blocks.0", "transformer_blocks.1")),
}


@pytest.mark.parametrize("name", sorted(GATES))
def test_state_dict_gate_passes_and_trips(name):
    make, gate, (a, b) = GATES[name]
    model = _seeded(make(), 4)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    assert getattr(verify, gate)(sd, model, label=name) >= 35.0
    verify.element_count_matches(sd, model, name)
    with pytest.raises(AssertionError, match="below the 35.0 dB gate"):
        getattr(verify, gate)(sd, _swap(model, a, b), label=name)
    with pytest.raises(AssertionError, match="element count"):
        verify.element_count_matches(sd, {k: v for k, v in sd.items() if k != "conv_out.bias"
                                          and not k.endswith(".0.bias")}, name)


DIR_GATES = {
    "text_encoder": (lambda: CLIPTextEncoder(TINY_CLIP), "torch_parity_text_encoder",
                     ("text_model.encoder.layers.0", "text_model.encoder.layers.1")),
    "text_encoder_projected": (
        lambda: CLIPTextEncoder(dataclasses.replace(TINY_CLIP, use_text_projection=True,
                                                    hidden_act="gelu")),
        "torch_parity_text_encoder",
        ("text_model.encoder.layers.1", "text_model.encoder.layers.2")),
    "t5": (lambda: T5Encoder(TINY_T5), "torch_parity_t5",
           ("encoder.block.1", "encoder.block.2")),
    "safety_checker": (lambda: SafetyChecker(TINY_VISION), "torch_parity_safety",
                       ("vision_model.vision_model.encoder.layers.0",
                        "vision_model.vision_model.encoder.layers.1")),
}


@pytest.mark.parametrize("name", sorted(DIR_GATES))
def test_checkpoint_dir_gate_passes_and_trips(name, tmp_path):
    """The gates that read the checkpoint directory (transformers modules in
    the JAX package)."""
    make, gate, (a, b) = DIR_GATES[name]
    model = _seeded(make(), 5)
    save_file(model.state_dict(), tmp_path / "model.safetensors")
    assert getattr(verify, gate)(tmp_path, model) >= 35.0
    with pytest.raises(AssertionError, match="below the 35.0 dB gate"):
        getattr(verify, gate)(tmp_path, _swap(model, a, b))
