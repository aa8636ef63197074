"""The port's ``load_pipeline`` on diffusers-layout checkpoint directories,
and ``load_pipeline_from_artifacts`` on a JAX-written SD3 bundle with a T5
encoder and an SD3 ControlNet, against the JAX loaders, on the CPU.

Synthetic checkouts in the layout diffusers saves: SD (tests/
test_convert_load.py's writers: a sharded UNet, transformers CLIP, the
safety checker), SDXL with a refiner checkout, SD3 with ``text_encoder_3``
(a transformers ``T5EncoderModel`` whose file keeps the tied
``encoder.embed_tokens.weight``), ``tokenizer_3/tokenizer.json`` and one
SD3 ControlNet directory.  Each loads in both packages (the JAX loader's
``compute_dtype`` float32, the port's too, on the CPU); one generation's
latents agree to atol 1e-3.  The SDXL and SD3 denoisers, VAE and ControlNet
files are the state dicts of port modules with seeded weights (the port's
keys are diffusers'; the JAX loader reading them checks that).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import transformers
from safetensors.numpy import save_file

from ml_stable_diffusion_tpu.convert import load_pipeline as jax_load_pipeline
from ml_stable_diffusion_tpu.convert import (
    load_pipeline_from_artifacts as jax_load_pipeline_from_artifacts,
)
from ml_stable_diffusion_tpu.convert.artifacts import save_module as jax_save_module
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig

from ml_stable_diffusion_torch.convert.load import (
    load_pipeline,
    load_pipeline_from_artifacts,
    mmdit_config_from_diffusers,
    unet_config_from_diffusers,
    vae_config_from_diffusers,
)
from ml_stable_diffusion_torch.models.controlnet_sd3 import (
    SD3ControlNetConfig,
    SD3ControlNetModel,
)
from ml_stable_diffusion_torch.models.init import init_random_
from ml_stable_diffusion_torch.models.mmdit import MMDiT
from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel
from ml_stable_diffusion_torch.models.vae import VAEDecoder, VAEEncoder
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

from test_convert_load import (
    _write_safety_checker,
    _write_scheduler,
    _write_text_encoder,
    _write_tokenizer,
    _write_unet,
    _write_vae,
)
from test_native_t5 import _unigram_json

HW = (64, 64)
#: transformers CLIP of test_convert_load: hidden 32, projection 16
CLIP_DIM, PROJ = 32, 16


def _kw(**kw):
    out = dict(prompt="a cat", negative_prompt="blurry", step_count=3, guidance_scale=5.0,
               seed=11, rng="numpy", disable_safety=True)
    out.update(kw)
    return out


def _compare(root, jax_kw, port_kw, gen_kw):
    """-> (JAX result, port result, port pipeline): one generation each."""
    ref_pipe = jax_load_pipeline(root, compute_dtype=jnp.float32, **jax_kw)
    ref = ref_pipe.generate_images(JaxConfig(**gen_kw), image_hw=HW)
    pipe = load_pipeline(root, compute_dtype=torch.float32, device="cpu", **port_kw)
    got = pipe.generate_images(PipelineConfiguration(**gen_kw), image_hw=HW)
    assert np.isfinite(got.latents).all() and got.latents.shape == ref.latents.shape
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)
    return ref_pipe, got, pipe


def _save_sd(d, sd, config):
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(config))
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              str(d / "diffusion_pytorch_model.safetensors"))


# -- SD ------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sd_checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd")
    (root / "model_index.json").write_text(json.dumps({"_class_name":
                                                       "StableDiffusionPipeline"}))
    _write_tokenizer(root / "tokenizer")
    _write_text_encoder(root / "text_encoder")
    _write_unet(root / "unet", sharded=True)
    _write_vae(root / "vae")
    _write_scheduler(root / "scheduler")
    _write_safety_checker(root / "safety_checker", always_flag=True)
    return root


def test_load_pipeline_sd_matches_jax(sd_checkpoint):
    """A sharded UNet, the scheduler config, the VAE split into decoder
    and encoder, the safety checker (its thresholds flag every image)."""
    ref_pipe, got, pipe = _compare(sd_checkpoint, {}, {}, _kw(disable_safety=False,
                                                              scheduler="DDIM"))
    assert got.nsfw_flags == [True] and not got.images.any()
    assert pipe.vae_encoder is not None and pipe.safety_checker is not None
    assert next(pipe.unet.parameters()).dtype == torch.float32
    assert pipe.scheduler_config == type(pipe.scheduler_config)(
        **{f: getattr(ref_pipe.scheduler_config, f).value
           if hasattr(getattr(ref_pipe.scheduler_config, f), "value")
           else getattr(ref_pipe.scheduler_config, f)
           for f in ("num_train_timesteps", "beta_start", "beta_end", "steps_offset")})
    bf16 = load_pipeline(sd_checkpoint, device="cpu")  # the default compute dtype
    assert next(bf16.unet.parameters()).dtype == torch.bfloat16
    assert next(bf16.text_encoder.parameters()).dtype == torch.float32




# -- SDXL ----------------------------------------------------------------------------

def _random_state_dict(module, seed):
    """Seeded weights for a port module, as a numpy state dict (the port's
    keys are diffusers'): variance-preserving matrices, the 1-D parameters
    (norm scales, biases) moved off their 1 / 0 by N(0, 0.1)."""
    gen = torch.Generator().manual_seed(seed)
    init_random_(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _write_xl_unet(d, cross_dim, n_ids, seed):
    cfg = dict(in_channels=4, out_channels=4, block_out_channels=[16, 32],
               down_block_types=["DownBlock2D", "CrossAttnDownBlock2D"],
               up_block_types=["CrossAttnUpBlock2D", "UpBlock2D"], layers_per_block=1,
               transformer_layers_per_block=[1, 1], attention_head_dim=[2, 2],
               cross_attention_dim=cross_dim, norm_num_groups=8,
               addition_embed_type="text_time", addition_time_embed_dim=8,
               projection_class_embeddings_input_dim=PROJ + n_ids * 8)
    _save_sd(d, _random_state_dict(UNet2DConditionModel(unet_config_from_diffusers(cfg)), seed),
             cfg)


@pytest.fixture(scope="module")
def sdxl_checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("sdxl")
    (root / "model_index.json").write_text(json.dumps(
        {"_class_name": "StableDiffusionXLPipeline", "force_zeros_for_empty_prompt": False}))
    _write_tokenizer(root / "tokenizer")
    _write_tokenizer(root / "tokenizer_2")
    _write_text_encoder(root / "text_encoder")
    _write_text_encoder(root / "text_encoder_2", with_projection=True, projection_dim=PROJ)
    _write_xl_unet(root / "unet", 2 * CLIP_DIM, 6, 51)
    _write_vae(root / "vae")
    refiner = tmp_path_factory.mktemp("refiner")
    _write_xl_unet(refiner / "unet", CLIP_DIM, 5, 52)
    return root, refiner


def test_load_pipeline_sdxl_with_refiner_matches_jax(sdxl_checkpoints):
    root, refiner = sdxl_checkpoints
    _, _, pipe = _compare(root, dict(refiner_dir=refiner), dict(refiner_dir=refiner),
                          _kw(step_count=4, refiner_start=0.5, scheduler="DDIM",
                              negative_prompt=""))
    assert pipe.refiner_unet is not None and pipe.force_zeros_for_empty_prompt is False


def test_checkpoint_entries_that_are_not_weights(sd_checkpoint, tmp_path):
    """What older checkpoints store beside the weights loads as the JAX
    porting reads it: SD-1.x's 1x1-convolution ``proj_in``/``proj_out``
    kernels are squeezed to the linear layers' matrices, and a text
    encoder's ``embeddings.position_ids`` buffer is dropped."""
    import shutil

    from ml_stable_diffusion_torch.convert.load import (
        load_safetensors_state_dict,
        load_text_encoder,
        load_unet,
    )

    unet_dir, te_dir = tmp_path / "unet", tmp_path / "text_encoder"
    shutil.copytree(sd_checkpoint / "unet", unet_dir)
    shutil.copytree(sd_checkpoint / "text_encoder", te_dir)
    sd = {k: v.numpy() for k, v in load_safetensors_state_dict(unet_dir).items()}
    convs = [k for k in sd if k.endswith(("proj_in.weight", "proj_out.weight"))]
    assert convs
    for f in unet_dir.glob("*.safetensors*"):
        f.unlink()
    save_file({k: v[:, :, None, None] if k in convs else v for k, v in sd.items()},
              str(unet_dir / "diffusion_pytorch_model.safetensors"))
    te = {k: v.numpy() for k, v in load_safetensors_state_dict(te_dir).items()}
    te["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    save_file(te, str(te_dir / "model.safetensors"))
    for got, want in ((load_unet(unet_dir, torch.float32, device="cpu"),
                       load_unet(sd_checkpoint / "unet", torch.float32, device="cpu")),
                      (load_text_encoder(te_dir, device="cpu"),
                       load_text_encoder(sd_checkpoint / "text_encoder", device="cpu"))):
        for (k, a), b in zip(got.state_dict().items(), want.state_dict().values()):
            assert torch.equal(a, b), k


def test_load_pipeline_options_raise(sd_checkpoint, sdxl_checkpoints):
    """``fuse_qkv=True``: the SD pipeline against the JAX one loaded with it
    (atol 1e-3, its self attentions on ``to_qkv``), and SDXL with its
    refiner, both UNets fused, against the port's unfused load (f32: the
    same products, one GEMM for three; atol 1e-5).  A multilingual encoder
    on SDXL is the JAX ``ValueError``."""
    _, _, pipe = _compare(sd_checkpoint, dict(fuse_qkv=True), dict(fuse_qkv=True),
                          _kw(scheduler="DDIM"))
    names = dict(pipe.unet.named_modules())
    assert pipe.unet.config.fuse_qkv and any(k.endswith("attn1.to_qkv") for k in names)
    assert not any(k.endswith(("attn1.to_q", "attn2.to_qkv")) for k in names)
    root, refiner = sdxl_checkpoints
    kw = _kw(step_count=3, refiner_start=0.5, scheduler="DDIM")
    fused, plain = (load_pipeline(root, refiner_dir=refiner, compute_dtype=torch.float32,
                                  fuse_qkv=f, device="cpu") for f in (True, False))
    assert fused.unet.config.fuse_qkv and fused.refiner_unet.config.fuse_qkv
    np.testing.assert_allclose(
        fused.generate_images(PipelineConfiguration(**kw), image_hw=HW).latents,
        plain.generate_images(PipelineConfiguration(**kw), image_hw=HW).latents, atol=1e-5)
    for loader in (jax_load_pipeline, load_pipeline):
        with pytest.raises(ValueError, match="SD 1.x/2.x feature"):
            loader(root, multilingual_encoder=(object(), object()))


# -- SD3 -----------------------------------------------------------------------------

MM_JSON = dict(patch_size=2, in_channels=16, out_channels=16, attention_head_dim=8,
               num_attention_heads=4, joint_attention_dim=2 * CLIP_DIM,
               pooled_projection_dim=2 * PROJ, pos_embed_max_size=16)


@pytest.fixture(scope="module")
def sd3_checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd3")
    (root / "model_index.json").write_text(json.dumps(
        {"_class_name": "StableDiffusion3Pipeline"}))
    for i, sub in enumerate(("", "_2")):
        _write_tokenizer(root / f"tokenizer{sub}")
        _write_text_encoder(root / f"text_encoder{sub}", with_projection=True,
                            projection_dim=PROJ)
    mm_json = dict(MM_JSON, num_layers=2)
    _save_sd(root / "transformer",
             _random_state_dict(MMDiT(mmdit_config_from_diffusers(mm_json)), 53), mm_json)
    vae_json = dict(latent_channels=16, block_out_channels=[8, 8, 8, 8], layers_per_block=1,
                    norm_num_groups=4, use_quant_conv=False)
    vcfg = vae_config_from_diffusers(vae_json)
    vae = _random_state_dict(VAEEncoder(vcfg), 54)
    vae.update(_random_state_dict(VAEDecoder(vcfg), 55))
    _save_sd(root / "vae", vae, vae_json)
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"_class_name": "FlowMatchEulerDiscreteScheduler", "num_train_timesteps": 1000,
         "shift": 3.0}))
    tcfg = transformers.T5Config(vocab_size=256, d_model=2 * CLIP_DIM, d_kv=16, d_ff=64,
                                 num_layers=2, num_heads=4, feed_forward_proj="gated-gelu",
                                 is_encoder_decoder=False, use_cache=False)
    torch.manual_seed(1)
    t5 = transformers.T5EncoderModel(tcfg).eval()
    (root / "text_encoder_3").mkdir()
    (root / "text_encoder_3" / "config.json").write_text(tcfg.to_json_string())
    save_file({k: v.numpy().copy() for k, v in t5.state_dict().items()},
              str(root / "text_encoder_3" / "model.safetensors"))
    (root / "tokenizer_3").mkdir()
    _unigram_json(root / "tokenizer_3")
    # one SD3 ControlNet (force_zeros false: the pooled vector and the VAE shift)
    net = tmp_path_factory.mktemp("sd3_controlnet")
    net.rmdir()
    cn_json = dict(MM_JSON, _class_name="SD3ControlNetModel", num_layers=2,
                   force_zeros_for_pooled_projection=False)
    cn = SD3ControlNetModel(SD3ControlNetConfig(mmdit=mmdit_config_from_diffusers(cn_json),
                                                num_layers=2))
    _save_sd(net, _random_state_dict(cn, 56), cn_json)
    return root, net


def _control():
    return np.random.RandomState(12).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def sd3_loaded(sd3_checkpoint):
    root, net = sd3_checkpoint
    kw = dict(controlnet_dirs=[net])
    return _compare(root, kw, kw, _kw(prompt="a photo of the cat", guidance_scale=4.5,
                                      controlnet_inputs=[_control()]))


def test_load_pipeline_sd3_with_t5_and_controlnet_matches_jax(sd3_loaded):
    _, _, pipe = sd3_loaded
    assert pipe.t5_encoder is not None and pipe.t5_tokenizer is not None
    table = pipe.t5_encoder.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
    assert table.weight.dtype == torch.float32
    (net,) = pipe.controlnets
    assert not net.config.force_zeros_for_pooled_projection and net.config.num_layers == 2


def test_load_pipeline_from_jax_sd3_bundle_with_t5_and_controlnet(sd3_loaded, sd3_checkpoint,
                                                                  tmp_path):
    """The JAX-loaded SD3 modules saved by the JAX artifact writer, T5 and
    the ControlNet among them; both artifact loaders generate alike."""
    ref_pipe, _, _ = sd3_loaded
    root, _ = sd3_checkpoint
    out = tmp_path / "bundle"
    for name, (model, params) in {
            "TextEncoder": (ref_pipe.text_encoder, ref_pipe.text_encoder_params),
            "TextEncoder2": (ref_pipe.text_encoder2, ref_pipe.text_encoder2_params),
            "MMDiT": (ref_pipe.unet, ref_pipe.unet_params),
            "VAEDecoder": (ref_pipe.vae_decoder, ref_pipe.vae_decoder_params),
            "VAEEncoder": (ref_pipe.vae_encoder, ref_pipe.vae_encoder_params),
            "TextEncoderT5": (ref_pipe.t5_encoder, ref_pipe.t5_encoder_params),
            "ControlNet0": ref_pipe.controlnets[0]}.items():
        jax_save_module(out, params, config=model.config, name=name)
    _write_tokenizer(out / "tokenizer_2")
    for f in ("vocab.json", "merges.txt"):
        (out / f).write_text((root / "tokenizer" / f).read_text())
    (out / "tokenizer_3").mkdir()
    (out / "tokenizer_3" / "tokenizer.json").write_text(
        (root / "tokenizer_3" / "tokenizer.json").read_text())
    (out / "bundle.json").write_text(json.dumps({
        "family": "StableDiffusion3Pipeline", "controlnets": ["ControlNet0"],
        "scheduler": json.loads((root / "scheduler" / "scheduler_config.json").read_text())}))
    kw = _kw(prompt="hello world", guidance_scale=4.5, controlnet_inputs=[_control()])
    want = jax_load_pipeline_from_artifacts(out, compute_dtype=jnp.float32).generate_images(
        JaxConfig(**kw), image_hw=HW).latents
    pipe = load_pipeline_from_artifacts(out, compute_dtype=torch.float32, device="cpu")
    assert pipe.t5_encoder is not None and len(pipe.controlnets) == 1
    got = pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW).latents
    np.testing.assert_allclose(got, want, atol=1e-3)
