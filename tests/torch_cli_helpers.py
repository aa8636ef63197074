"""What the command-line test files share: tests/test_convert_load.py's tiny
SD checkpoint written without compiling anything, the float32 context both
packages' commands run in, and the flag lists.

``write_sd_checkpoint`` lays out the same directory as test_convert_load's
writers (its configurations, its ``config.json`` files, a sharded UNet, the
safety checker's thresholds), with seeded weights: the UNet's and the VAE's
Flax trees come from ``jax.eval_shape`` and go to diffusers keys through
tests/helpers.py's ``flax_params_to_diffusers_sd``, and the CLIP text model
and the checker take the keys of the port's modules, which load
``transformers``-written files strictly (tests/test_torch_load_diffusers.py).
The writers there spend ~27 s in a jitted init each of the UNet and the VAE
and in importing ``transformers``; these take ~2 s and import no
``transformers``.
"""

import contextlib
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ml_stable_diffusion_tpu.convert.load as jax_load
import ml_stable_diffusion_tpu.pipelines.config as jax_config
from ml_stable_diffusion_tpu.models.unet import UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_tpu.models.vae import VAEConfig, VAEDecoder, VAEEncoder

import ml_stable_diffusion_torch.convert.load as port_load
from ml_stable_diffusion_torch.convert.native_io import save_file
from ml_stable_diffusion_torch.models.clip import CLIPTextEncoder
from ml_stable_diffusion_torch.models.safety import SafetyChecker

from helpers import flax_params_to_diffusers_sd

GEN = ["a cat", "--step-count", "2", "--size", "64x64", "--scheduler", "DDIM",
       "--disable-safety", "--seed", "7", "--rng", "numpy"]
BENCH = ["--step-count", "2", "--size", "64x64", "--scheduler", "DDIM", "--repeats", "1"]
#: palettize the tiny UNet's kernels of this size and more (the default
#: 1e5 takes none)
MIN_SIZE = 2048

#: test_convert_load's configurations (copied: importing that module
#: imports ``transformers``, ~4 s a process)
UNET_CFG = UNetConfig(
    block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1,
    transformer_layers_per_block=(1, 1),
    num_attention_heads=(2, 2),
    cross_attention_dim=32,
    norm_num_groups=8,
)
VAE_CFG = VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4)

TEXT_CONFIG = {"vocab_size": 100, "hidden_size": 32, "intermediate_size": 64,
               "num_hidden_layers": 2, "num_attention_heads": 2,
               "max_position_embeddings": 77, "hidden_act": "gelu", "eos_token_id": 99}
SAFETY_CONFIG = {"vision_config": {"image_size": 32, "patch_size": 8, "hidden_size": 32,
                                   "intermediate_size": 64, "num_hidden_layers": 2,
                                   "num_attention_heads": 2},
                 "projection_dim": 32}


def _init(name: str, shape, rng) -> np.ndarray:
    """A seeded value in the manner of the Flax and HF inits: kernels
    N(0, 1/fan_in) (fan_in from the torch layout ``(out, in, ...)``, or a
    Flax one ``(..., in, out)``), norm scales near 1, the rest small."""
    if len(shape) >= 2:
        fan_in = (np.prod(shape[:-1]) if name.endswith("kernel") else np.prod(shape[1:]))
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
    if name.endswith("scale") or ("norm" in name and name.endswith("weight")):
        return (1.0 + 0.05 * rng.randn(*shape)).astype(np.float32)
    return (0.05 * rng.randn(*shape)).astype(np.float32)


def _flax_params(model, seed, *inputs):
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), *inputs))["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: _init(str(path[-1].key), s.shape, rng), shapes)


def _port_state_dict(module, seed) -> dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    return {k: _init(k, tuple(v.shape), rng) for k, v in module.state_dict().items()}


def write_tokenizer(d):
    """test_convert_load's CLIP vocabulary: the letters, no merges."""
    vocab = {}
    for c in "abcdefghijklmnopqrstuvwxyz":
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    vocab["!"] = len(vocab)
    vocab["<|startoftext|>"] = 98
    vocab["<|endoftext|>"] = 99
    d.mkdir(parents=True)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")


def write_scheduler(d):
    """test_convert_load's PNDM ``scheduler_config.json``."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "scheduler_config.json").write_text(json.dumps({
        "_class_name": "PNDMScheduler", "num_train_timesteps": 1000, "beta_start": 0.00085,
        "beta_end": 0.012, "beta_schedule": "scaled_linear", "prediction_type": "epsilon",
        "steps_offset": 1, "timestep_spacing": "leading"}))


def write_text_encoder(d, with_projection=False, projection_dim=16, seed=0):
    cfg = dict(TEXT_CONFIG, projection_dim=projection_dim, architectures=[
        "CLIPTextModelWithProjection" if with_projection else "CLIPTextModel"])
    module = CLIPTextEncoder(port_load.clip_config_from_diffusers(cfg, with_projection))
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(cfg))
    save_file(_port_state_dict(module, seed), d / "model.safetensors")


def write_safety_checker(d, always_flag=False, seed=1):
    """test_convert_load's checker: three concepts and two special-care
    ones; ``always_flag`` thresholds trip the NSFW rule on any image."""
    cfg = port_load.safety_config_from_diffusers(SAFETY_CONFIG)
    sd = _port_state_dict(SafetyChecker(cfg), seed)
    g = np.random.RandomState(seed + 1)
    sd["concept_embeds"] = g.randn(3, 32).astype(np.float32)
    sd["concept_embeds_weights"] = np.full(3, -10.0 if always_flag else 10.0, np.float32)
    sd["special_care_embeds"] = g.randn(2, 32).astype(np.float32)
    sd["special_care_embeds_weights"] = np.full(2, 10.0, np.float32)
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(SAFETY_CONFIG))
    save_file(sd, d / "model.safetensors")


def write_unet(d, seed=2):
    """A sharded UNet in two files with its index, as test_convert_load's
    ``_write_unet(sharded=True)``."""
    params = _flax_params(UNet2DConditionModel(UNET_CFG), seed, jnp.zeros((1, 8, 8, 4)),
                          jnp.zeros((1,)), jnp.zeros((1, 77, 32)))
    sd = flax_params_to_diffusers_sd(params, "unet")
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps({
        "in_channels": 4, "out_channels": 4, "block_out_channels": [16, 32],
        "down_block_types": list(UNET_CFG.down_block_types),
        "up_block_types": list(UNET_CFG.up_block_types),
        "layers_per_block": 1, "transformer_layers_per_block": [1, 1],
        "attention_head_dim": [2, 2], "cross_attention_dim": 32, "norm_num_groups": 8}))
    keys = sorted(sd)
    half = len(keys) // 2
    shards = ("model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors")
    save_file({k: sd[k] for k in keys[:half]}, d / shards[0])
    save_file({k: sd[k] for k in keys[half:]}, d / shards[1])
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: shards[i >= half] for i, k in enumerate(keys)}}))


def write_vae(d, seed=3):
    sd = flax_params_to_diffusers_sd(
        _flax_params(VAEEncoder(VAE_CFG), seed, jnp.zeros((1, 64, 64, 3))), "vae_encoder")
    sd.update(flax_params_to_diffusers_sd(
        _flax_params(VAEDecoder(VAE_CFG), seed + 1, jnp.zeros((1, 8, 8, 4))), "vae_decoder"))
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps({
        "latent_channels": 4, "block_out_channels": [8, 8, 8, 8], "layers_per_block": 1,
        "norm_num_groups": 4}))
    save_file(sd, d / "diffusion_pytorch_model.safetensors")


def write_sd_checkpoint(root):
    """test_convert_load's ``sd_checkpoint`` directory at ``root``."""
    (root / "model_index.json").write_text(json.dumps(
        {"_class_name": "StableDiffusionPipeline"}))
    write_tokenizer(root / "tokenizer")
    write_text_encoder(root / "text_encoder")
    write_unet(root / "unet")
    write_vae(root / "vae")
    write_scheduler(root / "scheduler")
    write_safety_checker(root / "safety_checker", always_flag=True)
    return root


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """``write_sd_checkpoint`` in a directory of its own."""
    return write_sd_checkpoint(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def probe(ckpt):
    """The port's probe batch (NHWC) and the JAX UNet, float32."""
    from ml_stable_diffusion_torch.cli import compress

    cfg = port_load.unet_config_from_diffusers(json.loads((ckpt / "unet" / "config.json")
                                                          .read_text()))
    latents, t, ctx = compress.probe_batch(ckpt, "64x64", 2, cfg, device="cpu")
    model, params = jax_load.load_unet(ckpt / "unet", dtype=jnp.float32)
    return (latents, t, ctx), model, params


@contextlib.contextmanager
def float32():
    """Within the block, both packages' ``load_pipeline`` in float32 (as
    the pipeline parity tests compare them) and the JAX configuration's
    draws from numpy (its default ``jax`` mode draws with ``jax.random``,
    which the port does not reproduce; ``sdtpu-benchmark`` has no
    ``--rng``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_load, "load_pipeline",
                   functools.partial(jax_load.load_pipeline, compute_dtype=jnp.float32))
        mp.setattr(port_load, "load_pipeline",
                   functools.partial(port_load.load_pipeline, compute_dtype=torch.float32))
        mp.setattr(jax_config, "PipelineConfiguration",
                   functools.partial(jax_config.PipelineConfiguration, rng="numpy"))
        yield


def run(module, argv):
    """A command of either package, in-process: ``module.run(args)``."""
    return module.run(module.parser_spec().parse_args(argv))
