"""Tiny configurations for the benchmark's CPU tests, and the ``cuda``
marker (tests that need an NVIDIA card; they skip, deciding inside the
test, on a host without one)."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


def _clip(hidden, proj=False):
    return {"vocab_size": 49408, "hidden_size": hidden, "intermediate_size": 2 * hidden,
            "num_hidden_layers": 2, "num_attention_heads": 2, "max_position_embeddings": 77,
            "hidden_act": "gelu", "layer_norm_eps": 1e-05, "eos_token_id": 49407,
            "use_text_projection": proj, "projection_dim": 16}


def tiny_config(family: str = "sd") -> dict:
    """A configuration of the benchmark's format at a size the CPU runs in
    seconds: 64x64 images, 3 steps, float32 throughout (so that a sound
    run agrees with the reference to rounding)."""
    real = json.loads((ROOT / "sdbench/configs/sd21-base-512.json").read_text())
    cfg = copy.deepcopy(real)
    unet = {"in_channels": 4, "out_channels": 4, "block_out_channels": [16, 32],
            "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
            "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "layers_per_block": 1,
            "transformer_layers_per_block": [1, 1], "num_attention_heads": [2, 4],
            "cross_attention_dim": 16, "norm_num_groups": 8, "norm_eps": 1e-05,
            "flip_sin_to_cos": True, "freq_shift": 0, "addition_embed_type": None,
            "addition_time_embed_dim": 8, "projection_class_embeddings_input_dim": 64}
    vae = {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
           "block_out_channels": [8, 8, 16, 16], "layers_per_block": 1,
           "norm_num_groups": 4, "norm_eps": 1e-06, "use_quant_conv": True}
    cfg.update(name=f"tiny-{family}", image_hw=[64, 64], step_count=3,
               check={"images": 3, "group": 2,
                      "limits": {"latent_rel_rms": 1e-3, "pixel_mean_abs": 0.05}})
    cfg["unet"] = {"role": "unet", "class": "UNet2DConditionModel", "preset": None,
                   "dtype": "float32", "config": unet}
    cfg["vae_decoder"] = {"role": "vae_decoder", "class": "VAEDecoder", "preset": None,
                          "dtype": "float32", "config": vae}
    if family == "sd":
        cfg["text_encoders"] = [{"role": "text_encoder", "class": "CLIPTextEncoder",
                                 "preset": None, "dtype": "float32",
                                 "output": "last_hidden_state", "config": _clip(16)}]
    else:
        cfg.update(family="sdxl", latent_scale=0.13025,
                   time_ids=[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0])
        cfg["text_encoders"] = [
            {"role": "text_encoder", "class": "CLIPTextEncoder", "preset": None,
             "dtype": "float32", "output": "penultimate_hidden_state", "config": _clip(8)},
            {"role": "text_encoder2", "class": "CLIPTextEncoder", "preset": None,
             "dtype": "float32", "output": "penultimate_hidden_state",
             "config": _clip(8, proj=True)}]
        unet.update(addition_embed_type="text_time", cross_attention_dim=16,
                    projection_class_embeddings_input_dim=16 + 6 * 8)
    return cfg


def loaded(cell: str, family: str = "sd", traffic: str | None = None, **mix_changes):
    """(bench, cell, cfg, mix) of a cell of BENCHMARK.json, or of a cell of
    the tests' own over the mix file ``traffic``, over the tiny
    configuration of ``family``, its mix changed as given."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if w is None:
        w = {"name": cell, "config": f"tiny-{family}", "traffic": traffic, "chips": 1,
             "why": "a test"}
    mix = json.loads((ROOT / "sdbench/traffic" / f"{w['traffic']}.json").read_text())
    mix.update(mix_changes)
    return bench, w, tiny_config(family), mix


@pytest.fixture
def tiny():
    return tiny_config
