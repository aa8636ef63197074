"""Whole runs of the harness: the refusal without a card, the guard against
JAX, and ``correct`` on the CPU at a tiny size, sound and with the timed
path broken underneath (each fault a served model can have on one chip, a
dropped bias and a norm without its scale and shift), and the control, the
program's own lower-precision path, kept apart from sound runs."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
from conftest import ROOT, loaded

from sdbench import run

SEED = 2**31 + 977


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "sdbench/run.py", "--workload", "sd21-serve",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ml_stable_diffusion_tpu_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []  # a longer name is another package
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]


def _run(cell="tiny-single", family="sd", seconds=1.0, trace=False, **mix):
    """A tiny run; ``tiny-single``, a cell of the tests' own, is one client
    asking for single images."""
    return run.run_cell(cell, SEED, seconds, trace, device="cpu",
                        loaded=loaded(cell, family, traffic="closed-single", **mix))[0]


@pytest.mark.parametrize("cell,family", [("tiny-single", "sd"), ("sdxl-grid4", "sdxl"),
                                         ("sd21-serve", "sd")])
def test_sound_runs_are_correct(cell, family):
    result = _run(cell, family, trace=True, rate_per_s=30.0)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 3
    assert list(result)[-1] == "check" and result["device"]["window_s"] > 0


def _serve_merged(monkeypatch):
    """A tiny serving run whose every image is checked, at a rate that
    merges requests."""
    b, w, cfg, mix = loaded("sd21-serve", "sd", rate_per_s=60.0)
    cfg["check"]["images"] = 10**6
    return run.run_cell("sd21-serve", SEED, 1.0, False, device="cpu",
                        loaded=(b, w, cfg, mix))[0]


def test_fault_step_returns_its_state_unchanged(monkeypatch):
    from ml_stable_diffusion_torch.schedulers.dpm_solver import DPMSolverMultistepScheduler

    monkeypatch.setattr(DPMSolverMultistepScheduler, "step",
                        lambda self, plan, state, out, i, sample, noise=None: (state, sample))
    result = _run()
    assert not result["correct"] and result["check"]["latent_rel_rms"]["value"] > 0.1


def test_fault_half_of_a_merged_batch_left_out(monkeypatch):
    from ml_stable_diffusion_torch.serving import GenerationServer

    merged = []
    real = GenerationServer._run_batch

    def half(self, batch):
        result = real(self, batch)
        n = len(batch)
        if n > 1:  # the second half gets the first half's images
            merged.append(n)
            keep = (n + 1) // 2
            for i in range(keep, n):
                result.images[i] = result.images[i - keep]
                result.latents[i] = result.latents[i - keep]
        return result

    monkeypatch.setattr(GenerationServer, "_run_batch", half)
    result = _serve_merged(monkeypatch)
    assert merged and not result["correct"]
    assert result["check"]["latent_rel_rms"]["value"] > 0.1


def test_fault_an_image_altered_where_it_is_produced(monkeypatch):
    from ml_stable_diffusion_torch.pipelines.sd import StableDiffusionPipeline

    real = StableDiffusionPipeline.decode_latents

    def altered(self, latents, cfg=None):
        images = real(self, latents, cfg).copy()
        images[:, :8, :8] = 255 - images[:, :8, :8]
        return images

    monkeypatch.setattr(StableDiffusionPipeline, "decode_latents", altered)
    result = _run()
    pixel = result["check"]["pixel_mean_abs"]
    assert not result["correct"] and pixel["value"] > 10 * pixel["limit"]
    assert result["check"]["latent_rel_rms"]["value"] <= 1e-3


def test_fault_a_token_altered_where_it_is_produced(monkeypatch):
    from ml_stable_diffusion_torch.tokenizer import CLIPTokenizer

    real = CLIPTokenizer.encode
    monkeypatch.setattr(CLIPTokenizer, "encode", lambda self, text: real(self, text)[:-1])
    result = _run()
    assert not result["correct"] and result["check"]["latent_rel_rms"]["value"] > 1e-3


def _planted(after_build):
    """A tiny single-image run with ``after_build`` applied to the program's
    pipeline alone (the reference builds its own modules afterwards)."""
    return run.run_cell("tiny-single", SEED, 1.0, False, device="cpu",
                        loaded=loaded("tiny-single", "sd", "closed-single"),
                        after_build=after_build)[0]


@pytest.mark.parametrize("where", ["down_blocks.0.resnets.0.conv1", "conv_out"])
def test_fault_a_conv_bias_dropped(where):
    result = _planted(lambda pipe: pipe.unet.get_submodule(where).bias.data.zero_())
    assert not result["correct"] and result["check"]["latent_rel_rms"]["value"] > 1e-2


@pytest.mark.parametrize("where", ["down_blocks.0.resnets.0.norm1",
                                   "down_blocks.0.attentions.0.norm"])
def test_fault_a_groupnorm_ignores_its_scale_and_shift(where):
    def plain(pipe):
        norm = pipe.unet.get_submodule(where)
        norm.weight.data.fill_(1.0)
        norm.bias.data.zero_()

    result = _planted(plain)
    assert not result["correct"] and result["check"]["latent_rel_rms"]["value"] > 1e-2


def test_the_control_reads_far_above_sound_runs():
    """At a tiny size with the denoiser stated in bfloat16: the program's
    sound readings, and the program with its own lower-precision path on
    (W8A8 over every Linear and Conv2d the tiny denoiser has, calibrated),
    on the same seed."""
    import torch

    from sdbench.readings import program_control

    b, w, cfg, mix = loaded("tiny-single", "sd", "closed-single")
    cfg["unet"]["dtype"] = "bfloat16"
    sound, _ = run.run_cell("tiny-single", SEED, 1.0, False, device="cpu",
                            loaded=(b, w, cfg, mix))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        control, _ = run.run_cell("tiny-single", SEED, 1.0, False, device="cpu",
                                  loaded=(b, w, cfg, mix),
                                  after_build=program_control(cfg, mix, SEED, min_size=0))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    low = sound["check"]["latent_rel_rms"]["value"]
    high = control["check"]["latent_rel_rms"]["value"]
    assert np.isfinite(low) and np.isfinite(high) and high > 3 * low


@pytest.mark.cuda
def test_the_program_control_fails_at_the_cells_size():
    """On the card: the program with its own lower-precision path (W8A8
    denoiser, TF32 float32 modules) at each cell's size, on three
    seeds, comes out not correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cells = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
    for cell in cells:
        p = subprocess.run([sys.executable, "sdbench/readings.py", "--workload", cell,
                            "--seeds", "11,12,13", "--seconds", "10", "--mode", "control"],
                           cwd=ROOT, capture_output=True, text=True, timeout=1800)
        assert p.returncode == 0, p.stderr[-2000:]
        lines = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
        assert len(lines) == 3 and not any(x["correct"] for x in lines)
