"""The SD3 family (``sdbench/families/sd3.py``, the sd35m-single cell): the
configuration against the port's presets and the reference's parameters
at full width, on the meta device; a tiny run on the CPU, sound and with
the timed path broken underneath (a dual block's attn2 left out, T5's
states left out); the flash calls' least time against figures worked by
hand; and the four readers the cells add, on synthetic records."""

from __future__ import annotations

import copy
import json
from types import SimpleNamespace

import pytest
import torch
from conftest import ROOT, _clip

from sdbench import run
from sdbench.harness import build, trace, work
from sdbench.harness.record import RunRecord
from sdbench.harness.traffic import Request
from sdbench.harness.window import Call, Done
from sdbench.reference import mmdit as ref_mmdit
from sdbench.reference import weights

SD35 = json.loads((ROOT / "sdbench/configs/sd35-medium-1024.json").read_text())
SD3 = build.family("sd3")
FAMS = trace.families()
SEED = 2**31 + 4099


def tiny_sd3() -> dict:
    """sd35-medium-1024 at a size the CPU runs in seconds: 64x64, 3 steps,
    float32 throughout, two dual blocks of three."""
    cfg = copy.deepcopy(SD35)
    cfg.update(name="tiny-sd3", image_hw=[64, 64], step_count=3,
               check={"images": 3, "group": 2,
                      "limits": {"latent_rel_rms": 1e-3, "pixel_mean_abs": 0.05}})
    cfg["text_encoders"] = [
        dict(e, preset=None, config=_clip(8, proj=i == 1))
        for i, e in enumerate(SD35["text_encoders"])]
    cfg["t5"] = dict(cfg["t5"], preset=None, dtype="float32", config=dict(
        vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_layers=2, num_heads=4,
        relative_attention_num_buckets=32, relative_attention_max_distance=128,
        layer_norm_eps=1e-6))
    cfg["mmdit"] = dict(cfg["mmdit"], preset=None, dtype="float32", config=dict(
        patch_size=2, in_channels=16, out_channels=16, depth=3, hidden_size=32, num_heads=4,
        context_dim=16, pooled_dim=8 + 16, pos_embed_max_size=8, qk_norm=True,
        dual_attention_layers=[0, 1]))
    cfg["vae_decoder"] = dict(cfg["vae_decoder"], preset=None, config=dict(
        in_channels=3, out_channels=3, latent_channels=16, block_out_channels=[8, 8, 16, 16],
        layers_per_block=1, norm_num_groups=4, norm_eps=1e-6, use_quant_conv=False))
    return cfg


def _run(trace_on=False, after_build=None):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == "sd35m-single")
    mix = json.loads((ROOT / "sdbench/traffic/closed-single.json").read_text())
    return run.run_cell("sd35m-single", SEED, 1.0, trace_on, device="cpu",
                        loaded=(bench, cell, tiny_sd3(), mix), after_build=after_build)[0]


@pytest.mark.parametrize("kind", ["clip", "t5", "mmdit", "vae_decoder"])
def test_full_width_modules_match_presets_and_reference(kind):
    """Every number the file states is the port's preset's, and the port's
    module has the reference's parameters (names and shapes), at full width
    on the meta device."""
    import importlib

    specs = {"clip": SD35["text_encoders"], "t5": [SD35["t5"]], "mmdit": [SD35["mmdit"]],
             "vae_decoder": [SD35["vae_decoder"]]}[kind]
    mod_name, _, mod_cls = SD3.KINDS[kind]
    for spec in specs:
        with torch.device("meta"):
            port = getattr(importlib.import_module(mod_name), mod_cls)(
                build.port_config(kind, spec, SD3.KINDS))
            ref = ref_mmdit.build(kind, spec["config"])
        assert weights.spec(port) == weights.spec(ref)
    if kind == "mmdit":
        assert sum(p.numel() for p in port.parameters()) == 2_469_663_936


def test_family_has_what_the_readers_ask():
    assert all(callable(getattr(SD3, f)) for f in
               ("pipeline", "reference", "model_flops", "flash_calls", "joint_least_seconds"))
    assert SD35["reduced"] == [] and SD35["family"] == "sd3"
    assert SD35["check"]["limits"]["latent_rel_rms"] is not None


def test_sound_tiny_run_is_correct_and_reports_its_metrics():
    result = _run(trace_on=True)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 3
    assert result["check"]["latent_rel_rms"]["value"] < 1e-5
    m = result["metrics"]
    assert m["mmdit.mfu"]["value"] > 0 and m["serve.send_to_start_ms"]["value"] > 0
    assert m["mmdit.idle_share"]["value"] == pytest.approx(100.0)  # no card: no device event
    assert "mmdit.attention.roofline" not in m  # no attention kernel ran


def test_fault_dual_block_without_attn2():
    def drop(pipe):
        with torch.no_grad():
            pipe.unet.transformer_blocks[1].attn2.to_out[0].weight.zero_()
            pipe.unet.transformer_blocks[1].attn2.to_out[0].bias.zero_()

    result = _run(after_build=drop)
    assert not result["correct"] and result["check"]["latent_rel_rms"]["value"] > 1e-2


def test_fault_t5_states_left_out():
    def drop(pipe):
        pipe.t5_encoder = None  # the pipeline's zero T5 block

    result = _run(after_build=drop)
    assert not result["correct"] and result["check"]["latent_rel_rms"]["value"] > 1e-2


def test_flash_least_time_against_hand_worked_figures():
    """sd35-medium-1024, one image: CFG batch 2, 24 heads of 64 in bf16."""
    calls = SD3.flash_calls(SD35, 1)
    # 13 dual blocks x 40 steps of attn2 over the 4096 latent tokens, the
    # VAE's one f32 head over 128 x 128
    assert calls == [(2, 4096, 24, 64, "bfloat16", 520), (1, 16384, 1, 512, "float32", 1)]
    # attn2: 4 B H S^2 D = 4 * 2 * 24 * 4096^2 * 64 = 2.0616e11 operations,
    # 0.20845 ms at 989 TFLOP/s (its 100.7 MB at 3.35 TB/s take 0.030 ms)
    assert work.least_seconds(2, 4096, 24, 64, "bfloat16") == pytest.approx(2.0845e-4,
                                                                             rel=1e-4)
    # a joint call: 4096 + 154 query rows over 4250 keys: 4 * 2 * 24 * 4250^2
    # * 64 = 2.2195e11 operations, 0.22442 ms; 24 blocks x 40 steps
    assert SD3.joint_least_seconds(SD35, 1) == pytest.approx(2.2442e-4 * 960, rel=1e-4)
    assert SD3.joint_least_seconds(SD35, 2) == pytest.approx(
        2 * SD3.joint_least_seconds(SD35, 1))


def test_model_flops_from_shapes():
    f = SD3.model_flops(SD35)
    # the MMDiT-X sample: 1.08e13, of it attention 24 joint calls over 4250
    # keys and 13 self calls over 4096, 4.0e12
    assert f["unet_sample"] == pytest.approx(1.0783e13, rel=1e-3)
    attention = 24 * 4 * 24 * 4250 ** 2 * 64 + 13 * 4 * 24 * 4096 ** 2 * 64
    assert attention / f["unet_sample"] == pytest.approx(0.37, abs=0.01)
    assert f["vae_image"] == pytest.approx(10.47e12, rel=0.01)  # SDXL's decoder at 1024^2
    assert f["text_row"] == pytest.approx(8.27e11, rel=0.01)  # T5-XXL's 77 tokens most of it


def _sd3_record(calls, done, start=0.0, end=10.0, **kw):
    return RunRecord(SD35, {}, start, end, done, calls, SD3, families=FAMS, **kw)


def test_the_four_readers_on_synthetic_records():
    reqs = [Request(i, "ab cd", 100 + i, 1) for i in range(3)]
    done = [Done(r, sent=2.0 * i, t0=2.0 * i, end=2.0 * i + 1.9, result=object())
            for i, r in enumerate(reqs)]
    calls = [Call(2.0 * i + 0.010 + 0.002 * i, 2.0 * i + 1.8, 1, 40, (100 + i,), 2)
             for i in range(3)]
    rec = _sd3_record(calls, done, end=6.0, profiler_s=0.5)
    assert run.reader("serve.send_to_start_ms").read(rec) == pytest.approx(12.0)
    f = SD3.model_flops(SD35)
    ops = 3 * work.generation_flops(f, 2, 1, 40)
    assert run.reader("mmdit.mfu").read(rec) == pytest.approx(100 * ops / (5.5 * 989e12))
    least = SD3.joint_least_seconds(SD35, 1) + work.attention_least_seconds(
        SD3.flash_calls(SD35, 1))
    s = trace.Slice(0.0, 10.0, [
        ("void flash_attention_multi_q_fwd<64>(Params)", 1.0, 1.0 + least),
        ("void flash_wgmma_bf16<2, 64>(FlashParams)", 2.0, 2.0 + least),
        ("nvjet_hsh_128x256_64x4", 3.0, 8.0),
        ("void flash_wgmma_bf16<2, 64>(FlashParams)", 9.5, 9.6)])  # outside the call
    s.spans = [("sdbench.generate_images[1]", 0.5, 9.0), ("sdbench.decode", 8.5, 9.0)]
    rec.slice = s
    assert run.reader("mmdit.attention.roofline").read(rec) == pytest.approx(50.0)
    assert run.reader("mmdit.idle_share").read(rec) == pytest.approx(
        100.0 * (1.0 - (2 * least + 5.0 + 0.1) / 10.0))
    # nothing to read: no record, no attention kernel, a family without joint calls
    empty = _sd3_record([], [])
    assert [run.reader(n).read(empty) for n in ("serve.send_to_start_ms", "mmdit.mfu",
                                                "mmdit.attention.roofline",
                                                "mmdit.idle_share")] == [None] * 4
    rec.slice = trace.Slice(0.0, 10.0, [("nvjet_hsh_128x256_64x4", 3.0, 8.0)])
    rec.slice.spans = s.spans
    assert run.reader("mmdit.attention.roofline").read(rec) is None
    rec.slice, rec.family = s, SimpleNamespace(flash_calls=SD3.flash_calls)
    assert run.reader("mmdit.attention.roofline").read(rec) is None
