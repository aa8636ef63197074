"""The per-layer readers and the work counts on synthetic events and shapes."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
from conftest import ROOT

from sdbench import run
from sdbench.harness import build, trace, work
from sdbench.harness.record import RunRecord
from sdbench.harness.window import Call, Done
from sdbench.harness.traffic import Request

SD21 = json.loads((ROOT / "sdbench/configs/sd21-base-512.json").read_text())
SDXL = json.loads((ROOT / "sdbench/configs/sdxl-base-1024.json").read_text())
FAMS = trace.families()
SD, XL = build.family("sd"), build.family("sdxl")


def _slice():
    s = trace.Slice(0.0, 10.0, [("void flash_wgmma_bf16<2, 64>(FlashParams)", 1.0, 2.0),
                                ("sm90_xmma_fprop_implicit_gemm_bf16", 1.5, 3.0),
                                ("Memcpy DtoH (Device -> Pageable)", 6.0, 6.5),
                                ("ampere_sgemm_128x64_nn", 9.5, 11.0)])
    s.spans = [("sdbench.generate_images[1]", 0.5, 7.0), ("sdbench.decode", 3.5, 6.0)]
    return s


def test_kernel_families_from_the_pattern_files():
    assert trace.family_of("void flash_wgmma_persistent<2, 40, 2>(PersistParams)", FAMS) \
        == "attention"
    assert trace.family_of("sm90_xmma_fprop_implicit_gemm_bf16bf16", FAMS) == "conv"
    assert trace.family_of("nvjet_hsh_128x256_64x4", FAMS) == "gemm"
    assert trace.family_of("void cudnn::ops::nchwToNhwcKernel<float>", FAMS) == "layout"
    assert trace.family_of("Memset (Device)", FAMS) == "copy"
    assert trace.family_of("some_new_kernel", FAMS) == "other"


def test_busy_idle_and_named_gaps():
    s = _slice()
    assert s.busy_intervals() == [(1.0, 3.0), (6.0, 6.5), (9.5, 10.0)]
    assert s.busy_s == pytest.approx(3.0)
    idle = run.reader("device.idle_share").read(SimpleNamespace(slice=s))
    assert idle == pytest.approx(70.0)
    gaps = dict()
    for name, secs in s.idle_gaps():
        gaps[name] = gaps.get(name, 0.0) + secs
    # 0-1 inside the call; 3-6 inside its decode; 6.5-9.5 between requests
    assert gaps == pytest.approx({"sdbench.generate_images[1]": 1.0, "sdbench.decode": 3.0,
                                  "no benchmark span (between requests)": 3.0})
    assert s.device_time(FAMS) == pytest.approx({"attention": 1.0, "conv": 1.5, "copy": 0.5,
                                                 "gemm": 0.5})


def test_attention_least_time_and_roofline():
    # SD-2.1 at 512x512: 5 self attentions a level at 4096, 1024 and 256
    # tokens (D = 64) a step, the 64-token mid block out; the VAE's one head
    calls = SD.flash_calls(SD21, 1)
    assert calls == [(2, 4096, 5, 64, "bfloat16", 100), (2, 1024, 10, 64, "bfloat16", 100),
                     (2, 256, 20, 64, "bfloat16", 100), (1, 4096, 1, 512, "float32", 1)]
    assert work.least_seconds(2, 4096, 5, 64, "bfloat16") == pytest.approx(
        4 * 2 * 5 * 4096 ** 2 * 64 / 989e12)
    assert work.least_seconds(2, 256, 20, 64, "bfloat16") == pytest.approx(
        4 * 2 * 256 * 20 * 64 * 2 / 3.35e12)  # bandwidth-bound
    least = work.attention_least_seconds(calls)
    assert least == pytest.approx(4.343e-3 + 0.543e-3 + 0.157e-3 + 0.069e-3, rel=0.002)
    # SDXL: 10 calls at 4096 tokens, 60 at 1024 (the mid block's 10 among them)
    assert [(c[1], c[5]) for c in XL.flash_calls(SDXL, 4)] == [(4096, 300), (1024, 1800),
                                                                (16384, 1)]
    s = trace.Slice(0.0, 1.0, [("flash_wgmma_bf16", 0.1, 0.1 + 2 * least)])
    s.spans = [("sdbench.generate_images[1]", 0.0, 0.9)]
    rec = SimpleNamespace(slice=s, cfg=SD21, families=FAMS, family=SD)
    assert run.reader("attention.roofline").read(rec) == pytest.approx(50.0)
    rec.slice = trace.Slice(0.0, 1.0, [])
    assert run.reader("attention.roofline").read(rec) is None  # nothing to read


def test_model_flops_from_shapes():
    f = SD.model_flops(SD21)
    assert 2 * f["unet_sample"] == pytest.approx(1.61e12, rel=0.01)
    assert f["vae_image"] == pytest.approx(2.51e12, rel=0.01)
    g = XL.model_flops(SDXL)
    assert 8 * g["unet_sample"] == pytest.approx(54.1e12, rel=0.01)
    assert g["vae_image"] == pytest.approx(10.47e12, rel=0.01)
    one = work.generation_flops(f, 2, 1, 20)
    assert one == pytest.approx(2 * f["text_row"] + 40 * f["unet_sample"] + f["vae_image"])


def _record(calls, done, start=0.0, end=10.0, **kw):
    return RunRecord(SD21, {}, start, end, done, calls, SD, families=FAMS, **kw)


def test_serving_and_pipeline_readers():
    reqs = [Request(i, "ab cd", 100 + i, 1) for i in range(4)]
    done = [Done(r, sent=float(i), t0=float(i), end=float(i) + 1, result=object())
            for i, r in enumerate(reqs)]
    calls = [Call(0.5, 1.0, 1, 20, (100,), 2), Call(2.0, 3.5, 3, 20, (101, 102, 103), 6)]
    rec = _record(calls, done)
    assert run.reader("serve.batch_mean").read(rec) == pytest.approx(2.0)
    waits = sorted([0.5, 1.0, 0.0, -1.0])  # due at 0, 1, 2, 3; served at 0.5 and 2.0
    from sdbench.harness.traffic import percentile
    assert run.reader("serve.queue_wait_p90_s").read(rec) == pytest.approx(
        percentile(waits, 90))
    assert run.reader("pipeline.ms_per_step").read(rec) == pytest.approx(1e3 * 2.0 / 40)
    f = SD.model_flops(SD21)
    ops = work.generation_flops(f, 2, 1, 20) + work.generation_flops(f, 6, 3, 20)
    assert run.reader("mfu").read(rec) == pytest.approx(100 * ops / (10.0 * 989e12))
    assert run.reader("mfu").read(_record([], [])) is None


def test_end_to_end_readers():
    """images_per_s counts whole completed requests over the window's start
    to the last completion; the latencies run from each request's t0."""
    reqs = [Request(i, "ab cd", 100 + i, 2) for i in range(5)]
    done = [Done(r, sent=float(i), t0=float(i) - 0.5, end=float(i) + 0.5 * (i + 1),
                 result=object() if i != 4 else None) for i, r in enumerate(reqs)]
    rec = _record([], done, start=0.0, end=8.0, setup_s=31.5, peak_bytes=3 * 2**30)
    assert run.reader("images_per_s").read(rec) == pytest.approx(8 / 8.0)
    lat = [1.0, 1.5, 2.0, 2.5, 3.0]
    from sdbench.harness.traffic import percentile
    assert run.reader("serve.latency_p50_s").read(rec) == pytest.approx(2.0)
    assert run.reader("latency_p90_s").read(rec) == pytest.approx(percentile(lat, 90))
    assert run.reader("peak_mem_gib").read(rec) == pytest.approx(3.0)
    assert run.reader("setup_s").read(rec) == 31.5
    assert run.reader("peak_mem_gib").read(_record([], [])) is None  # no card
