#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ml_stable_diffusion_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card; without one, or without the repository around it, it
exits non-zero and prints no result.  Phases, each fatal on failure:

1. Environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, the TF32 settings; build every kernel from csrc/, print ptxas's
   register use and any wgmma it had to serialise, and count the HGMMA
   (wgmma) instructions in the SASS of the flash and dequant-matmul
   libraries (``cuobjdump -sass``; 0 fails the run).
2. Every kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it plus ragged ones, with timings of the kernel (CUDA
   events and the profiler's device time per launch), the plain version and
   one PyTorch library call computing the same function; beside each row
   the flash tile instantiation or the dequant-matmul's launch plan.  The
   GroupNorm+SiLU shapes are recorded from the SDXL base and refiner UNets
   themselves.
3. The main path at full width: SD-2.1-base 512x512 txt2img, 20 steps of
   DPM-Solver++(2M), CFG batch 2, guidance 7.5, through
   ``StableDiffusionPipeline.generate_images`` with random weights from a
   seeded generator.  One warm-up, then the median of 3 generations with
   distinct prompts and seeds.  Kernel launch counts are read around it.
4. One full-width UNet forward with variance-preserving weights, with the
   attention dispatch on the flash kernel and then forced to the plain path:
   the kernel's check inside the model (phase 3's speed weights leave the
   attention nearly uniform).
5. The SD3 path at full width and depth: SD3-medium 1024x1024 txt2img
   without T5 (a zero T5 block), 20 steps of DiscreteFlow (shift 3), CFG
   batch 2, guidance 4.5, through ``StableDiffusion3Pipeline.generate_images``
   (CLIP-L and bigG in float32, the MMDiT in bf16, the 16-channel VAE in
   float32), as phase 3 does for SD-2.1: warm-up, median of 3, launch counts
   of both kernel entries, then one generation forced to the plain path.
6. One full-width MMDiT forward with variance-preserving weights, on the
   multi-stream kernel and then forced plain (the SD3 counterpart of phase 4).
7. The SDXL path at full width and depth: SDXL-base 1024x1024 txt2img, 20
   steps of DPM-Solver++(2M), CFG batch 2, guidance 5.0, through
   ``StableDiffusionXLPipeline.generate_images`` (CLIP-L and bigG in float32,
   the UNet in bf16 with ``fused_groupnorm=True``, the VAE in float32), as
   phase 3: warm-up, median of 3, launch counts, one generation forced to
   plain attention.  Then base + refiner (``UNetConfig.sdxl_refiner``, also
   fused, ``refiner_start=0.8``: 16 base and 4 refiner steps): a warm-up and
   one timed generation, its launch counts read around both.
8. One full-width SDXL base UNet forward with variance-preserving weights:
   the fused GroupNorm+SiLU kernel against a second UNet on ``nn.GroupNorm``
   with the same state dict, and the flash kernel against plain attention.
9. The palettized path at full width and depth, as ``bench.py``'s
   ``bench_palettized6`` runs it: the SD-2.1 UNet and CLIP-H palettized at 6
   bits on the card (``compress.palettize_tree``), saved with the dense VAE
   decoder as an artifact bundle (``convert.artifacts.save_module``),
   loaded by ``convert.load.load_pipeline_from_artifacts`` (install mode),
   then generated from as phase 3 does, first in install mode, then with the
   same UNet in program mode.  Checks: on-disk bytes against fp16, installed
   weights equal bit for bit to the dequantized bf16 in both modes, 301
   flash launches and none of the fused dequant-matmul per generation,
   install against program against a pipeline handed the dequantized
   weights directly (latents), and the peak device memory of each mode.
10. The fused dequant-matmul's in-model witness (no generation path runs
   it, as in the JAX package): every palettizable ``nn.Linear`` of one
   full-width palettized SD-2.1 UNet call, variance-preserving weights, on
   ``palettized_dense_fused``, against the same UNet serving the
   dequantized weights (install mode): PSNR beside its prediction, and the
   launch count against the recorded call list.

Every kernel launch counter is set to 0 just before each main path (phases
3, 5, both runs of 7, both modes of 9, and phase 10 for the fused
dequant-matmul, whose main path it is) and read just after it.  Prints a
``{"kernels": [...]}`` JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile sdxl   (or sd3, sd21)

runs instead one generation of that path under ``torch.profiler`` after a
warm-up and prints where the device time goes: the kernels grouped (the
GroupNorm and flash kernels, matrix products, convolutions, the rest), the
top kernels by device time, and the device's busy share of the generation's
wall time.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

#: H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 FMA units,
#: HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
#: max-abs tolerance of a kernel against its plain version
#: (tests/test_pallas_kernels.py's)
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: relative RMS tolerance, ||got - ref|| / ||ref||, held as well: with
#: unit-normal q, k, v over 4096 keys the output is itself ~2e-2, of the
#: order of the bf16 ATOL, so ATOL alone would pass a dropped KV tile
#: (which moves it by ~1e-1); f32 leaves room for the FMA kernel's own
#: summation order over 4096 keys
REL_RMS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
#: keys the dropped-tile witness leaves out: 64, half of the bf16 kernel's
#: 128-row kv tile and the FMA kernel's whole tile (csrc/flash_attention.cu)
KV_TILE = 64
STEPS = 20
PROMPTS = ["a photo of an astronaut riding a horse on mars",
           "a cat wearing a tiny hat", "a watercolor bridge at dawn",
           "a robot reading in a library"]
#: the main paths: what each generation must launch of each kernel entry
#: (palettized_dense_fused: none, the pipelines serve palettized weights
#: dequantized; phase 10 is its witness)
#: (flash_attention: SD-2.1 15 per UNet call, 5 each at 4096, 1024 and 256
#: tokens, x 20 steps, plus the VAE mid block; SDXL base 70 per UNet call,
#: 10 at 4096 and 60 at 1024 tokens, and the refiner 41, 20 at 4096, 20 at
#: 1024 and 1 at 256, plus the VAE mid block; flash_attention_multi_q: one
#: joint attention per MMDiT block, 24 x 20 steps; group_norm_silu: one per
#: resnet GroupNorm+SiLU, 34 per SDXL base UNet call and 44 per refiner call)
PATHS = {
    "sd21": dict(label="SD-2.1-base 512x512, 20 steps DPM++ 2M, CFG batch 2",
                 image_hw=(512, 512), latents=(1, 64, 64, 4), guidance=7.5,
                 scheduler="DPMSolverMultistep",
                 per_generation={"flash_attention": 301, "flash_attention_multi_q": 0,
                                 "group_norm_silu": 0, "palettized_dense_fused": 0}),
    "sd3": dict(label="SD3-medium 1024x1024 (no T5), 20 steps DiscreteFlow, CFG batch 2",
                image_hw=(1024, 1024), latents=(1, 128, 128, 16), guidance=4.5,
                scheduler="DiscreteFlow",
                per_generation={"flash_attention": 1, "flash_attention_multi_q": 480,
                                "group_norm_silu": 0, "palettized_dense_fused": 0}),
    "sdxl": dict(label="SDXL-base 1024x1024, 20 steps DPM++ 2M, CFG batch 2, guidance 5",
                 image_hw=(1024, 1024), latents=(1, 128, 128, 4), guidance=5.0,
                 scheduler="DPMSolverMultistep",
                 per_generation={"flash_attention": 1401, "flash_attention_multi_q": 0,
                                 "group_norm_silu": 680, "palettized_dense_fused": 0}),
    "sdxl_refiner": dict(label="SDXL base + refiner 1024x1024, refiner_start 0.8 "
                               "(16 + 4 steps DPM++ 2M), CFG batch 2, guidance 5",
                         image_hw=(1024, 1024), latents=(1, 128, 128, 4), guidance=5.0,
                         scheduler="DPMSolverMultistep", extra=dict(refiner_start=0.8),
                         per_generation={"flash_attention": 1285,
                                         "flash_attention_multi_q": 0,
                                         "group_norm_silu": 720, "palettized_dense_fused": 0}),
}
#: phase 9: the SD-2.1 path on a palettized bundle, in each serving mode
for _mode in ("install", "program"):
    PATHS[f"sd21_pal_{_mode}"] = dict(
        PATHS["sd21"], label=f"SD-2.1-base 512x512 from a 6-bit palettized bundle, {_mode} "
                             "mode, 20 steps DPM++ 2M, CFG batch 2")
#: steps of each UNet in one generation of a path: (base, refiner)
UNET_STEPS = {"sdxl": (STEPS, 0), "sdxl_refiner": (16, 4)}
#: the attention kernel entries (phase 7's plain-attention run launches none)
ATTENTION_KERNELS = ("flash_attention", "flash_attention_multi_q")
#: bf16-level agreement of a full denoiser call, flash kernel vs plain attention
MODEL_MIN_PSNR_DB = 30.0
#: relative max-abs agreement of 20-step latents, flash vs plain generation
GEN_MAX_REL_ERR = 2e-2
#: GroupNorm+SiLU kernel against its plain version: max abs (bf16:
#: tests/test_pallas_kernels.py's) and relative RMS.  With per-channel
#: offsets and scales in the inputs, statistics that left out a group's last
#: channel move the output by rel RMS >= 6e-3 at the refiner's 96 channels a
#: group (the least sensitive shape; the inputs are seeded, so every run
#: reads the same) and far more at fewer channels: these bounds see it
GN_ATOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
GN_REL_RMS = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
#: f32 operations per element of the GroupNorm+SiLU function: sum and square
#: sum (3), normalise, scale and shift (4), SiLU (exp, add, divide, ~4)
GN_OPS_PER_ELEMENT = 11
#: libraries whose bf16 kernels run on wgmma (phase 1 counts its HGMMA
#: instructions in the SASS)
WGMMA_LIBS = ("libflash_attention", "libpalettized_matmul")
#: the palettized path's bit width (bench.py bench_palettized6)
PAL_NBITS = 6
#: fused dequant-matmul against its plain version: max abs
#: (tests/test_pallas_kernels.py's; the inputs give outputs of order 1, so
#: one bf16 rounding step of the largest is 3e-2) and relative RMS.  A k
#: tile (64 deep) left out moves the output by rel RMS >= sqrt(64/5120) =
#: 0.11 at the deepest SD-2.1 shape: the witness shows it per shape
PAL_ATOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
PAL_REL_RMS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
#: depth of one k tile of the bf16 kernel (csrc/palettized_matmul.cu kBK;
#: ops/palettized.py K_TILE)
PAL_K_TILE = 64
#: palettizable nn.Linear calls per SD-2.1 UNet call at 512x512, CFG batch 2
#: (kernel_bounds.linear_calls)
PAL_CALLS_PER_UNET = 216
#: the fused op against install mode in one full-width UNet call
PAL_MIN_PSNR_DB = 40.0
#: its PSNR as predicted before the split-K kernel's first full run (PERF.md
#: §6): the bias's double rounding dominates, as at the unsplit kernel's
#: 48.15 dB
PAL_PREDICTED_PSNR_DB = (46.0, 49.0)
#: latents of install mode, program mode and dense weights handed directly
PAL_LATENTS_REL_ERR = 1e-3


def log(*args):
    print(*args, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def hgmma_counts(libs):
    """-> {library file: wgmma (HGMMA) instructions in its SASS} by
    ``cuobjdump -sass``, or None when the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    counts = {}
    for lib in libs:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        counts[lib.name] = sum("HGMMA" in line for line in sass.splitlines())
    return counts


def time_ms(fn, reps: int, windows: int = 5) -> float:
    """Median over ``windows`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


# -- phase 2 -------------------------------------------------------------------

def abs_and_rel_rms(got, ref):
    """-> (max |got - ref|, ||got - ref|| / ||ref||) in float32."""
    diff = got.float() - ref.float()
    return diff.abs().max().item(), (diff.norm() / ref.float().norm()).item()


def _device_ms_split(fns, calls):
    """Device ms per call of each ``fns[i]`` (``calls[i]`` calls in turn, each
    row after a ``torch.cuda._sleep`` marker kernel), or None when the
    profiler's record lacks a marker or a row's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn, n in zip(fns, calls):
            torch.cuda._sleep(1)
            for _ in range(n):
                fn()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(kernels) if "spin_kernel" in e.name]
    if len(marks) != len(fns) + 1 or any(b == a + 1 for a, b in zip(marks, marks[1:])):
        return None
    return [sum(e.time_range.elapsed_us() for e in kernels[a + 1:b]) / 1e3 / n
            for n, a, b in zip(calls, marks, marks[1:])]


def add_device_ms(rows, fns_by_key, tries=3):
    """Set, for each ``key: fns`` of ``fns_by_key``, each row's ``key`` to
    the profiler's device time of its call ``fns[i]``, per call: the sum of
    every kernel the call launches.  At shapes where a CUDA-event loop of
    back-to-back calls measures the host's issue rate (~0.05 ms and less),
    this still reads the device.  One profiler session per key for all rows
    (the card's profiler stopped recording after ~50 short sessions), split
    at marker kernels; a session whose record lost events is run again, and
    after ``tries`` the rows read None ("not measured")."""
    calls = [3 if r["bound_ms"] > 1.0 else 10 for r in rows]
    for key, fns in fns_by_key.items():
        for attempt in range(1, tries + 1):
            got = _device_ms_split(fns, calls)
            if got is not None:
                break
            log(f"{key}: the profiler's record lost events (try {attempt} of {tries})")
        for row, ms in zip(rows, got or [None] * len(rows)):
            row[key] = ms


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def total(values):
    """Sum, or None when a term was not measured."""
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


def timings(kernel, plain, library, bound_s):
    """ms per call of the kernel (CUDA events), the plain version and the
    library call; fewer repetitions past 1 ms of bound."""
    slow = bound_s > 1e-3
    return dict(ms=time_ms(kernel, reps=3 if slow else 20),
                plain_ms=time_ms(plain, reps=1 if slow else 3),
                library_ms=time_ms(library, reps=3 if slow else 20))


def sd21_all(n):
    """Launches per generation of the SD-2.1 path and its palettized runs."""
    return {"sd21": n, "sd21_pal_install": n, "sd21_pal_program": n}


#: (label, query stream lengths, Sk, B, H, D, dtype, {path: launches per
#: generation of that path})
FLASH_SHAPES = [
    ("unet 64x64", (4096,), 4096, 2, 5, 64, torch.bfloat16, sd21_all(100)),
    ("unet 32x32", (1024,), 1024, 2, 10, 64, torch.bfloat16, sd21_all(100)),
    ("unet 16x16", (256,), 256, 2, 20, 64, torch.bfloat16, sd21_all(100)),
    ("vae mid 512", (4096,), 4096, 1, 1, 512, torch.float32, sd21_all(1)),
    ("vae mid 1024", (16384,), 16384, 1, 1, 512, torch.float32,
     {"sd3": 1, "sdxl": 1, "sdxl_refiner": 1}),
    ("sdxl 64x64", (4096,), 4096, 2, 10, 64, torch.bfloat16,
     {"sdxl": 10 * 20, "sdxl_refiner": 10 * 16}),
    ("sdxl 32x32", (1024,), 1024, 2, 20, 64, torch.bfloat16,
     {"sdxl": 60 * 20, "sdxl_refiner": 60 * 16}),
    ("refiner 64x64", (4096,), 4096, 2, 12, 64, torch.bfloat16, {"sdxl_refiner": 20 * 4}),
    ("refiner 32x32", (1024,), 1024, 2, 24, 64, torch.bfloat16, {"sdxl_refiner": 20 * 4}),
    ("refiner 16x16", (256,), 256, 2, 24, 64, torch.bfloat16, {"sdxl_refiner": 1 * 4}),
    ("ragged f32", (330,), 330, 2, 3, 64, torch.float32, {}),
    ("ragged bf16", (330,), 330, 2, 3, 64, torch.bfloat16, {}),
]
MULTI_Q_SHAPES = [
    ("sd3 joint 1024", (4096, 154), 4250, 2, 24, 64, torch.bfloat16, {"sd3": 480}),
    ("ragged f32", (384, 77), 461, 2, 3, 64, torch.float32, {}),
    ("ragged bf16", (384, 77), 461, 2, 3, 64, torch.bfloat16, {}),
]


def check_shape_launches(name, rows):
    """The rows' launches on each path add up to the path's count."""
    for path, spec in PATHS.items():
        got = sum(r["launches_per_generation"].get(path, 0) for r in rows)
        if got != spec["per_generation"][name]:
            fail(f"{name}: phase 2 rows launch {got} times on {path}, "
                 f"the path launches {spec['per_generation'][name]}")


def check_kernel(kernel, reference, shapes):
    """Each shape: the kernel against its plain version (max abs and
    relative RMS), what a dropped last KV tile would show, and the times of
    the kernel, the plain version and SDPA on the concatenated queries."""
    import torch.nn.functional as F

    from ml_stable_diffusion_torch.ops.flash_attention import query_tile_rows

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, calls, libraries = [], [], []
    for label, q_lens, sk, B, H, D, dtype, per_gen in shapes:
        def rand(s):
            return torch.randn((B, s, H, D), generator=gen, device="cuda").to(dtype)

        qs = [rand(n) for n in q_lens]
        k, v = rand(sk), rand(sk)
        out = torch.cat(kernel(qs, k, v), dim=1)
        torch.cuda.synchronize()
        ref = torch.cat(reference(qs, k, v), dim=1).float()
        err, rel = abs_and_rel_rms(out, ref)
        if not (math.isfinite(err) and err <= ATOL[dtype] and rel <= REL_RMS[dtype]):
            fail(f"{label}: kernel disagrees with its plain version at q {q_lens} over "
                 f"{sk} keys {dtype}: max abs err {err} (atol {ATOL[dtype]}), rel RMS "
                 f"err {rel} (tol {REL_RMS[dtype]})")
        # what the check would see from a kernel that skipped the last KV tile
        cut = torch.cat(reference(qs, k[:, :-KV_TILE], v[:, :-KV_TILE]), dim=1)
        cut_err, cut_rel = abs_and_rel_rms(cut, ref)
        if cut_rel <= REL_RMS[dtype]:
            fail(f"{label}: the check cannot tell a dropped KV tile: "
                 f"rel RMS {cut_rel} <= {REL_RMS[dtype]}")
        # every q and k/v read once, every output written once
        nbytes = (2 * sum(q_lens) + 2 * sk) * B * H * D * qs[0].element_size()
        flops = 4 * B * H * sum(q_lens) * sk * D
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        qt = torch.cat(qs, dim=1).transpose(1, 2)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        # the bf16 D = 64 kernel's instantiation: query rows a block
        tile = (f"wgmma {query_tile_rows(q_lens, B, H)}-row" if dtype == torch.bfloat16 and D == 64
                else "fma")
        row = dict(label=label, q_lens=list(q_lens), sk=sk, B=B, H=H, D=D,
                   dtype=str(dtype).split(".")[-1], tile=tile, launches_per_generation=per_gen,
                   max_abs_err=err, atol=ATOL[dtype], rel_rms_err=rel,
                   rel_rms_tol=REL_RMS[dtype], dropped_tile_max_abs=cut_err,
                   dropped_tile_rel_rms=cut_rel,
                   **timings(functools.partial(kernel, qs, k, v), lambda: reference(qs, k, v),
                             functools.partial(F.scaled_dot_product_attention, qt, kt, vt),
                             max(t_bytes, t_ops)),
                   bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        rows.append(row)
        calls.append(functools.partial(kernel, qs, k, v))
        libraries.append(functools.partial(F.scaled_dot_product_attention, qt, kt, vt))
    add_device_ms(rows, {"device_ms": calls, "library_device_ms": libraries})
    for row in rows:
        label, q_lens, sk, err, rel = (row[key] for key in ("label", "q_lens", "sk",
                                                             "max_abs_err", "rel_rms_err"))
        B, H, D, dtype = row["B"], row["H"], row["D"], getattr(torch, row["dtype"])
        cut_err, cut_rel = row["dropped_tile_max_abs"], row["dropped_tile_rel_rms"]
        log(f"{label:15s} q {list(q_lens)} k {sk} B{B} H{H} D{D} {row['dtype']:8s} "
            f"[{row['tile']}] "
            f"err {err:.3g} (atol {ATOL[dtype]}) rel RMS {rel:.3g} (tol {REL_RMS[dtype]}; "
            f"a dropped KV tile: {cut_err:.3g} abs, {cut_rel:.3g} rel) kernel "
            f"{row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])})  plain "
            f"{row['plain_ms']:.4f} ms  sdpa {row['library_ms']:.4f} ms (device "
            f"{fmt_ms(row['library_device_ms'])})  bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def gn_shapes():
    """(label, (B, C, H, W), dtype, apply_silu, {path: launches per
    generation}) for every resnet GroupNorm+SiLU shape of the SDXL base and
    refiner UNets at 1024x1024, CFG batch 2 (recorded from the port's UNets
    on the meta device by kernel_bounds.py), plus ragged ones."""
    from kernel_bounds import gn_calls
    from ml_stable_diffusion_torch.models.unet import UNetConfig

    base = gn_calls(UNetConfig.sdxl(), (128, 128), 2048, n_time_ids=6)
    refiner = gn_calls(UNetConfig.sdxl_refiner(), (128, 128), 1280, n_time_ids=5)
    if (sum(base.values()), sum(refiner.values())) != (34, 44):
        fail(f"SDXL UNets make {sum(base.values())} / {sum(refiner.values())} "
             "GroupNorm+SiLU calls, want 34 / 44")
    rows = []
    for shape in sorted(set(base) | set(refiner), key=lambda s: (s[2], s[1])):
        per_gen = {}
        for path, (n_base, n_ref) in UNET_STEPS.items():
            n = n_base * base[shape] + n_ref * refiner[shape]
            if n:
                per_gen[path] = n
        who = "+".join(w for w, c in (("base", base), ("refiner", refiner)) if c[shape])
        rows.append((f"{who} {shape[1]}@{shape[2]}x{shape[3]}", shape, torch.bfloat16, True,
                     per_gen))
    rows += [("ragged f32", (2, 96, 7, 9), torch.float32, True, {}),
             ("ragged bf16", (2, 96, 7, 9), torch.bfloat16, True, {}),
             ("ragged bf16 no silu", (2, 96, 7, 9), torch.bfloat16, False, {})]
    return rows


def gn_dropped_channel(x, gamma, beta, groups, eps, apply_silu):
    """The plain version with each group's statistics taken without its last
    channel: what the check must be able to tell from the kernel."""
    B, C, H, W = x.shape
    cg = C // groups
    xf = x.float().reshape(B, groups, cg, H * W)
    kept = xf[:, :, :cg - 1]
    n = kept[0, 0].numel()
    mean = kept.sum((2, 3), keepdim=True) / n
    var = (kept * kept).sum((2, 3), keepdim=True) / n - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, C, H, W)
    y = y * gamma.float()[:, None, None] + beta.float()[:, None, None]
    return y * torch.sigmoid(y) if apply_silu else y


def _gn_library(x, gamma, beta, groups, eps, silu):
    import torch.nn.functional as F

    y = F.group_norm(x, groups, gamma, beta, eps)
    return F.silu(y) if silu else y


def check_gn_kernel(shapes, groups=32, eps=1e-5):
    """Each shape: the GroupNorm+SiLU kernel against its plain version, on
    x = a_c * z + b_c with per-channel a_c in [0.5, 2] and b_c in [-2, 2];
    what statistics without each group's last channel would show; times of
    the kernel, the plain version and F.group_norm then F.silu."""
    import torch.nn.functional as F

    from ml_stable_diffusion_torch.ops.groupnorm import (
        group_norm_silu_cuda,
        group_norm_silu_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, calls, libraries = [], [], []
    for label, (B, C, H, W), dtype, silu, per_gen in shapes:
        a = 0.5 + 1.5 * torch.rand(C, 1, 1, generator=gen, device="cuda")
        b = 4.0 * torch.rand(C, 1, 1, generator=gen, device="cuda") - 2.0
        x = (a * torch.randn((B, C, H, W), generator=gen, device="cuda") + b).to(dtype)
        gamma = (1.0 + 0.5 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
        beta = (0.5 * torch.randn(C, generator=gen, device="cuda")).to(dtype)

        kernel = functools.partial(group_norm_silu_cuda, x, gamma, beta, groups, eps, silu)

        def plain():
            return group_norm_silu_reference(x, gamma, beta, groups, eps, silu)

        library = functools.partial(_gn_library, x, gamma, beta, groups, eps, silu)

        out = kernel()
        torch.cuda.synchronize()
        ref = plain().float()
        err, rel = abs_and_rel_rms(out, ref)
        if not (math.isfinite(err) and err <= GN_ATOL[dtype] and rel <= GN_REL_RMS[dtype]):
            fail(f"group_norm_silu {label}: kernel disagrees with its plain version at "
                 f"{(B, C, H, W)} {dtype}: max abs err {err} (atol {GN_ATOL[dtype]}), "
                 f"rel RMS err {rel} (tol {GN_REL_RMS[dtype]})")
        cut_err, cut_rel = abs_and_rel_rms(gn_dropped_channel(x, gamma, beta, groups, eps,
                                                              silu), ref)
        if cut_rel <= GN_REL_RMS[dtype]:
            fail(f"group_norm_silu {label}: the check cannot tell statistics without a "
                 f"group's last channel: rel RMS {cut_rel} <= {GN_REL_RMS[dtype]}")
        # x read once, y written once, gamma and beta read once
        nbytes = 2 * x.numel() * x.element_size() + 2 * C * gamma.element_size()
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = GN_OPS_PER_ELEMENT * x.numel() / PEAK_FLOPS[torch.float32]
        row = dict(label=label, shape=[B, C, H, W], groups=groups,
                   dtype=str(dtype).split(".")[-1], apply_silu=silu,
                   launches_per_generation=per_gen, max_abs_err=err, atol=GN_ATOL[dtype],
                   rel_rms_err=rel, rel_rms_tol=GN_REL_RMS[dtype],
                   dropped_channel_max_abs=cut_err, dropped_channel_rel_rms=cut_rel,
                   **timings(kernel, plain, library, max(t_bytes, t_ops)),
                   library="F.group_norm + F.silu (two calls)" if silu else "F.group_norm",
                   bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        rows.append(row)
        calls.append(kernel)
        libraries.append(library)
    add_device_ms(rows, {"device_ms": calls, "library_device_ms": libraries})
    for row in rows:
        label, (B, C, H, W), silu, per_gen = (row["label"], row["shape"], row["apply_silu"],
                                              row["launches_per_generation"])
        dtype, err, rel = getattr(torch, row["dtype"]), row["max_abs_err"], row["rel_rms_err"]
        cut_rel = row["dropped_channel_rel_rms"]
        log(f"gn {label:22s} {(B, C, H, W)} {row['dtype']:8s} silu {int(silu)} err {err:.3g} "
            f"(atol {GN_ATOL[dtype]}) rel RMS {rel:.3g} (tol {GN_REL_RMS[dtype]}; without "
            f"the last channel: {cut_rel:.3g} rel) kernel {row['ms']:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])})  plain {row['plain_ms']:.4f} ms  group_norm+silu "
            f"{row['library_ms']:.4f} ms (device {fmt_ms(row['library_device_ms'])})  bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
            f"  launches {per_gen}")
    return rows


def pal_shapes():
    """-> (the recorded {(M, K, N): calls per UNet call} of every
    palettizable nn.Linear of the SD-2.1 UNet at 512x512, CFG batch 2, and
    the phase-2 rows: (label, M, K, N, nbits, dtype, calls per UNet call)
    for each recorded shape at 6 bits, an nbits sweep, f32 and ragged
    cases)."""
    from kernel_bounds import linear_calls
    from ml_stable_diffusion_torch.models.unet import UNetConfig

    calls = linear_calls(UNetConfig.sd21(), (64, 64), 1024)
    if sum(calls.values()) != PAL_CALLS_PER_UNET:
        fail(f"the SD-2.1 UNet makes {sum(calls.values())} palettizable Linear calls, "
             f"want {PAL_CALLS_PER_UNET}")
    rows = [(f"sd21 {M}x{K}x{N}", M, K, N, PAL_NBITS, torch.bfloat16, n)
            for (M, K, N), n in sorted(calls.items(), key=lambda kv: (-kv[0][0], kv[0][1:]))]
    rows += [(f"{b}-bit 8192x320x2560", 8192, 320, 2560, b, torch.bfloat16, 0)
             for b in (1, 2, 4, 8)]
    rows += [("f32 2x1280x1280", 2, 1280, 1280, PAL_NBITS, torch.float32, 0),
             ("f32 154x1024x320", 154, 1024, 320, PAL_NBITS, torch.float32, 0),
             ("ragged bf16", 77, 300, 130, PAL_NBITS, torch.bfloat16, 0),
             ("ragged f32", 3, 7, 5, PAL_NBITS, torch.float32, 0)]
    return calls, rows


def _gather_matmul(x, idx, lut, shape):
    """What program mode's entry costs for one weight, then the product."""
    return torch.matmul(x, lut[idx.long()].reshape(shape).to(x.dtype))


def check_pal_kernel(shapes):
    """Each shape: the fused dequant-matmul kernel against its plain version
    on x ~ N(0, 1), uniform indices and a N(0, 1/K) LUT; what leaving out the
    last k tile would show; times of the kernel, the plain version,
    ``torch.matmul`` on the dense bf16 weight that install mode serves
    (``library_ms``) and the ``lut[idx]`` gather + matmul that program
    mode's entry costs."""
    from ml_stable_diffusion_torch.ops.palettized import (
        launch_plan,
        palettized_dense_fused_cuda,
        palettized_dense_fused_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows, calls, libraries, gathers = [], [], [], []
    for label, M, K, N, nbits, dtype, per_unet in shapes:
        x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
        idx = torch.randint(0, 2 ** nbits, (K * N,), generator=gen, device="cuda",
                            dtype=torch.int32).to(torch.uint8)
        lut = torch.randn(2 ** nbits, generator=gen, device="cuda") / math.sqrt(K)
        dense = lut[idx.long()].reshape(K, N).to(dtype)

        kernel = functools.partial(palettized_dense_fused_cuda, x, idx, lut, (K, N))

        def plain():
            return palettized_dense_fused_reference(x, idx, lut, (K, N))

        library = functools.partial(torch.matmul, x, dense)
        gather_matmul = functools.partial(_gather_matmul, x, idx, lut, (K, N))

        out = kernel()
        torch.cuda.synchronize()
        ref = plain().float()
        err, rel = abs_and_rel_rms(out, ref)
        if not (math.isfinite(err) and err <= PAL_ATOL[dtype] and rel <= PAL_REL_RMS[dtype]):
            fail(f"palettized {label}: kernel disagrees with its plain version at "
                 f"({M}x{K})@({K}x{N}) {nbits}-bit {dtype}: max abs err {err} (atol "
                 f"{PAL_ATOL[dtype]}), rel RMS err {rel} (tol {PAL_REL_RMS[dtype]})")
        kept = max(K - PAL_K_TILE, 0)
        cut = (x[:, :kept].float() @ dense[:kept].float()).to(dtype)
        cut_err, cut_rel = abs_and_rel_rms(cut, ref)
        if cut_rel <= PAL_REL_RMS[dtype]:
            fail(f"palettized {label}: the check cannot tell a dropped k tile: rel RMS "
                 f"{cut_rel} <= {PAL_REL_RMS[dtype]}")
        # x, the indices, the LUT and y once
        nbytes = (M * K + M * N) * x.element_size() + K * N + 4 * 2 ** nbits
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, 2 * M * K * N / PEAK_FLOPS[dtype]
        bound_s = max(t_bytes, t_ops)
        # the bf16 kernel's launch plan (the f32 FMA kernel has none)
        plan = launch_plan(M, K, N) if dtype == torch.bfloat16 else None
        row = dict(label=label, M=M, K=K, N=N, nbits=nbits, dtype=str(dtype).split(".")[-1],
                   plan=None if plan is None else dict(
                       bm=plan.bm, bn=plan.bn, splits=plan.splits,
                       tiles_per_split=plan.tiles_per_split, blocks=plan.blocks),
                   calls_per_unet=per_unet, max_abs_err=err, atol=PAL_ATOL[dtype],
                   rel_rms_err=rel, rel_rms_tol=PAL_REL_RMS[dtype],
                   dropped_k_tile_max_abs=cut_err, dropped_k_tile_rel_rms=cut_rel,
                   **timings(kernel, plain, library, bound_s),
                   gather_matmul_ms=time_ms(gather_matmul, reps=3 if bound_s > 1e-3 else 20),
                   library="torch.matmul on the dense weight",
                   bound_ms=1e3 * bound_s, bound_by="operations" if t_ops >= t_bytes else "bytes")
        rows.append(row)
        calls.append(kernel)
        libraries.append(library)
        gathers.append(gather_matmul)
    add_device_ms(rows, {"device_ms": calls, "library_device_ms": libraries,
                         "gather_matmul_device_ms": gathers})
    for row in rows:
        label, nbits, per_unet = row["label"], row["nbits"], row["calls_per_unet"]
        dtype, err, rel = getattr(torch, row["dtype"]), row["max_abs_err"], row["rel_rms_err"]
        cut_rel = row["dropped_k_tile_rel_rms"]
        plan = row["plan"]
        plan_s = ("fma" if plan is None else f"bm {plan['bm']} bn {plan['bn']} splits "
                  f"{plan['splits']}x{plan['tiles_per_split']} tiles, {plan['blocks']} blocks")
        log(f"pal {label:22s} {nbits}-bit {row['dtype']:8s} [{plan_s}] err {err:.3g} (atol "
            f"{PAL_ATOL[dtype]}) rel RMS {rel:.3g} (tol {PAL_REL_RMS[dtype]}; a dropped k tile: "
            f"{cut_rel:.3g} rel) kernel {row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])})  "
            f"plain {row['plain_ms']:.4f} ms  matmul {row['library_ms']:.4f} ms (device "
            f"{fmt_ms(row['library_device_ms'])})  gather+matmul {row['gather_matmul_ms']:.4f} ms "
            f"(device {fmt_ms(row['gather_matmul_device_ms'])})  bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})  calls per UNet call {per_unet}")
    return rows


def check_kernels():
    from ml_stable_diffusion_torch.ops.flash_attention import (
        flash_attention_cuda,
        flash_attention_multi_q_cuda,
        flash_attention_multi_q_reference,
        flash_attention_reference,
    )

    pal_calls, pal_rows = pal_shapes()
    rows = {
        "flash_attention": check_kernel(
            lambda qs, k, v: [flash_attention_cuda(qs[0], k, v)],
            lambda qs, k, v: [flash_attention_reference(qs[0], k, v)], FLASH_SHAPES),
        "flash_attention_multi_q": check_kernel(
            flash_attention_multi_q_cuda, flash_attention_multi_q_reference, MULTI_Q_SHAPES),
        "group_norm_silu": check_gn_kernel(gn_shapes()),
    }
    for name, kernel_rows in rows.items():
        check_shape_launches(name, kernel_rows)
    rows["palettized_dense_fused"] = check_pal_kernel(pal_rows)
    return rows, pal_calls


# -- phases 3 and 5 -------------------------------------------------------------

def letters_tokenizer(tokdir: Path):
    """A throw-away letters-only vocab with CLIP's special ids (bench.py's rig)."""
    from ml_stable_diffusion_torch.tokenizer import CLIPTokenizer

    vocab = {}
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = 49406
    vocab["<|endoftext|>"] = 49407
    (tokdir / "vocab.json").write_text(json.dumps(vocab))
    (tokdir / "merges.txt").write_text("#version: 0.2\n")
    return CLIPTokenizer.from_pretrained_dir(tokdir)


def materialize(module, gen, dtype=None, std=0.02):
    """A module built on the meta device, on the card with random weights:
    speed weights N(0, std) as bench.py draws them, or variance-preserving
    ones for std=None."""
    from ml_stable_diffusion_torch.models.init import init_random_

    module = module.to_empty(device="cuda")
    if dtype is not None:
        module = module.to(dtype)
    return init_random_(module, gen, std=std)


def sd21_modules(seed: int):
    """CLIP-H (f32), the SD-2.1 UNet (bf16) and the VAE decoder (f32) on the
    card, speed weights from ``seed``."""
    from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
    from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEDecoder

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("meta"):
        te = CLIPTextEncoder(CLIPTextConfig.sd2())
        unet = UNet2DConditionModel(UNetConfig.sd21())
        vae = VAEDecoder(VAEConfig.sd())
    return (materialize(te, gen), materialize(unet, gen, torch.bfloat16),
            materialize(vae, gen))


def build_sd21_pipeline(tokdir: Path):
    from ml_stable_diffusion_torch.pipelines import StableDiffusionPipeline

    te, unet, vae = sd21_modules(0)
    return StableDiffusionPipeline(tokenizer=letters_tokenizer(tokdir), text_encoder=te,
                                   unet=unet, vae_decoder=vae, device="cuda")


def build_sd3_pipeline(tokdir: Path):
    from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
    from ml_stable_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
    from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEDecoder
    from ml_stable_diffusion_torch.pipelines import StableDiffusion3Pipeline

    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.device("meta"):
        te_l = CLIPTextEncoder(CLIPTextConfig.sd1())
        te_g = CLIPTextEncoder(CLIPTextConfig.sdxl_g())
        mmdit = MMDiT(MMDiTConfig.sd3_medium())
        vae = VAEDecoder(VAEConfig.sd3())
    tok = letters_tokenizer(tokdir)
    return StableDiffusion3Pipeline(
        tokenizer=tok, tokenizer2=tok, text_encoder=materialize(te_l, gen),
        text_encoder2=materialize(te_g, gen), mmdit=materialize(mmdit, gen, torch.bfloat16),
        vae_decoder=materialize(vae, gen), device="cuda")


def build_sdxl_pipeline(tokdir: Path):
    """SDXL base, its UNet on the fused GroupNorm+SiLU."""
    from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
    from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEDecoder
    from ml_stable_diffusion_torch.pipelines import StableDiffusionXLPipeline

    gen = torch.Generator(device="cuda").manual_seed(7)
    with torch.device("meta"):
        te_l = CLIPTextEncoder(CLIPTextConfig.sd1())
        te_g = CLIPTextEncoder(CLIPTextConfig.sdxl_g())
        unet = UNet2DConditionModel(dataclasses.replace(UNetConfig.sdxl(),
                                                        fused_groupnorm=True))
        vae = VAEDecoder(VAEConfig.sd())
    tok = letters_tokenizer(tokdir)
    return StableDiffusionXLPipeline(
        tokenizer=tok, tokenizer2=tok, text_encoder=materialize(te_l, gen),
        text_encoder2=materialize(te_g, gen), unet=materialize(unet, gen, torch.bfloat16),
        vae_decoder=materialize(vae, gen), device="cuda")


def sdxl_with_refiner(pipe):
    """The SDXL pipeline over the same modules plus a full-width refiner, its
    UNet on the fused GroupNorm+SiLU too."""
    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
    from ml_stable_diffusion_torch.pipelines import StableDiffusionXLPipeline

    gen = torch.Generator(device="cuda").manual_seed(9)
    with torch.device("meta"):
        refiner = UNet2DConditionModel(dataclasses.replace(UNetConfig.sdxl_refiner(),
                                                           fused_groupnorm=True))
    return StableDiffusionXLPipeline(
        tokenizer=pipe.tokenizer, tokenizer2=pipe.tokenizer2, text_encoder=pipe.text_encoder,
        text_encoder2=pipe.text_encoder2, unet=pipe.unet,
        refiner_unet=materialize(refiner, gen, torch.bfloat16), vae_decoder=pipe.vae_decoder,
        device="cuda")


#: the paths ``--profile`` takes, and their pipelines
PROFILE_BUILDERS = {"sd21": build_sd21_pipeline, "sd3": build_sd3_pipeline,
                    "sdxl": build_sdxl_pipeline}


def reset_counters(counters):
    for fn in counters.values():
        fn.launches = 0


def run_main_path(pipe, path, counters, timed=3, plain=True):
    """One warm-up and ``timed`` generations with distinct prompts and seeds,
    the counters set to 0 just before and read just after; then (``plain``)
    the last generation again with attention forced to the plain path."""
    from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

    spec = PATHS[path]

    def generate(i, attention="auto"):
        cfg = PipelineConfiguration(
            prompt=PROMPTS[i % len(PROMPTS)], step_count=STEPS,
            guidance_scale=spec["guidance"], seed=1000 + i, scheduler=spec["scheduler"],
            rng="numpy", disable_safety=True, attention_implementation=attention,
            **spec.get("extra", {}))
        before = {name: fn.launches for name, fn in counters.items()}
        t0 = time.perf_counter()
        res = pipe.generate_images(cfg, image_hw=spec["image_hw"])
        seconds = time.perf_counter() - t0  # the images reach the host in it
        launched = {name: fn.launches - before[name] for name, fn in counters.items()}
        want = (1, *spec["image_hw"], 3)
        if res.images.shape != want or res.images.dtype.name != "uint8":
            fail(f"{path}: images {res.images.shape} {res.images.dtype}, want {want} uint8")
        if res.latents.shape != spec["latents"] or not bool(
                torch.isfinite(torch.from_numpy(res.latents)).all()):
            fail(f"{path}: latents {res.latents.shape} not finite or not {spec['latents']}")
        return res, launched, seconds

    reset_counters(counters)
    t0 = time.perf_counter()
    runs = [generate(i) for i in range(1 + timed)]  # warm-up + timed
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    for _, launched, _ in runs:
        if launched != spec["per_generation"]:
            fail(f"{path}: a generation launched {launched}, want {spec['per_generation']}")
    sps = statistics.median(r.seconds_per_step for r, _, _ in runs[1:])
    spi = statistics.median(secs for _, _, secs in runs[1:])
    out = dict(seconds_per_step=sps, iter_per_s=1.0 / sps, seconds_per_image=spi,
               seconds_per_step_runs=[r.seconds_per_step for r, _, _ in runs],
               seconds_per_image_runs=[secs for _, _, secs in runs],
               wall_s_generations=wall, launches=launches)
    if not plain:
        return out
    # the same generation with attention forced to the plain path.  On these
    # N(0, 0.02) weights q.k is near zero and attention nearly uniform, so
    # this shows the plain path runs end to end more than it tests the
    # kernel: phases 4, 6 and 8, on variance-preserving weights, are the
    # in-model checks.  The GroupNorm kernel stays on.
    res, plain_launched, plain_secs = generate(timed, attention="plain")
    want = {name: 0 if name in ATTENTION_KERNELS else n
            for name, n in spec["per_generation"].items()}
    if plain_launched != want:
        fail(f"{path}: attention_implementation='plain' launched {plain_launched}, "
             f"want {want}")
    rel = float(abs(runs[timed][0].latents - res.latents).max()
                / max(abs(res.latents).max(), 1e-12))
    if not rel <= GEN_MAX_REL_ERR:
        fail(f"{path}: flash vs plain latents differ by {rel} (rel) > {GEN_MAX_REL_ERR}")
    return dict(out, seconds_per_step_plain=res.seconds_per_step,
                seconds_per_image_plain=plain_secs, flash_vs_plain_latents_rel_err=rel)


# -- phases 4, 6 and 8 ------------------------------------------------------------------

def check_model_flash_vs_plain(label, model, inputs, counter, want_launches):
    """One forward with the attention dispatch on the kernel, one forced to
    the plain path: PSNR of the outputs and the launch counts."""
    from ml_stable_diffusion_torch.ops.attention import set_attention_implementation

    outs, launched = {}, {}
    try:
        with torch.inference_mode():
            for impl in ("auto", "plain"):
                set_attention_implementation(impl)
                before = counter.launches
                outs[impl] = model(*inputs)
                torch.cuda.synchronize()
                launched[impl] = counter.launches - before
    finally:
        set_attention_implementation("auto")
    if launched != {"auto": want_launches, "plain": 0}:
        fail(f"{label} forward launched the kernel {launched['auto']} / {launched['plain']} "
             f"times (auto / plain), want {want_launches} / 0")
    max_abs, psnr, peak = psnr_db(outs["auto"], outs["plain"])
    log(f"{label} flash vs plain: max abs {max_abs:.4g}, PSNR {psnr:.2f} dB "
        f"(min {MODEL_MIN_PSNR_DB}), output peak {peak:.4g}, {want_launches} launches")
    if not (math.isfinite(max_abs) and psnr >= MODEL_MIN_PSNR_DB):
        fail(f"{label} flash vs plain PSNR {psnr} dB < {MODEL_MIN_PSNR_DB}")
    return dict(max_abs=max_abs, psnr_db=psnr, peak=peak, launches=want_launches)


def check_unet_flash_vs_plain(counter):
    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig

    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.device("meta"):
        unet = UNet2DConditionModel(UNetConfig.sd21())
    unet = materialize(unet, gen, torch.bfloat16, std=None)
    inputs = (torch.randn(2, 4, 64, 64, generator=gen, device="cuda"),
              torch.tensor(500.0, device="cuda"),
              torch.randn(2, 77, 1024, generator=gen, device="cuda"))
    return check_model_flash_vs_plain("unet", unet, inputs, counter, 15)


def check_mmdit_flash_vs_plain(counter):
    from ml_stable_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig

    gen = torch.Generator(device="cuda").manual_seed(4)
    cfg = MMDiTConfig.sd3_medium()
    with torch.device("meta"):
        mmdit = MMDiT(cfg)
    mmdit = materialize(mmdit, gen, torch.bfloat16, std=None)
    inputs = (torch.randn(2, 16, 128, 128, generator=gen, device="cuda"),
              torch.tensor(500.0, device="cuda"),
              torch.randn(2, 154, cfg.context_dim, generator=gen, device="cuda"),
              torch.randn(2, cfg.pooled_dim, generator=gen, device="cuda"))
    return check_model_flash_vs_plain("mmdit", mmdit, inputs, counter, cfg.depth)


def psnr_db(got, ref):
    """-> (max abs, PSNR in dB against the reference's peak, the peak)."""
    max_abs = (got - ref).abs().max().item()
    mse = ((got - ref) ** 2).mean().item()
    peak = ref.abs().max().item()
    return max_abs, (10 * math.log10(peak ** 2 / mse) if mse > 0 else math.inf), peak


def sdxl_unet_and_inputs(gen):
    """A full-width SDXL base UNet on the fused GroupNorm, variance-preserving
    bf16 weights, and the inputs of one CFG-batch call at 1024x1024."""
    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig

    with torch.device("meta"):
        unet = UNet2DConditionModel(dataclasses.replace(UNetConfig.sdxl(),
                                                        fused_groupnorm=True))
    unet = materialize(unet, gen, torch.bfloat16, std=None)
    added = {"text_embeds": torch.randn(2, 1280, generator=gen, device="cuda"),
             "time_ids": torch.tensor([[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]] * 2,
                                      device="cuda")}
    inputs = (torch.randn(2, 4, 128, 128, generator=gen, device="cuda"),
              torch.tensor(500.0, device="cuda"),
              torch.randn(2, 77, 2048, generator=gen, device="cuda"), added)
    return unet, inputs


def check_sdxl_gn_vs_plain(unet, inputs, counter, want_launches):
    """The fused UNet against a second one on ``nn.GroupNorm`` + SiLU that
    holds the same state dict: PSNR and the GroupNorm kernel's launches."""
    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel

    with torch.device("meta"):
        plain = UNet2DConditionModel(dataclasses.replace(unet.config, fused_groupnorm=False))
    plain = plain.to_empty(device="cuda").to(torch.bfloat16)
    plain.load_state_dict(unet.state_dict(), strict=True)
    outs, launched = {}, {}
    with torch.inference_mode():
        for name, model in (("fused", unet), ("nn.GroupNorm", plain)):
            before = counter.launches
            outs[name] = model(*inputs)
            torch.cuda.synchronize()
            launched[name] = counter.launches - before
    del plain
    if launched != {"fused": want_launches, "nn.GroupNorm": 0}:
        fail(f"sdxl unet launched the GroupNorm kernel {launched['fused']} / "
             f"{launched['nn.GroupNorm']} times (fused / nn.GroupNorm), want {want_launches} / 0")
    max_abs, psnr, peak = psnr_db(outs["fused"], outs["nn.GroupNorm"])
    log(f"sdxl unet fused GroupNorm+SiLU vs nn.GroupNorm: max abs {max_abs:.4g}, PSNR "
        f"{psnr:.2f} dB (min {MODEL_MIN_PSNR_DB}), output peak {peak:.4g}, "
        f"{want_launches} launches")
    if not (math.isfinite(max_abs) and psnr >= MODEL_MIN_PSNR_DB):
        fail(f"sdxl unet fused vs nn.GroupNorm PSNR {psnr} dB < {MODEL_MIN_PSNR_DB}")
    return dict(max_abs=max_abs, psnr_db=psnr, peak=peak, launches=want_launches)


def check_sdxl_unet(counters):
    """Phase 8: the GroupNorm kernel and the flash kernel inside one
    full-width SDXL base UNet call."""
    unet, inputs = sdxl_unet_and_inputs(torch.Generator(device="cuda").manual_seed(8))
    gn = check_sdxl_gn_vs_plain(unet, inputs, counters["group_norm_silu"], 34)
    flash = check_model_flash_vs_plain("sdxl unet", unet, inputs,
                                       counters["flash_attention"], 70)
    return {"group_norm_silu": gn, "flash_attention": flash}


# -- phases 9 and 10 ----------------------------------------------------------------

def fixed_latents(pipe):
    """Latents of one SD-2.1 generation with a fixed prompt and seed."""
    from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

    spec = PATHS["sd21"]
    return pipe.generate_images(PipelineConfiguration(
        prompt=PROMPTS[0], step_count=STEPS, guidance_scale=spec["guidance"], seed=2024,
        scheduler=spec["scheduler"], rng="numpy", disable_safety=True),
        image_hw=spec["image_hw"]).latents


def check_installed(module, tree, label):
    """Every palettized weight of ``module`` equals its tree entry's
    ``dequantize().to(bf16)`` bit for bit."""
    from ml_stable_diffusion_torch.compress.palettize import PalettizedTensor

    n = 0
    for key, v in tree.items():
        if isinstance(v, PalettizedTensor):
            want = v.to("cuda").dequantize().to(torch.bfloat16)
            if not torch.equal(module.get_parameter(key), want):
                fail(f"{label}: {key} is not dequantize().to(bf16) bit for bit")
            n += 1
    log(f"{label}: {n} palettized weights equal dequantize().to(bf16) bit for bit")
    return n


def latents_agreement(got, ref, what):
    """Relative max-abs difference of two latents; a nonzero one is
    printed, one above PAL_LATENTS_REL_ERR fails."""
    import numpy as np

    diff = float(np.abs(got - ref).max())
    rel = diff / max(float(np.abs(ref).max()), 1e-12)
    if diff:
        log(f"{what}: latents differ, max abs {diff:.4g}, rel {rel:.4g} (tol "
            f"{PAL_LATENTS_REL_ERR}): the two ran different kernels or summation orders "
            "on the same bf16 weights")
    else:
        log(f"{what}: latents identical")
    if not rel <= PAL_LATENTS_REL_ERR:
        fail(f"{what}: latents rel err {rel} > {PAL_LATENTS_REL_ERR}")
    return rel


def run_palettized_path(counters):
    """Phase 9: palettize, save, load, serve in install then program mode."""
    from ml_stable_diffusion_torch.compress.palettize import PalettizedTensor, palettize_tree
    from ml_stable_diffusion_torch.convert.artifacts import load_module, save_module
    from ml_stable_diffusion_torch.convert.load import load_pipeline_from_artifacts
    from ml_stable_diffusion_torch.models.clip import CLIPTextEncoder
    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel
    from ml_stable_diffusion_torch.pipelines import StableDiffusionPipeline

    out = {}
    te, unet, vae = sd21_modules(10)
    numel = {name: sum(p.numel() for p in m.parameters())
             for name, m in (("Unet", unet), ("TextEncoder", te), ("VAEDecoder", vae))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unet_tree, unet_stats = palettize_tree(unet, PAL_NBITS)
    te_tree, te_stats = palettize_tree(te, PAL_NBITS)
    torch.cuda.synchronize()
    out["palettize_s"] = time.perf_counter() - t0
    out["stats"] = {"Unet": unet_stats, "TextEncoder": te_stats}
    log(f"palettized the UNet and CLIP-H at {PAL_NBITS} bits on the card in "
        f"{out['palettize_s']:.2f} s: {unet_stats} / {te_stats}")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        save_module(root, unet_tree, unet.config, "Unet")
        save_module(root, te_tree, te.config, "TextEncoder")
        save_module(root, vae.state_dict(), vae.config, "VAEDecoder")
        letters_tokenizer(root)
        (root / "bundle.json").write_text(json.dumps(
            {"family": "StableDiffusionPipeline", "scheduler": None}))
        out["save_s"] = time.perf_counter() - t0
        disk = {n: (root / f"{n}.safetensors").stat().st_size for n in numel}
        fp16 = {n: 2 * k for n, k in numel.items()}
        # bench_palettized6's accounting: the VAE at fp16-equivalent dense
        # bytes (its file here holds float32)
        out["disk_bytes"], out["fp16_bytes"] = disk, fp16
        out["payload_shrink_disk"] = fp16["Unet"] / disk["Unet"]
        out["bundle_shrink_disk"] = sum(fp16.values()) / (
            disk["Unet"] + disk["TextEncoder"] + fp16["VAEDecoder"])
        out["payload_shrink_stats"] = unet_stats["orig_bytes"] / unet_stats["new_bytes"]
        out["bundle_shrink_stats"] = (
            (unet_stats["orig_bytes"] + te_stats["orig_bytes"] + fp16["VAEDecoder"])
            / (unet_stats["new_bytes"] + te_stats["new_bytes"] + fp16["VAEDecoder"]))
        log(f"bundle saved in {out['save_s']:.2f} s: on disk {disk} bytes against fp16 {fp16}; "
            f"UNet payload shrink {out['payload_shrink_disk']:.3f}x on disk "
            f"({out['payload_shrink_stats']:.3f}x by palettize_tree's stats), bundle "
            f"{out['bundle_shrink_disk']:.3f}x ({out['bundle_shrink_stats']:.3f}x)")
        if not out["payload_shrink_disk"] > 16 / PAL_NBITS * 0.95:
            fail(f"the palettized UNet artifact shrinks {out['payload_shrink_disk']:.3f}x, "
                 f"want about {16 / PAL_NBITS:.2f}x")
        # the trees stay on the host for the checks; the card holds only the
        # pipeline from here on, so the memory figures read the serving modes
        unet_tree = {k: v.to("cpu") for k, v in unet_tree.items()}
        te_tree = {k: v.to("cpu") for k, v in te_tree.items()}
        unet_config, te_config = unet.config, te.config
        del te, unet, vae
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        pipe = load_pipeline_from_artifacts(root, compute_dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        log(f"load_pipeline_from_artifacts: {out['load_s']:.2f} s (install mode)")

        out["installed_bitwise"] = {"install": check_installed(pipe.unet, unet_tree,
                                                               "install mode")}
        latents = {}
        for mode in ("install", "program"):
            path = f"sd21_pal_{mode}"
            if mode == "program":
                t0 = time.perf_counter()
                program_tree, _ = load_module(root, "Unet", dequantize=False, device="cuda")
                pipe.install_palettized("unet", program_tree, dtype=torch.bfloat16,
                                        mode="program")
                del program_tree
                torch.cuda.synchronize()
                out["program_install_s"] = time.perf_counter() - t0
                pipe._materialize_palettized()
                out["installed_bitwise"][mode] = check_installed(pipe.unet, unet_tree,
                                                                  "program mode")
                pipe._release_palettized()
                # what program mode adds to each generation: the gather at
                # entry and the release at its end
                out["program_gather_ms"] = time_ms(
                    lambda: (pipe._materialize_palettized(), pipe._release_palettized()),
                    reps=1, windows=3)
                log(f"program mode: installed in {out['program_install_s']:.2f} s; the gather "
                    f"of {out['installed_bitwise'][mode]} weights at each generation's entry "
                    f"takes {out['program_gather_ms']:.2f} ms")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            at_rest = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res = run_main_path(pipe, path, counters, plain=False)
            res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            res["memory_allocated_at_rest"] = at_rest
            latents[mode] = fixed_latents(pipe)
            out[mode] = res
            log(f"{path}: peak device memory {res['max_memory_allocated'] / 2**30:.3f} GiB "
                f"({at_rest / 2**30:.3f} GiB at rest)")

    # a pipeline handed the same dequantized weights directly
    with torch.device("meta"):
        unet_d = UNet2DConditionModel(unet_config)
        te_d = CLIPTextEncoder(te_config)
    unet_d = unet_d.to_empty(device="cuda").to(torch.bfloat16)
    te_d = te_d.to_empty(device="cuda")
    with torch.no_grad():
        for module, tree in ((unet_d, unet_tree), (te_d, te_tree)):
            module.load_state_dict({k: v.dequantize() if isinstance(v, PalettizedTensor) else v
                                    for k, v in tree.items()}, strict=True)
    dense = StableDiffusionPipeline(tokenizer=pipe.tokenizer, text_encoder=te_d, unet=unet_d,
                                    vae_decoder=pipe.vae_decoder, device="cuda")
    latents["dense"] = fixed_latents(dense)
    out["latents_rel_err"] = {
        "install_vs_program": latents_agreement(latents["install"], latents["program"],
                                                "install vs program mode"),
        "install_vs_dense": latents_agreement(latents["install"], latents["dense"],
                                              "install mode vs dequantized weights handed directly"),
        "program_vs_dense": latents_agreement(latents["program"], latents["dense"],
                                              "program mode vs dequantized weights handed directly"),
    }
    del pipe, dense, unet_d, te_d
    torch.cuda.empty_cache()
    return out


def _fused_linear(x, idx, lut, shape, bias):
    """A bf16 Linear on the fused op with its bias in float32: the op adds
    it after the product and promotes the result to float32, as JAX does;
    the module gets it back in its own dtype."""
    from ml_stable_diffusion_torch.ops.palettized import palettized_dense_fused

    y = palettized_dense_fused(x, idx, lut, shape, bias=bias)
    if bias is not None and y.dtype != torch.float32:
        fail(f"fused op: {x.dtype} x with a {bias.dtype} bias gave {y.dtype}, want float32")
    return y.to(x.dtype)


def check_palettized_witness(counters, calls):
    """Phase 10: one full-width palettized SD-2.1 UNet call with every
    palettizable nn.Linear on the fused op, against the same UNet holding
    the dequantized weights (install mode).  The variance-preserving init
    leaves biases at zero, so every Linear bias is drawn N(0, 0.02): the
    fused calls then carry a float32 bias and its promotion."""
    from torch import nn

    from ml_stable_diffusion_torch.compress.palettize import PalettizedTensor, palettize_tree
    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig

    gen = torch.Generator(device="cuda").manual_seed(12)
    with torch.device("meta"):
        unet = UNet2DConditionModel(UNetConfig.sd21())
    unet = materialize(unet, gen, torch.bfloat16, std=None)
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, nn.Linear) and m.bias is not None:
                m.bias.normal_(0.0, 0.02, generator=gen)
    tree, _ = palettize_tree(unet, PAL_NBITS)
    with torch.no_grad():
        unet.load_state_dict({k: v.dequantize() if isinstance(v, PalettizedTensor) else v
                              for k, v in tree.items()}, strict=True)
    inputs = (torch.randn(2, 4, 64, 64, generator=gen, device="cuda"),
              torch.tensor(500.0, device="cuda"),
              torch.randn(2, 77, 1024, generator=gen, device="cuda"))
    with torch.inference_mode():
        ref = unet(*inputs)
        install_ms = time_ms(lambda: unet(*inputs), reps=3)
    # the fused op takes the Dense (K, N) index layout; nn.Linear holds (N, K)
    with_bias = 0
    for name, m in unet.named_modules():
        pt = tree.get(f"{name}.weight")
        if isinstance(m, nn.Linear) and isinstance(pt, PalettizedTensor):
            with_bias += int(m.bias is not None)
            N, K = pt.shape
            idx_kn = pt.indices.reshape(N, K).t().contiguous().reshape(-1)
            m.forward = functools.partial(_fused_linear, idx=idx_kn, lut=pt.lut, shape=(K, N),
                                          bias=None if m.bias is None else m.bias.float())
    reset_counters(counters)
    with torch.inference_mode():
        got = unet(*inputs)
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = sum(calls.values())
    if launches["palettized_dense_fused"] != want:
        fail(f"the palettized UNet call launched the fused op {launches['palettized_dense_fused']} "
             f"times, want the {want} recorded palettizable Linear calls")
    with torch.inference_mode():
        fused_ms = time_ms(lambda: unet(*inputs), reps=3)
    max_abs, psnr, peak = psnr_db(got, ref)
    lo, hi = PAL_PREDICTED_PSNR_DB
    log(f"palettized unet, every palettizable Linear on the fused op vs install mode: max abs "
        f"{max_abs:.4g}, PSNR {psnr:.2f} dB (min {PAL_MIN_PSNR_DB}; predicted {lo:g}-{hi:g}, "
        f"{'inside' if lo <= psnr <= hi else 'outside'} it), output peak {peak:.4g}, "
        f"launches {launches}, {with_bias} of the modules with a float32 bias; UNet call "
        f"{fused_ms:.3f} ms fused vs {install_ms:.3f} ms install")
    if not (math.isfinite(max_abs) and psnr >= PAL_MIN_PSNR_DB):
        fail(f"palettized unet fused vs install PSNR {psnr} dB < {PAL_MIN_PSNR_DB}")
    del unet
    torch.cuda.empty_cache()
    return dict(max_abs=max_abs, psnr_db=psnr, predicted_psnr_db=list(PAL_PREDICTED_PSNR_DB),
                peak=peak, launches=launches, modules_with_bias=with_bias,
                unet_call_ms_fused=fused_ms, unet_call_ms_install=install_ms)


def pal_kernel_entry(rows, witness, main_launches):
    """The fused dequant-matmul's line: launches from its main path (phase
    10, one UNet call), and the times of that call's launches: sum over the
    recorded shapes of per-launch time x calls.  ``launches_by_path`` reads
    the counters of the palettized generations (phase 9) too."""
    counted = [r for r in rows if r["calls_per_unet"]]
    per_unet = {key: total(None if r[key] is None else r[key] * r["calls_per_unet"]
                           for r in counted)
                for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                            "library_device_ms", "gather_matmul_ms", "gather_matmul_device_ms")}
    heavy = max(counted, key=lambda r: r["bound_ms"] * r["calls_per_unet"])
    launches = witness["launches"]["palettized_dense_fused"]
    return dict(name="palettized_dense_fused", route="cuda",
                source="ml_stable_diffusion_torch/csrc/palettized_matmul.cu",
                replaces="ml_stable_diffusion_tpu/ops/palettized.py:102",
                launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=per_unet["ms"], plain_ms=per_unet["plain_ms"], bound_ms=per_unet["bound_ms"],
                bound_by=heavy["bound_by"], library_ms=per_unet["library_ms"],
                device_ms=per_unet["device_ms"], library_device_ms=per_unet["library_device_ms"],
                gather_matmul_ms=per_unet["gather_matmul_ms"],
                gather_matmul_device_ms=per_unet["gather_matmul_device_ms"],
                launches_by_path={**{p: main_launches[p]["palettized_dense_fused"]
                                     for p in ("sd21_pal_install", "sd21_pal_program")},
                                  "phase 10 witness": launches},
                per_unet_call=dict(per_unet, launches=launches),
                shapes=rows)


def per_generation(rows, path):
    """Times of one generation's launches on ``path``: sum over its shapes
    of per-launch time x launches at that shape."""
    counted = [(r, r["launches_per_generation"].get(path, 0)) for r in rows]
    counted = [(r, n) for r, n in counted if n]
    out = {key: total(None if r[key] is None else r[key] * n for r, n in counted)
           for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                       "library_device_ms")}
    out["launches"] = sum(n for _, n in counted)
    return out


def kernel_entry(name, source, replaces, rows, main_launches):
    """The kernel's line: launches from the main paths' runs, and the times
    of its launches in one generation of each path it runs on."""
    paths = [p for p in main_launches if PATHS[p]["per_generation"][name]]
    per_gen = {p: per_generation(rows, p) for p in paths}
    # what bounds the shape that takes the largest share of the bound
    heavy = max(rows, key=lambda r: r["bound_ms"] * sum(r["launches_per_generation"].values()))
    entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=sum(main_launches[p][name] for p in paths),
                 max_abs_err=max(r["max_abs_err"] for r in rows))
    for key in ("ms", "plain_ms", "bound_ms"):
        entry[key] = sum(g[key] for g in per_gen.values())
    entry["bound_by"] = heavy["bound_by"]
    entry["library_ms"] = sum(g["library_ms"] for g in per_gen.values())
    entry["device_ms"] = total(g["device_ms"] for g in per_gen.values())
    entry["library_device_ms"] = total(g["library_device_ms"] for g in per_gen.values())
    entry["launches_by_path"] = {p: main_launches[p][name] for p in paths}
    entry["per_generation"] = per_gen
    entry["shapes"] = rows
    return entry


#: kernel name fragments -> group; the first match wins (cuDNN's implicit-GEMM
#: convolutions carry "gemm" in their names too)
_KERNEL_GROUPS = (("groupnorm kernel", ("gn_silu",)),
                  ("flash kernel", ("flash_wgmma", "flash_fma")),
                  ("convolution", ("conv", "fprop", "dgrad", "implicit")),
                  ("matmul", ("gemm", "xmma", "nvjet", "cutlass")),
                  ("softmax", ("softmax",)))


def _device_time(prof):
    """-> (busy us, {group: us}, {kernel name: (launches, us)}) of the device
    kernels a profiler recorded; busy is the union of their intervals."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        fail("the profiler recorded no device time")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    groups, names = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        low = e.name.lower()
        group = next((g for g, keys in _KERNEL_GROUPS if any(k in low for k in keys)),
                     "other")
        groups[group] = groups.get(group, 0.0) + us
        n, t = names.get(e.name, (0, 0.0))
        names[e.name] = (n + 1, t + us)
    return busy, groups, names


def profile_generation(path):
    """One generation of ``path`` under torch.profiler after a warm-up, then
    its VAE decode alone: device time by kernel group for the generation,
    the decode, and per denoise step (generation less decode, over the
    steps)."""
    from torch.profiler import ProfilerActivity, profile

    from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

    spec = PATHS[path]
    with tempfile.TemporaryDirectory() as tokdir:
        pipe = PROFILE_BUILDERS[path](Path(tokdir))

    def generate(i):
        return pipe.generate_images(PipelineConfiguration(
            prompt=PROMPTS[i], step_count=STEPS, guidance_scale=spec["guidance"],
            seed=1000 + i, scheduler=spec["scheduler"], rng="numpy", disable_safety=True),
            image_hw=spec["image_hw"])

    res = generate(0)
    pipe.decode_latents(res.latents)
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        res = generate(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with profile(activities=activities) as prof_decode:
        pipe.decode_latents(res.latents)
        torch.cuda.synchronize()
    busy, groups, names = _device_time(prof)
    dec_busy, dec_groups, _ = _device_time(prof_decode)
    per_step = {g: (t - dec_groups.get(g, 0.0)) / 1e3 / STEPS for g, t in groups.items()}
    summary = dict(path=path, wall_s=wall, seconds_per_step=res.seconds_per_step,
                   device_busy_s=busy / 1e6, device_busy_share=busy / 1e6 / wall,
                   decode_device_s=dec_busy / 1e6,
                   device_ms_by_group={g: t / 1e3 for g, t in groups.items()},
                   decode_device_ms_by_group={g: t / 1e3 for g, t in dec_groups.items()},
                   step_device_ms_by_group=per_step)
    log(f"profiled one {path} generation (profiler on: host work is slower than in "
        f"phases 3/5): wall {wall:.3f} s, {res.seconds_per_step * 1e3:.2f} ms/step, "
        f"device busy {busy / 1e6:.3f} s ({100 * busy / 1e6 / wall:.1f} % of wall), "
        f"of it the VAE decode {dec_busy / 1e6:.3f} s")
    step_total = sum(per_step.values())
    for g, ms in sorted(per_step.items(), key=lambda kv: -kv[1]):
        log(f"  {g:12s} {ms:8.2f} ms per step ({100 * ms / step_total:.1f} %); "
            f"decode {dec_groups.get(g, 0.0) / 1e3:8.2f} ms")
    for name, (n, us) in sorted(names.items(), key=lambda kv: -kv[1][1])[:25]:
        log(f"  {us / 1e3:10.2f} ms  {n:6d} x  {name[:110]}")
    log(json.dumps({"profile": summary}))


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--profile" and sys.argv[2] in PROFILE_BUILDERS:
        if not torch.cuda.is_available():
            print("chip_smoke.py: no CUDA device; nothing was run", file=sys.stderr)
            return 1
        from ml_stable_diffusion_torch.utils.numerics import apply_numerics

        apply_numerics()
        log(f"card: {card_line()}")
        profile_generation(sys.argv[2])
        return 0
    if len(sys.argv) > 1:
        print(f"usage: {sys.argv[0]} [--profile {'|'.join(PROFILE_BUILDERS)}]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from ml_stable_diffusion_torch.ops.flash_attention import (
        flash_attention_cuda,
        flash_attention_multi_q_cuda,
    )
    from ml_stable_diffusion_torch.ops.groupnorm import group_norm_silu_cuda
    from ml_stable_diffusion_torch.ops.palettized import palettized_dense_fused_cuda
    from ml_stable_diffusion_torch.utils import cuda_build
    from ml_stable_diffusion_torch.utils.numerics import apply_numerics, numerics_settings

    counters = {"flash_attention": flash_attention_cuda,
                "flash_attention_multi_q": flash_attention_multi_q_cuda,
                "group_norm_silu": group_norm_silu_cuda,
                "palettized_dense_fused": palettized_dense_fused_cuda}
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    apply_numerics()
    log(f"numerics: {json.dumps(numerics_settings())}")
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: "
        f"{[p.name for p in libs]}")
    for name, (secs, report) in cuda_build.build_reports.items():
        log(f"nvcc {name}.cu: {secs:.2f} s")
        for line in report.splitlines():
            # register use, spills, and wgmma that ptxas had to serialise
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                log("  " + line.strip())
    # the two wgmma kernels' libraries must hold wgmma instructions
    hgmma = hgmma_counts(libs)
    log(f"HGMMA instructions in the SASS (cuobjdump): "
        f"{'cuobjdump not found' if hgmma is None else hgmma}")
    for lib in libs:
        if hgmma is not None and lib.stem.split("-")[0] in WGMMA_LIBS and not hgmma[lib.name]:
            fail(f"{lib.name} holds no HGMMA instruction: its kernel does not run on wgmma")

    rows, pal_calls = check_kernels()

    main_paths, model_checks = {}, {}

    def report(path, res):
        plain = ("" if "seconds_per_step_plain" not in res else
                 f"; plain attention {res['seconds_per_step_plain'] * 1e3:.2f} ms/step; flash "
                 f"vs plain latents rel err {res['flash_vs_plain_latents_rel_err']:.3g}")
        log(f"main path {path}: {PATHS[path]['label']}: "
            f"{res['seconds_per_step'] * 1e3:.2f} ms/step, {res['iter_per_s']:.2f} iter/s, "
            f"{res['seconds_per_image']:.3f} s/image ({card}){plain}; "
            f"launches {res['launches']}")

    for path, build, check in (("sd21", build_sd21_pipeline, check_unet_flash_vs_plain),
                               ("sd3", build_sd3_pipeline, check_mmdit_flash_vs_plain)):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tokdir:
            pipe = build(Path(tokdir))
        main_paths[path] = run_main_path(pipe, path, counters)
        report(path, main_paths[path])
        del pipe
        torch.cuda.empty_cache()
        counter = counters["flash_attention" if path == "sd21" else "flash_attention_multi_q"]
        model_checks[path] = check(counter)
        torch.cuda.empty_cache()
        log(f"phases of {path}: {time.perf_counter() - t0:.1f} s")

    # phase 7: SDXL base, then base + refiner over the same modules
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tokdir:
        pipe = build_sdxl_pipeline(Path(tokdir))
    main_paths["sdxl"] = run_main_path(pipe, "sdxl", counters)
    report("sdxl", main_paths["sdxl"])
    pipe = sdxl_with_refiner(pipe)
    main_paths["sdxl_refiner"] = run_main_path(pipe, "sdxl_refiner", counters, timed=1,
                                               plain=False)
    report("sdxl_refiner", main_paths["sdxl_refiner"])
    del pipe
    torch.cuda.empty_cache()
    # phase 8
    model_checks["sdxl"] = check_sdxl_unet(counters)
    torch.cuda.empty_cache()
    log(f"phases of sdxl: {time.perf_counter() - t0:.1f} s")

    # phases 9 and 10: the palettized path and the fused op's witness
    t0 = time.perf_counter()
    palettized = run_palettized_path(counters)
    for mode in ("install", "program"):
        main_paths[f"sd21_pal_{mode}"] = palettized.pop(mode)
        report(f"sd21_pal_{mode}", main_paths[f"sd21_pal_{mode}"])
    model_checks["palettized"] = check_palettized_witness(counters, pal_calls)
    log(f"phases of the palettized path: {time.perf_counter() - t0:.1f} s")

    launches = {p: r["launches"] for p, r in main_paths.items()}
    kernels = [
        kernel_entry("flash_attention", "ml_stable_diffusion_torch/csrc/flash_attention.cu",
                     "ml_stable_diffusion_tpu/ops/flash_attention.py:151",
                     rows["flash_attention"], launches),
        kernel_entry("flash_attention_multi_q",
                     "ml_stable_diffusion_torch/csrc/flash_attention.cu",
                     "ml_stable_diffusion_tpu/ops/flash_attention.py:281",
                     rows["flash_attention_multi_q"], launches),
        kernel_entry("group_norm_silu", "ml_stable_diffusion_torch/csrc/groupnorm_silu.cu",
                     "ml_stable_diffusion_tpu/ops/groupnorm.py:64",
                     rows["group_norm_silu"], launches),
        pal_kernel_entry(rows["palettized_dense_fused"], model_checks["palettized"], launches),
    ]
    log(json.dumps({"main_paths": main_paths, "in_model_checks": model_checks,
                    "palettized_path": palettized, "numerics": numerics_settings(),
                    "hgmma_instructions": hgmma}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
