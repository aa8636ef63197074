#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ml_stable_diffusion_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card; without one, or without the repository around it, it
exits non-zero and prints no result.  Phases, each fatal on failure:

1. Environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, the TF32 settings; build every kernel from csrc/, print ptxas's
   register use and any wgmma it had to serialise, and count the HGMMA
   (wgmma) instructions in the SASS of the flash and dequant-matmul
   libraries (``cuobjdump -sass``; 0 fails the run); build the native host
   libraries (``utils/native.py``: ``make -C native BUILD=build/native``)
   and time the build, so that no later phase's seconds hold it (the first
   safetensors read, phase 20's, would build them otherwise); a failed
   build fails the run.
2. Every kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it plus ragged ones, with timings of the kernel (CUDA
   events and the profiler's device time per launch), the plain version and
   one PyTorch library call computing the same function; beside each row
   the flash tile instantiation or the dequant-matmul's launch plan.  The
   GroupNorm+SiLU shapes are recorded from the SDXL base and refiner UNets
   themselves.  The GEGLU gate at the two benchmark cells' shapes must be
   bit-equal to the eager chain it replaces; its device ms beside the
   chain's and its bound, per launch and per generation.
3. The main path at full width: SD-2.1-base 512x512 txt2img, 20 steps of
   DPM-Solver++(2M), CFG batch 2, guidance 7.5, through
   ``StableDiffusionPipeline.generate_images`` with random weights from a
   seeded generator.  One warm-up (which captures the generation's
   program), then the median of 3 generations with distinct prompts and
   seeds (replays).  Kernel launch counts are read around it.
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
11. SD-1.5 512x512 txt2img with the default configuration: PNDM, 20 steps
   (21 UNet calls: the PLMS warm-up), CFG batch 2, guidance 7.5, CLIP-L in
   float32, ``UNetConfig.sd15`` in bf16 (heads of width 40, 80 and 160 on
   the flash kernel), the VAE in float32; as phase 3: warm-up, median of 3,
   launch counts (316 flash), one generation forced plain.  Then one
   full-width SD-1.5 UNet forward with variance-preserving weights, flash
   against plain (as phase 4).
12. SD-2.1 img2img and inpainting on phase 3's modules plus a VAE encoder
   (run right after phase 4): PNDM, 20 steps at strength 0.75 (16 UNet
   calls), then the same with the left half of the image repainted.  s/step,
   s/image, launch counts (15 per UNet call + 2: the encoder's and the
   decoder's f32 D = 512 heads), and the known half of the inpainted
   latents against the starting image's latents z0, recomputed.
13. Every scheduler of ``SCHEDULER_MAP`` on the SD-2.1 pipeline at 8 steps,
   one generation each: finite latents and launch counts; then LCM on a
   full-width SD-2.1 UNet with ``time_cond_proj_dim=256`` at 4 steps,
   without CFG.
14. One SD3 img2img generation on phase 5's pipeline plus its 16-channel
   VAE encoder, and one SDXL-base img2img generation on phase 7's base
   pipeline plus a VAE encoder (before the refiner joins): strength 0.75 of
   20 steps, launch counts of both flash entries, the encoder's head and
   the GroupNorm kernel.

15. SD-1.5 ControlNet on phase 11's modules plus a full-width ControlNet of
   ``UNetConfig.sd15`` (conditioning channels (16, 32, 96, 256), as
   lllyasviel/control_v11p_sd15_canny), bf16, N(0, 0.02) weights, a seeded
   edge-map control image: one net as phase 3 (warm-up, median of 3, one
   generation forced plain), two nets (one generation), and the one-net
   latents against phase 11's of the same prompt and seed (the nets must
   move them).  21 flash launches per UNet call with one net (15 + 6 at
   batch 1), 27 with two.
16. The other SD-1.5 features on phase 11's pipeline, one generation each: a
   weighted prompt of four 77-token windows (cross attention over 308 keys
   on the kernel: 30 launches per UNet call), the multilingual projection
   with a deterministic host embedder (256 keys: 30), DeepCache at interval
   3 (7 full and 14 shallow passes: 176 a generation), serial batch-1 CFG
   (two batch-1 calls: 30; its latents against phase 11's batched ones,
   rel <= 1e-3), a progress handler rendering ``latent_to_rgb_preview`` of
   each step's denoised latents that stops after step 10 (151), and the
   full-size safety checker (f32, plain attention: no launch) with its ms
   per image and flags.
17. SDXL-base 1024x1024 on phase 7's base pipeline plus a full-width SDXL
   ControlNet (``UNetConfig.sdxl``, as diffusers/controlnet-canny-sdxl-1.0)
   and a weighted dual-encoder prompt of two windows: one generation, 2081
   flash launches (70 + 34 a UNet call, + 1) and 680 GroupNorm (the net's
   GroupNorms are plain, as in the JAX package).
18. SD3-medium 1024x1024 on phase 5's pipeline plus the full-width T5-XXL
   encoder (``T5Config.xxl()``, 4.76 B parameters in bf16, its
   relative-position table float32, N(0, 0.02) weights) and a synthetic
   unigram ``tokenizer.json`` written here: warm-up and median of 3, 480
   multi-stream launches a generation as without T5, the latents moved from
   phase 5's of the same prompt and seed; the T5 encode's device ms beside
   its bound (the weights read once).
19. SD3-medium with one full-width ``SD3ControlNetConfig.sd3_medium()`` net
   (12 joint blocks, ~1.1 B parameters, bf16) and a 16-channel VAE encoder:
   its control image VAE-encoded once a generation, the net's joint
   attention at batch 1 on the multi-stream kernel.  Warm-up and median of
   3 (720 multi-stream launches, 2 f32 D = 512 VAE heads: the decode's and
   the control encode's), then two nets for one generation (960, 3); the
   net moves the latents from phase 5's.
20. The loader on the card: phase 3's SD-2.1 modules (plus a VAE encoder, a
   diffusers VAE holds both) saved as a diffusers-layout directory in the
   dtypes they run in (UNet bf16, CLIP and VAE float32; the port's
   ``save_file``), ``convert.load.load_pipeline`` on it, and one generation
   whose latents must equal phase 3's of the same prompt and seed bit for
   bit; the directory is kept for phases 28, 31 and 32 and removed after
   phase 32.
21. The adapters on phase 11's SD-1.5 pipeline, with seeded random weights
   in the published layouts and geometries, written to and read from files:
   a kohya LoRA (rank 16, alpha 8, fp16) over every UNet attention and FF
   projection and every CLIP-L q/k/v/out/fc1/fc2, stacked with a PEFT one
   on the cross attentions' to_k/to_v, one generation (the latents moved),
   ``clear_loras`` (every tensor back byte for byte) and one more
   generation bit-equal to phase 11's of the same prompt and seed; a
   textual-inversion placeholder whose two vectors are the token rows of
   the two-token word "on" (its latents bit-equal to the word's);
   IP-Adapter BASE in ip-adapter_sd15's geometry (ViT-H/14: hidden 1280, 32
   layers, 16 heads, MLP 5120, projection 1024; 4 tokens over 768) at
   ``ip_adapter_scale`` 0 (bit-equal) and 1 (warm-up, median of 3), and
   PLUS (the resampler: dim 768, depth 4, 12 heads, 16 queries, ff x4,
   from a torch .bin), warm-up and median of 3.  Every generation launches
   phase 11's 316 flash; the vision encoder's ms at batch 1 and 2 beside
   its bound, and one UNet call with and without the IP tokens.
22. The adapters on SDXL and SD3: on phase 7's base pipeline a kohya-sgm
   LoRA (UNet, ``lora_te1_``, ``lora_te2_``), generated from and cleared; a
   ``clip_l``/``clip_g`` placeholder of the same word, bit-equal to phase
   7's latents; IP-Adapter in ip-adapter_sdxl's geometry (ViT-bigG/14:
   hidden 1664, 48 layers, 16 heads, MLP 8192, projection 1280; 4 tokens
   over 2048): 1401 flash and 680 GroupNorm each.  On phase 5's pipeline
   a PEFT ``transformer.`` LoRA over every joint-attention projection,
   generated from and cleared: 480 multi-stream launches.
23. Captured programs against the eager loop, on the pipelines of phases 3
   (SD-2.1), 11 (SD-1.5), 7 (SDXL base + refiner) and 5 (SD3), each right
   after its main path: one eager generation (``execution = "eager"``) and
   one captured with the same prompt and seed, their latents and images
   bit-equal and their own launch counts the main path's; the eager
   generation's s/step and one captured replay's; the program's capture
   seconds and pool bytes; the device's busy share of one generation of
   each under the profiler, and the profiler's kernel records of the
   port's kernels held against the credited launch counts.
24. ``reduce_memory`` on phase 7's SDXL base + refiner at 1024x1024: the
   default (captured) generation from a cleared cache (its peak with the
   capture, its time on the replay), then
   ``offload_params_to_host`` and one staged generation, its latents and
   images bit-equal to the default's; ``max_memory_allocated`` of both and
   each stage's transfer bytes, seconds and GB/s.
25. Serving on phase 3's SD-2.1 pipeline: ``GenerationServer.precompile``
   at batch sizes 1, 2 and 4, four concurrent ``submit``s coalesced into
   one batch, the batch against the pipeline's own generation of the merged
   batch (bit-equal) and each result against its request run alone, one
   img2img request that runs alone, ``stats()`` and the requests a second.
   Then the W8A8 + DeepCache (interval 2) + batch-4 preset on phase 26's
   W8A8 pipeline: precompile, four submits coalesced into one batch, the
   batch bit-equal to the pipeline's merged generation, each finite.
26. W8A8 on phase 3's SD-2.1 modules, on copies of its pipeline: the int8
   ops (quantize_weight_int8 in f32 and bf16, int8_dense, int8_conv) on the
   card against the host, bit for bit, at the UNet's three largest Linear
   shapes and its largest 3x3 convolution; ``enable_w8a8()`` (ConstantScales,
   dense) and ``enable_w8a8(include_convs=True)``: int8 layers against the
   profiler's ``aten::_int_mm`` records in one UNet call, 301 flash a
   generation, warm-up then one captured replay's s/step in turns with
   phase 3's pipeline (whose UNet stays byte for byte, and whose replay
   gives its own latents again), busy share, the UNet's bytes; a calibrated
   (two calls) W8A8 UNet with variance-preserving weights against the float
   call (PSNR) and each layer against its fake-quant simulation (rel RMS);
   each distinct int8 layer shape's quantize, ``_int_mm`` and rescale
   device ms against bf16 ``F.linear``/``F.conv2d``, with bounds.
27. W8A8 (dense) on phase 7's SDXL base and phase 5's SD3 modules: warm-up
   and one captured replay's s/step in turns with the bf16 pipeline,
   every generation's counts the bf16 path's (1401 flash and 680 GroupNorm;
   480 multi-stream), busy share, the denoiser's bytes.
28. Phase 20's diffusers directory (kept until phase 32) loaded with
   ``fuse_qkv=True``: its latents against phase 3's of the same prompt and
   seed (rel RMS), 301 flash, s/step in turns with phase 3's pipeline.
29. Staged: phase 9's pipeline in palettized program mode, offloaded and
   generated with ``reduce_memory``, latents bit-equal to its unstaged
   program mode, both peaks; SDXL base W8A8 on copies of phase 7's modules,
   offloaded and staged, latents bit-equal to phase 27's unstaged ones,
   the int8 buffers packed with the base UNet, each stage's bytes.
30. Training at full width (``parallel/train.py``), run after phase 23 on
   phase 3's pipeline: one captured SD-2.1 generation under
   ``utils.profiling.trace``, its flash family the kernels of its 301
   launches, and ``cost_summary``'s flops for one UNet forward at batch 2
   beside a count from the layers' shapes; then the SD-2.1 UNet in float32
   (seeded N(0, 0.02) weights), AdamW at lr 1e-5, one batch of 2 latents
   of 4x64x64 and a 77x1024 context: three steps with fixed draws without
   and with remat, the loss falling, s/step, samples/s and peak memory, no
   kernel launched; every kernel wrapper raising on CUDA inputs that
   require grad; the state saved and restored bit for bit, the next step's
   loss equal from both under deterministic algorithms; one step under the
   trace.
31. The command line on phase 20's directory, after phase 28:
   ``cli.generate`` with phase 20's first generation flag for flag (the
   PNG read back by ``utils/png.py`` bit-equal to phase 20's image, the
   counters grown by phase 20's launches, ``_name``'s file name);
   ``cli.convert --convert-all --check-output-correctness
   --bundle-resources-for-generation`` (each convert-time gate's dB at full
   width in float32 on the card, at least 35; the bundle's bytes and
   seconds; ``load_pipeline_from_artifacts`` on the bundle giving phase
   20's latents bit for bit); ``cli.benchmark --repeats 1 --step-count 20``
   beside phase 3's captured s/step.
32. The native host libraries, built in phase 1, each required, so that
   a native path not taken fails the run: phase 1's build seconds; the C++ BPE's ids against the
   Python tokenizer's on PROMPTS and phase 16's four-window prompt;
   ``denormalize_to_uint8``'s converter against its numpy rule on phase
   3's first latents decoded in float32; the C++ unigram Viterbi against
   the Python segmentation on phase 18's ``tokenizer.json``; the C++
   safetensors header parse against the Python parse of phase 20's UNet
   file.  Then phase 20's directory is removed.
   Each phase group's seconds and the whole run's are printed.
33. Tensor and spatial parallelism (``parallel/``).  33.1, last on phase 3's
   pipeline: one replay of its unsharded program, then ``pipe.shard`` over a
   one-rank NCCL mesh (``make_mesh(1)``; the collectives issued as at any
   world size, so the generation's graph captures NCCL calls) and phase 3's
   warm-up and first timed generation again: 301 flash launches each, the
   latents against phase 3's, ms/step beside the unsharded replay's.
   33.2 and 33.3, after the palettized phases: two ranks on the one card
   over gloo (NCCL takes one rank a device), each a process of its own
   (``--parallel-rank``): the full-width SD-2.1 UNet (variance-preserving
   bf16 weights) at (2, 4, 64, 64), unsharded, spatially sharded and tensor
   sharded at tp=2, each sharded output against the unsharded one (PSNR >=
   40 dB) with each rank's flash launches and shapes; phase 3's pipeline
   sharded at tp=2, a captured generation refused, then 4 steps (a depth
   cut for time) eagerly against the unsharded generation; the SDXL base
   UNet at 1024x1024 on the fused GroupNorm the same way, with the
   GroupNorm kernel's launches.  Then the flash kernel at the sharded shapes
   no earlier phase times, against its plain version, with its bound.
34. The training step over a (dp, tp) mesh (``make_train_step(..., mesh)``).
   34.1, right after 33.1 on its one-rank NCCL group: phase 30's SD-2.1
   UNet, batch, AdamW and fixed draws through ``make_mesh(1)`` (every
   sharded layer installed, its collectives NCCL calls over one rank),
   a warm-up step each, then three steps in turn with the unsharded step:
   the losses within rel 1e-5 of phase 30's, ms/step of each, no
   hand-written kernel launched.  34.2, in phase 33's two gloo ranks after
   33.3 (dp = 1, tp = 2), the card freed first: one SGD step at lr 1 (the
   update is minus the gradient) against the unsharded one, the loss and
   the gathered update (relative RMS); one AdamW step, every tp-replicated
   parameter bit-equal on both ranks; its checkpoint saved at tp = 2 and
   restored unsharded, bit-equal to the live state; s/step and each rank's
   peak memory (two ranks on one card over gloo: nothing about scaling).

The main paths run their captured programs (pipelines/program.py): each
key's first generation runs the body once eagerly as warm-up, captures it
and replays it; later ones replay.  A replay credits the launches its
capture counted, so each generation's own launches are the counters' growth
less its programs' warm-ups, which are printed apart.  The printed device
memory reserved after each path includes its programs' pool.

Phase 2 holds the multi-stream kernel at SD3 ControlNet's batch-1 shape too.

Every kernel launch counter is set to 0 just before each main path (phases
3, 5, both runs of 7, both modes of 9, 11, both runs of 12, both of 14, each
path of 15, 16, 17, 18, 19, 20, 21 and 22, each path's turns of 26, 27 and
28, the staged run of 29, 31's generate, bundle generation and benchmark,
33.1's unsharded replay and sharded generations, 34.1's training steps,
and phase 10 for the fused
dequant-matmul, whose main path it is) and read just after it; phase 13 reads them around each
generation.  Prints a
``{"kernels": [...]}`` JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile sdxl   (or sd3, sd21, sd15)

runs instead one generation of that path under ``torch.profiler`` after a
warm-up and prints where the device time goes: the kernels grouped (the
GroupNorm and flash kernels, matrix products, convolutions, the rest), the
top kernels by device time, and the device's busy share of the generation's
wall time, for the captured program and then for the eager loop.

    python3 chip_smoke.py --compare PARENT_CHECKOUT

runs phase 2 of a parent checkout (a ``git archive`` of it) and of this
tree in turns, parent, change, change, parent, each in a process of its own,
then ``--profile sd15`` of each, and prints each kernel row's device ms per
launch side by side with its library call, bound and exp floor, and each
path's flash ms per generation.
"""

from __future__ import annotations

import copy
import contextlib
import dataclasses
import functools
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

#: H100 SXM data-sheet peaks (dense) and HBM3 bandwidth.  bf16: the tensor
#: cores.  f32: the least time of f32-exact products is the 3xTF32 rate, three
#: TF32 tensor-core products (lo·hi, hi·lo, hi·hi) for each, 495 / 3 TFLOP/s,
#: above the FMA units' 67: a kernel on the FMA units can reach at most 41 %
#: of this bound
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
PEAK_BYTES_PER_S = 3.35e12
#: exponentials a second on the SFUs (16 a clock an SM): one per 256 bf16
#: tensor-core flops of time, the flash kernels' floor where a logit's
#: products take fewer (D < 64)
SFU_EXP_PER_S = PEAK_FLOPS[torch.bfloat16] / 256
#: max-abs tolerance of a kernel against its plain version
#: (tests/test_pallas_kernels.py's)
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: relative RMS tolerance, ||got - ref|| / ||ref||, held as well: with
#: unit-normal q, k, v over 4096 keys the output is itself ~2e-2, of the
#: order of the bf16 ATOL, so ATOL alone would pass a dropped KV tile
#: (which moves it by ~1e-1); f32 leaves room for the kernels' own
#: summation order over 4096 keys (the 3xTF32 kernel's tensor-core
#: accumulation: ~1.6e-5)
REL_RMS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
#: keys the dropped-tile witness leaves out: 64, half of the bf16 kernel's
#: 128-row kv tile and the whole tile of the FMA and 3xTF32 kernels
#: (csrc/flash_attention.cu)
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
#: resnet GroupNorm+SiLU, 34 per SDXL base UNet call and 44 per refiner call;
#: geglu: one per transformer block, whatever its tokens, GEGLU_PER_CALL)
#: the VAE mid block's f32 D = 512 head, once per generation on every path:
#: one of the flash_attention launches, on the 3xTF32 kernel and its pre-pass
VAE_ATTENTION = {"flash_attention_wide_f32": 1, "flash_split_tf32": 1}
#: GEGLU gate launches per call of each denoiser: the SD-1.5/2.1 UNet (5 at
#: each upper level and the mid block's), SDXL base and refiner, an SD-1.5
#: ControlNet (down blocks 0-2 and the mid block) and an SDXL one (down and
#: mid), and a DeepCache shallow pass (down block 0 and the last up block)
GEGLU_PER_CALL = {"sd": 16, "sdxl": 70, "refiner": 41, "sd15_net": 7, "sdxl_net": 34,
                  "shallow": 5}
#: img2img and inpainting encode the starting image once: a second head
VAE_ATTENTION_ENCODE = {name: 2 for name in VAE_ATTENTION}
#: img2img strength of phases 12 and 14: the last 15 of 20 steps (PNDM: 16
#: UNet calls, its warm-up replayed at the resume point)
STRENGTH = 0.75
#: UNet calls of each generation: phase 11's PNDM 20 steps (one more than
#: the steps: the PLMS warm-up), phase 12's strength-sliced PNDM, phase 14's
#: strength-sliced DPM++ and DiscreteFlow (main() checks them against the
#: schedulers' plans)
UNET_CALLS = {"sd15": 21, "sd21_img2img": 16, "sd21_inpaint": 16, "sd3_img2img": 15,
              "sdxl_img2img": 15}
#: phase 13's steps a scheduler, and LCM's on the guidance-embedded UNet
SCHED_STEPS = 8
LCM_STEPS = 4
PATHS = {
    "sd21": dict(label="SD-2.1-base 512x512, 20 steps DPM++ 2M, CFG batch 2",
                 image_hw=(512, 512), latents=(1, 64, 64, 4), guidance=7.5,
                 scheduler="DPMSolverMultistep",
                 per_generation={"flash_attention": 301, "flash_attention_multi_q": 0,
                                 **VAE_ATTENTION, "group_norm_silu": 0,
                                 "palettized_dense_fused": 0,
                                 "geglu": GEGLU_PER_CALL["sd"] * STEPS}),
    "sd3": dict(label="SD3-medium 1024x1024 (no T5), 20 steps DiscreteFlow, CFG batch 2",
                image_hw=(1024, 1024), latents=(1, 128, 128, 16), guidance=4.5,
                scheduler="DiscreteFlow",
                per_generation={"flash_attention": 1, "flash_attention_multi_q": 480,
                                **VAE_ATTENTION, "group_norm_silu": 0,
                                "palettized_dense_fused": 0, "geglu": 0}),
    "sdxl": dict(label="SDXL-base 1024x1024, 20 steps DPM++ 2M, CFG batch 2, guidance 5",
                 image_hw=(1024, 1024), latents=(1, 128, 128, 4), guidance=5.0,
                 scheduler="DPMSolverMultistep",
                 per_generation={"flash_attention": 1401, "flash_attention_multi_q": 0,
                                 **VAE_ATTENTION, "group_norm_silu": 680,
                                 "palettized_dense_fused": 0,
                                 "geglu": GEGLU_PER_CALL["sdxl"] * STEPS}),
    "sdxl_refiner": dict(label="SDXL base + refiner 1024x1024, refiner_start 0.8 "
                               "(16 + 4 steps DPM++ 2M), CFG batch 2, guidance 5",
                         image_hw=(1024, 1024), latents=(1, 128, 128, 4), guidance=5.0,
                         scheduler="DPMSolverMultistep", extra=dict(refiner_start=0.8),
                         per_generation={"flash_attention": 1285,
                                         "flash_attention_multi_q": 0, **VAE_ATTENTION,
                                         "group_norm_silu": 720, "palettized_dense_fused": 0,
                                         "geglu": GEGLU_PER_CALL["sdxl"] * 16
                                         + GEGLU_PER_CALL["refiner"] * 4}),
}
PATHS.update({
    "sd15": dict(label="SD-1.5 512x512, the default configuration: 20 steps PNDM (21 UNet "
                       "calls), CFG batch 2, guidance 7.5",
                 image_hw=(512, 512), latents=(1, 64, 64, 4), guidance=7.5, scheduler="PNDM",
                 per_generation={"flash_attention": 15 * UNET_CALLS["sd15"] + 1,
                                 "flash_attention_multi_q": 0,
                                 **VAE_ATTENTION, "group_norm_silu": 0,
                                 "palettized_dense_fused": 0,
                                 "geglu": GEGLU_PER_CALL["sd"] * UNET_CALLS["sd15"]}),
    "sd21_img2img": dict(label="SD-2.1-base 512x512 img2img, strength 0.75: 15 of 20 steps "
                               "PNDM (16 UNet calls), CFG batch 2",
                         image_hw=(512, 512), latents=(1, 64, 64, 4), guidance=7.5,
                         scheduler="PNDM",
                         per_generation={"flash_attention": 15 * UNET_CALLS["sd21_img2img"] + 2,
                                         "flash_attention_multi_q": 0, **VAE_ATTENTION_ENCODE,
                                         "group_norm_silu": 0, "palettized_dense_fused": 0,
                                         "geglu": GEGLU_PER_CALL["sd"]
                                         * UNET_CALLS["sd21_img2img"]}),
    "sd3_img2img": dict(label="SD3-medium 1024x1024 img2img (no T5), strength 0.75: 15 of 20 "
                              "steps DiscreteFlow, CFG batch 2",
                        image_hw=(1024, 1024), latents=(1, 128, 128, 16), guidance=4.5,
                        scheduler="DiscreteFlow",
                        per_generation={"flash_attention": 2,
                                        "flash_attention_multi_q": 24 * UNET_CALLS["sd3_img2img"],
                                        **VAE_ATTENTION_ENCODE, "group_norm_silu": 0,
                                        "palettized_dense_fused": 0, "geglu": 0}),
    "sdxl_img2img": dict(label="SDXL-base 1024x1024 img2img, strength 0.75: 15 of 20 steps "
                               "DPM++ 2M, CFG batch 2, guidance 5",
                         image_hw=(1024, 1024), latents=(1, 128, 128, 4), guidance=5.0,
                         scheduler="DPMSolverMultistep",
                         per_generation={"flash_attention": 70 * UNET_CALLS["sdxl_img2img"] + 2,
                                         "flash_attention_multi_q": 0, **VAE_ATTENTION_ENCODE,
                                         "group_norm_silu": 34 * UNET_CALLS["sdxl_img2img"],
                                         "palettized_dense_fused": 0,
                                         "geglu": GEGLU_PER_CALL["sdxl"]
                                         * UNET_CALLS["sdxl_img2img"]}),
})
PATHS["sd21_inpaint"] = dict(PATHS["sd21_img2img"],
                             label="SD-2.1-base 512x512 inpainting (the left half), strength "
                                   "0.75: 15 of 20 steps PNDM (16 UNet calls), CFG batch 2")
#: phases 15 and 16: SD-1.5 512x512 features at the default configuration
#: (PNDM 20 steps: 21 UNet calls).  A UNet call launches 15 self-attention
#: heads at CFG batch 2; a ControlNet 6 at batch 1 (the positive half: two
#: transformers in each of down blocks 0-2; the mid block's 64 tokens stay
#: plain); cross attention over 256 context rows or more joins the 15 (a
#: 4-window prompt's 308, the multilingual projection's 256); serial CFG
#: makes two batch-1 calls of 15; a DeepCache shallow pass runs down block 0
#: (2 heads at 4096 tokens) and the last up block (3); a handler that stops
#: after step STOP_AFTER leaves the rest out; the safety checker adds none
SD15_CALLS = UNET_CALLS["sd15"]
DEEPCACHE_INTERVAL = 3
#: full passes of a DeepCache generation: calls 0, 3, ..., 18
DEEPCACHE_FULL = len(range(0, SD15_CALLS, DEEPCACHE_INTERVAL))
STOP_AFTER = 10


def _sd15_path(label, flash, geglu=GEGLU_PER_CALL["sd"] * SD15_CALLS):
    return dict(label=f"SD-1.5 512x512, PNDM 20 steps (21 UNet calls), CFG batch 2: {label}",
                image_hw=(512, 512), latents=(1, 64, 64, 4), guidance=7.5, scheduler="PNDM",
                per_generation={"flash_attention": flash, "flash_attention_multi_q": 0,
                                **VAE_ATTENTION, "group_norm_silu": 0,
                                "palettized_dense_fused": 0, "geglu": geglu})


PATHS.update({
    "sd15_controlnet": _sd15_path("one ControlNet", (15 + 6) * SD15_CALLS + 1,
                                  (GEGLU_PER_CALL["sd"] + GEGLU_PER_CALL["sd15_net"])
                                  * SD15_CALLS),
    "sd15_controlnet2": _sd15_path("two ControlNets", (15 + 12) * SD15_CALLS + 1,
                                   (GEGLU_PER_CALL["sd"] + 2 * GEGLU_PER_CALL["sd15_net"])
                                   * SD15_CALLS),
    "sd15_long_prompt": _sd15_path("a weighted prompt of four 77-token windows",
                                   30 * SD15_CALLS + 1),
    "sd15_multilingual": _sd15_path("the multilingual projection (256 context rows)",
                                    30 * SD15_CALLS + 1),
    "sd15_batch_one": _sd15_path("serial batch-1 CFG", 2 * 15 * SD15_CALLS + 1,
                                 2 * GEGLU_PER_CALL["sd"] * SD15_CALLS),
    "sd15_deepcache": _sd15_path(f"DeepCache at interval {DEEPCACHE_INTERVAL}",
                                 15 * DEEPCACHE_FULL + 5 * (SD15_CALLS - DEEPCACHE_FULL) + 1,
                                 GEGLU_PER_CALL["sd"] * DEEPCACHE_FULL
                                 + GEGLU_PER_CALL["shallow"] * (SD15_CALLS - DEEPCACHE_FULL)),
    "sd15_stop10": _sd15_path(f"a progress handler with previews that stops after step "
                              f"{STOP_AFTER}", 15 * STOP_AFTER + 1,
                              GEGLU_PER_CALL["sd"] * STOP_AFTER),
    "sd15_safety": _sd15_path("the safety checker on", 15 * SD15_CALLS + 1),
    "sdxl_controlnet": dict(
        label="SDXL-base 1024x1024 + one SDXL ControlNet, a weighted 2-window dual-encoder "
              "prompt, 20 steps DPM++ 2M, CFG batch 2, guidance 5",
        image_hw=(1024, 1024), latents=(1, 128, 128, 4), guidance=5.0,
        scheduler="DPMSolverMultistep",
        per_generation={"flash_attention": (70 + 34) * STEPS + 1, "flash_attention_multi_q": 0,
                        **VAE_ATTENTION, "group_norm_silu": 34 * STEPS,
                        "palettized_dense_fused": 0,
                        "geglu": (GEGLU_PER_CALL["sdxl"] + GEGLU_PER_CALL["sdxl_net"]) * STEPS}),
})
#: phase 21: the adapters on phase 11's SD-1.5 pipeline; each launches what
#: the path without it launches (the IP-Adapter's attention over 4 or 16
#: keys, its resampler and the vision tower stay plain, as in the JAX package)
PATHS.update({
    "sd15_lora": _sd15_path("a kohya LoRA (every UNet attention and FF projection, CLIP-L) "
                            "stacked with a PEFT one", 15 * SD15_CALLS + 1),
    "sd15_lora_cleared": _sd15_path("after clear_loras", 15 * SD15_CALLS + 1),
    "sd15_ti": _sd15_path("a textual-inversion placeholder", 15 * SD15_CALLS + 1),
    "sd15_ip_scale0": _sd15_path("IP-Adapter BASE at ip_adapter_scale 0", 15 * SD15_CALLS + 1),
    "sd15_ip_base": _sd15_path("IP-Adapter BASE (ViT-H/14, 4 tokens)", 15 * SD15_CALLS + 1),
    "sd15_ip_plus": _sd15_path("IP-Adapter PLUS (ViT-H/14 penultimate states, the resampler, "
                               "16 tokens)", 15 * SD15_CALLS + 1),
})
#: phase 22: the adapters on phase 7's SDXL base pipeline and phase 5's SD3
#: pipeline, each with its path's counts
SDXL_ADAPTER_PATHS = ("sdxl_lora", "sdxl_ti", "sdxl_ip")
PATHS.update({
    "sdxl_lora": dict(PATHS["sdxl"], label="SDXL-base 1024x1024, a kohya-sgm LoRA (UNet, "
                                           "lora_te1_, lora_te2_), 20 steps DPM++ 2M, CFG batch 2"),
    "sdxl_ti": dict(PATHS["sdxl"], label="SDXL-base 1024x1024, a clip_l/clip_g "
                                         "textual-inversion placeholder, 20 steps DPM++ 2M"),
    "sdxl_ip": dict(PATHS["sdxl"], label="SDXL-base 1024x1024, IP-Adapter (ViT-bigG/14, 4 "
                                         "tokens over 2048), 20 steps DPM++ 2M, CFG batch 2"),
    "sd3_lora": dict(PATHS["sd3"], label="SD3-medium 1024x1024 (no T5), a PEFT transformer. "
                                         "LoRA, 20 steps DiscreteFlow, CFG batch 2"),
})
#: the SD-1.5 paths at 512x512, each with the VAE decoder's head
SD15_PATHS = [p for p in PATHS if p.startswith("sd15")]
#: phases 18 and 19: SD3-medium 1024x1024 with T5-XXL, and with SD3
#: ControlNets: a net runs its 12 joint blocks at batch 1 (the positive
#: conditioning) a denoiser call, and its control image is VAE-encoded once
#: a generation (one more f32 D = 512 head)
SD3_NET_BLOCKS = 12


def _sd3_path(label, nets):
    heads = {name: 1 + nets for name in VAE_ATTENTION}
    return dict(label=f"SD3-medium 1024x1024, 20 steps DiscreteFlow, CFG batch 2: {label}",
                image_hw=(1024, 1024), latents=(1, 128, 128, 16), guidance=4.5,
                scheduler="DiscreteFlow",
                per_generation={"flash_attention": 1 + nets,
                                "flash_attention_multi_q": (24 + SD3_NET_BLOCKS * nets) * STEPS,
                                **heads, "group_norm_silu": 0, "palettized_dense_fused": 0,
                                "geglu": 0})


PATHS.update({
    "sd3_t5": _sd3_path("the T5-XXL encoder", 0),
    "sd3_controlnet": _sd3_path("one SD3 ControlNet (12 joint blocks)", 1),
    "sd3_controlnet2": _sd3_path("two SD3 ControlNets", 2),
    #: phase 20: phase 3's path on its modules reloaded from a diffusers
    #: directory
    "sd21_diffusers": dict(PATHS["sd21"], label="SD-2.1-base 512x512 loaded from a "
                           "diffusers directory, 20 steps DPM++ 2M, CFG batch 2"),
})


def sd15_self(tokens: int):
    """Launches per generation of the CFG-batch self-attention heads at
    ``tokens`` on each SD-1.5 path (5 a UNet call at each of 4096, 1024 and
    256 tokens)."""
    out = {p: 5 * SD15_CALLS for p in SD15_PATHS if p not in ("sd15_batch_one", "sd15_stop10",
                                                              "sd15_deepcache")}
    out["sd15_stop10"] = 5 * STOP_AFTER
    out["sd15_deepcache"] = 5 * DEEPCACHE_FULL + (
        5 * (SD15_CALLS - DEEPCACHE_FULL) if tokens == 4096 else 0)
    return out


#: phase 9: the SD-2.1 path on a palettized bundle, in each serving mode
for _mode in ("install", "program"):
    PATHS[f"sd21_pal_{_mode}"] = dict(
        PATHS["sd21"], label=f"SD-2.1-base 512x512 from a 6-bit palettized bundle, {_mode} "
                             "mode, 20 steps DPM++ 2M, CFG batch 2")
#: steps of each UNet in one generation of a path: (base, refiner)
UNET_STEPS = {"sdxl": (STEPS, 0), "sdxl_refiner": (16, 4), "sdxl_img2img": (15, 0),
              "sdxl_controlnet": (STEPS, 0), "sdxl_w8a8": (STEPS, 0),
              **{p: (STEPS, 0) for p in SDXL_ADAPTER_PATHS}}
#: the known half of an inpainted generation's latents against the starting
#: image's latents z0 (max abs, relative to z0's peak): after the last step
#: the known region is z0 itself, recomputed here by the same encoder
INPAINT_KNOWN_REL_ERR = 1e-5
#: the attention kernel entries (phase 7's plain-attention run launches none)
ATTENTION_KERNELS = ("flash_attention", "flash_attention_multi_q", *VAE_ATTENTION)
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


def sd21_all(n, img2img=None):
    """Launches per generation of the SD-2.1 path and its palettized runs,
    and ``img2img`` of its img2img and inpainting runs."""
    out = {p: n for p in ("sd21", "sd21_pal_install", "sd21_pal_program", "sd21_diffusers",
                          "sd21_w8a8", "sd21_w8a8_convs", "sd21_fused_qkv")}
    if img2img:
        out.update(sd21_img2img=img2img, sd21_inpaint=img2img)
    return out


#: (label, query stream lengths, Sk, B, H, D, dtype, {path: launches per
#: generation of that path})
FLASH_SHAPES = [
    ("unet 64x64", (4096,), 4096, 2, 5, 64, torch.bfloat16, sd21_all(100, 5 * 16)),
    ("unet 32x32", (1024,), 1024, 2, 10, 64, torch.bfloat16, sd21_all(100, 5 * 16)),
    ("unet 16x16", (256,), 256, 2, 20, 64, torch.bfloat16, sd21_all(100, 5 * 16)),
    ("vae mid 512", (4096,), 4096, 1, 1, 512, torch.float32,
     {**sd21_all(1, 2), **{p: 1 for p in SD15_PATHS}}),
    ("vae mid 1024", (16384,), 16384, 1, 1, 512, torch.float32,
     {"sd3": 1, "sdxl": 1, "sdxl_refiner": 1, "sd3_img2img": 2, "sdxl_img2img": 2,
      "sdxl_controlnet": 1, "sd3_t5": 1, "sd3_controlnet": 2, "sd3_controlnet2": 3,
      "sd3_lora": 1, "sd3_w8a8": 1, "sdxl_w8a8": 1, **{p: 1 for p in SDXL_ADAPTER_PATHS}}),
    ("sd15 64x64", (4096,), 4096, 2, 8, 40, torch.bfloat16, sd15_self(4096)),
    ("sd15 32x32", (1024,), 1024, 2, 8, 80, torch.bfloat16, sd15_self(1024)),
    ("sd15 16x16", (256,), 256, 2, 8, 160, torch.bfloat16, sd15_self(256)),
    # batch 1: the ControlNets (2 heads a net at each size) and serial CFG
    ("sd15 b1 64x64", (4096,), 4096, 1, 8, 40, torch.bfloat16,
     {"sd15_controlnet": 2 * SD15_CALLS, "sd15_controlnet2": 4 * SD15_CALLS,
      "sd15_batch_one": 10 * SD15_CALLS}),
    ("sd15 b1 32x32", (1024,), 1024, 1, 8, 80, torch.bfloat16,
     {"sd15_controlnet": 2 * SD15_CALLS, "sd15_controlnet2": 4 * SD15_CALLS,
      "sd15_batch_one": 10 * SD15_CALLS}),
    ("sd15 b1 16x16", (256,), 256, 1, 8, 160, torch.bfloat16,
     {"sd15_controlnet": 2 * SD15_CALLS, "sd15_controlnet2": 4 * SD15_CALLS,
      "sd15_batch_one": 10 * SD15_CALLS}),
    # cross attention: a 4-window prompt (308 keys = 2 x 128 + 52), the
    # multilingual projection (256)
    ("sd15 x308 64x64", (4096,), 308, 2, 8, 40, torch.bfloat16,
     {"sd15_long_prompt": 5 * SD15_CALLS}),
    ("sd15 x308 32x32", (1024,), 308, 2, 8, 80, torch.bfloat16,
     {"sd15_long_prompt": 5 * SD15_CALLS}),
    ("sd15 x308 16x16", (256,), 308, 2, 8, 160, torch.bfloat16,
     {"sd15_long_prompt": 5 * SD15_CALLS}),
    ("sd15 x256 64x64", (4096,), 256, 2, 8, 40, torch.bfloat16,
     {"sd15_multilingual": 5 * SD15_CALLS}),
    ("sd15 x256 32x32", (1024,), 256, 2, 8, 80, torch.bfloat16,
     {"sd15_multilingual": 5 * SD15_CALLS}),
    ("sd15 x256 16x16", (256,), 256, 2, 8, 160, torch.bfloat16,
     {"sd15_multilingual": 5 * SD15_CALLS}),
    ("ragged D80", (330,), 330, 2, 3, 80, torch.bfloat16, {}),
    ("sdxl 64x64", (4096,), 4096, 2, 10, 64, torch.bfloat16,
     {"sdxl": 10 * 20, "sdxl_refiner": 10 * 16, "sdxl_img2img": 10 * 15,
      "sdxl_controlnet": 10 * 20, "sdxl_w8a8": 10 * 20,
      **{p: 10 * 20 for p in SDXL_ADAPTER_PATHS}}),
    ("sdxl 32x32", (1024,), 1024, 2, 20, 64, torch.bfloat16,
     {"sdxl": 60 * 20, "sdxl_refiner": 60 * 16, "sdxl_img2img": 60 * 15,
      "sdxl_controlnet": 60 * 20, "sdxl_w8a8": 60 * 20,
      **{p: 60 * 20 for p in SDXL_ADAPTER_PATHS}}),
    # the SDXL ControlNet at batch 1: 4 heads at 4096 tokens, 30 at 1024
    ("sdxl cn 64x64", (4096,), 4096, 1, 10, 64, torch.bfloat16, {"sdxl_controlnet": 4 * 20}),
    ("sdxl cn 32x32", (1024,), 1024, 1, 20, 64, torch.bfloat16, {"sdxl_controlnet": 30 * 20}),
    ("refiner 64x64", (4096,), 4096, 2, 12, 64, torch.bfloat16, {"sdxl_refiner": 20 * 4}),
    ("refiner 32x32", (1024,), 1024, 2, 24, 64, torch.bfloat16, {"sdxl_refiner": 20 * 4}),
    ("refiner 16x16", (256,), 256, 2, 24, 64, torch.bfloat16, {"sdxl_refiner": 1 * 4}),
    ("vae ragged 512", (330,), 330, 1, 1, 512, torch.float32, {}),
    ("ragged f32", (330,), 330, 2, 3, 64, torch.float32, {}),
    ("ragged bf16", (330,), 330, 2, 3, 64, torch.bfloat16, {}),
]
MULTI_Q_SHAPES = [
    ("sd3 joint 1024", (4096, 154), 4250, 2, 24, 64, torch.bfloat16,
     {"sd3": 480, "sd3_img2img": 24 * 15, "sd3_t5": 480, "sd3_controlnet": 480,
      "sd3_controlnet2": 480, "sd3_lora": 480, "sd3_w8a8": 480}),
    # the SD3 ControlNets' joint blocks, at batch 1
    ("sd3 cn joint 1024", (4096, 154), 4250, 1, 24, 64, torch.bfloat16,
     {"sd3_controlnet": SD3_NET_BLOCKS * STEPS, "sd3_controlnet2": 2 * SD3_NET_BLOCKS * STEPS}),
    ("ragged f32", (384, 77), 461, 2, 3, 64, torch.float32, {}),
    ("ragged f32 512", (384, 77), 461, 1, 3, 512, torch.float32, {}),
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

    from ml_stable_diffusion_torch.ops.flash_attention import (
        SMS, bf16_plan, persistent_resident_blocks, wide_f32_plan)

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
        # the kernel and its instantiation: query rows a block, 64-column
        # chunks of a head, kv tile rows and stages; kv splits
        extra, fma_share = {}, 0.0
        if dtype == torch.bfloat16 and D != 512:
            plan = bf16_plan(q_lens, B, H, D)
            tile = (f"wgmma {plan.kernel} {plan.rows}-row, {plan.chunks} chunk(s), kv "
                    f"{plan.kv_rows} rows x {plan.stages} stages, {plan.q_buffers} q "
                    f"buffer(s), P v N={plan.pv_cols}, cluster {plan.cluster}, "
                    f"{plan.blocks} blocks")
            # the tensor cores' work with the head padded: q k^T over the
            # 16-column k-steps below D, P v over the plan's columns, the row
            # sums' product where the tensor cores take it
            done = (2 * B * H * sum(q_lens) * sk
                    * (16 * -(-D // 16) + plan.pv_cols + plan.sum_cols))
            extra = dict(bf16_plan=dataclasses.asdict(plan),
                         executed_ops_bound_ms=1e3 * done / PEAK_FLOPS[dtype])
            fma_share = plan.fma_exp_share
            if plan.kernel == "persistent":
                # the plan's grid assumes blocks_per_sm blocks on every SM at
                # once; the runtime says how many the card holds
                resident = persistent_resident_blocks(D, plan.rows)
                if resident != plan.blocks_per_sm * SMS:
                    fail(f"{label}: the card holds {resident} blocks of the persistent "
                         f"kernel at D={D}, {plan.rows}-row tiles; bf16_plan assumes "
                         f"{plan.blocks_per_sm * SMS}")
                tile += f", {resident} resident (runtime)"
        elif dtype == torch.float32 and D == 512:
            splits = wide_f32_plan(q_lens, sk, B, H).splits
            tile = f"wgmma 3xtf32 64-row, {splits} kv split(s)"
        else:
            tile = "fma"
        # one exponential a logit, less those the kernel hands the FMA pipe
        exp_floor_ms = 1e3 * B * H * sum(q_lens) * sk * (1 - fma_share) / SFU_EXP_PER_S
        row = dict(label=label, q_lens=list(q_lens), sk=sk, B=B, H=H, D=D,
                   dtype=str(dtype).split(".")[-1], tile=tile, **extra,
                   exp_floor_ms=exp_floor_ms, fma_exp_share=fma_share,
                   launches_per_generation=per_gen,
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
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})  exp floor "
            f"{row['exp_floor_ms']:.4f} ms (FMA share {row['fma_exp_share']:.3g})"
            + (f"  executed-ops bound {row['executed_ops_bound_ms']:.4f} ms"
               if "executed_ops_bound_ms" in row else ""))
    return rows


def check_split_prepass(shapes):
    """The 3xTF32 kernel's pre-pass (``flash_split_tf32_cuda``) at every f32
    D = 512 shape of ``shapes``: its planes against the plain split bit for
    bit (the same rounding: tolerance 0), and its time beside the plain
    version's and its bound (q, k and v read once, the six planes written
    once).  No PyTorch call computes the split."""
    from ml_stable_diffusion_torch.ops.flash_attention import (
        flash_split_tf32_cuda,
        flash_split_tf32_reference,
        wide_f32_plan,
        wide_f32_planes,
    )

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows, calls = [], []
    for label, q_lens, sk, B, H, D, dtype, per_gen in shapes:
        if (dtype, D) != (torch.float32, 512):
            continue
        qs = [torch.randn((B, n, H, D), generator=gen, device="cuda") for n in q_lens]
        k, v = (torch.randn((B, sk, H, D), generator=gen, device="cuda") for _ in range(2))
        plan = wide_f32_plan(q_lens, sk, B, H)
        ws = torch.full((plan.workspace_bytes // 4,), math.nan, device="cuda")
        kernel = functools.partial(flash_split_tf32_cuda, qs, k, v, plan, ws)

        def plain():
            return flash_split_tf32_reference(qs, k, v, plan)

        kernel()
        torch.cuda.synchronize()
        err = max((got - want).abs().max().item()
                  for got, want in zip(wide_f32_planes(ws, plan, B, H), plain()))
        if not err == 0.0:
            fail(f"flash_split_tf32 {label}: the pre-pass's planes differ from the plain "
                 f"split by {err} (want 0)")
        planes = 2 * B * H * D * (plan.rows + 2 * plan.keys)
        nbytes = 4 * (sum(q.numel() for q in qs) + k.numel() + v.numel() + planes)
        t_bytes = nbytes / PEAK_BYTES_PER_S
        slow = t_bytes > 1e-3
        rows.append(dict(label=label, q_lens=list(q_lens), sk=sk, B=B, H=H, D=D,
                         dtype="float32", splits=plan.splits,
                         launches_per_generation=per_gen, max_abs_err=err, atol=0.0,
                         ms=time_ms(kernel, reps=3 if slow else 20),
                         plain_ms=time_ms(plain, reps=1 if slow else 3), library_ms=None,
                         library_device_ms=None, bound_ms=1e3 * t_bytes, bound_by="bytes"))
        calls.append(kernel)
    add_device_ms(rows, {"device_ms": calls})
    for row in rows:
        log(f"split {row['label']:15s} q {row['q_lens']} k {row['sk']} B{row['B']} H{row['H']} "
            f"D{row['D']} [{row['splits']} kv split(s)] planes equal to the plain split "
            f"(max abs err {row['max_abs_err']:.3g}) kernel {row['ms']:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])})  plain {row['plain_ms']:.4f} ms  bound "
            f"{row['bound_ms']:.4f} ms (bytes)")
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
    # ragged runs; the last, 3.9 MB a group in f32, takes the streaming plan
    rows += [("ragged f32", (2, 96, 7, 9), torch.float32, True, {}),
             ("ragged bf16", (2, 96, 7, 9), torch.bfloat16, True, {}),
             ("ragged bf16 no silu", (2, 96, 7, 9), torch.bfloat16, False, {}),
             ("ragged f32 streaming", (1, 64, 701, 701), torch.float32, True, {})]
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
        launch_plan,
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
        plan = launch_plan(B, C, groups, H * W, dtype)
        row = dict(label=label, shape=[B, C, H, W], groups=groups,
                   dtype=str(dtype).split(".")[-1], apply_silu=silu,
                   plan=dict(cluster=plan.cluster, resident=plan.resident,
                             slice_bytes=plan.slice_bytes, blocks=plan.blocks, waves=plan.waves),
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
        cut_rel, plan = row["dropped_channel_rel_rms"], row["plan"]
        plan_s = (f"cluster {plan['cluster']}, "
                  + (f"{plan['slice_bytes']} B slice in smem" if plan["resident"] else "streaming")
                  + f", {plan['blocks']} blocks, {plan['waves']} wave(s)")
        log(f"gn {label:22s} {(B, C, H, W)} {row['dtype']:8s} silu {int(silu)} [{plan_s}] "
            f"err {err:.3g} "
            f"(atol {GN_ATOL[dtype]}) rel RMS {rel:.3g} (tol {GN_REL_RMS[dtype]}; without "
            f"the last channel: {cut_rel:.3g} rel) kernel {row['ms']:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])})  plain {row['plain_ms']:.4f} ms  group_norm+silu "
            f"{row['library_ms']:.4f} ms (device {fmt_ms(row['library_device_ms'])})  bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
            f"  launches {per_gen}")
    return rows


#: the GEGLU gate's shapes (tokens a sample, n = 4 x channels, feed-forwards
#: a UNet call) of the two benchmark cells: sdxl-grid4 (SDXL base at 1024²,
#: CFG batch 8, 30 steps) and sd21-serve (SD-2.1 at 512², CFG batch 2 to 8,
#: 20 steps)
GEGLU_CELLS = {"sdxl-grid4": (8, 30, [(4096, 2560, 10), (1024, 5120, 60)]),
               "sd21-serve": (2, 20, [(4096, 1280, 5), (1024, 2560, 5), (256, 5120, 5),
                                      (64, 5120, 1)])}


def geglu_shapes():
    """(label, cell, rows, n, dtype, launches per generation) of each GEGLU
    shape of the two cells; sd21-serve's at batch 2 (one image) and 8 (four),
    sdxl-grid4's at its batch 8."""
    out = []
    for cell, (batch, steps, shapes) in GEGLU_CELLS.items():
        for b in sorted({batch, 8}):
            for tokens, n, calls in shapes:
                out.append((f"{cell} {b}x{tokens}x{n}", cell, b * tokens, n, torch.bfloat16,
                            calls * steps if b == batch else 0))
    return out


def _geglu_chain(h):
    from ml_stable_diffusion_torch.ops.activations import gelu_erf

    a, gate = h.chunk(2, dim=-1)
    return a * gelu_erf(gate)


def check_geglu_kernel(shapes):
    """Each shape: the GEGLU kernel bit-equal to the eager chain it replaces
    (chunk, gelu_erf, the product), on gate values over [-12, 12]; device ms
    per launch of each, by the profiler, and CUDA-event ms; the bound, h read
    once and the output written once over 3.35 TB/s.  Then each cell's
    generation: launches x per-launch times, against its least time."""
    from ml_stable_diffusion_torch.ops.activations import geglu_cuda

    gen = torch.Generator(device="cuda").manual_seed(22)
    rows, calls, chains = [], [], []
    for label, cell, m, n, dtype, per_gen in shapes:
        h = (4.0 * torch.randn(m, 2 * n, generator=gen, device="cuda")).to(dtype)
        kernel = functools.partial(geglu_cuda, h)
        chain = functools.partial(_geglu_chain, h)
        got, want = kernel(), chain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"geglu {label}: kernel differs from the eager chain by up to "
                 f"{(got.float() - want.float()).abs().max().item()}")
        bound_s = (h.numel() + got.numel()) * h.element_size() / PEAK_BYTES_PER_S
        rows.append(dict(label=label, cell=cell, shape=[m, 2 * n], dtype=str(dtype).split(".")[-1],
                         bit_equal=True, max_abs_err=0.0, launches_per_generation=per_gen,
                         ms=time_ms(kernel, reps=20), chain_ms=time_ms(chain, reps=5),
                         bound_ms=1e3 * bound_s, bound_by="bytes"))
        calls.append(kernel)
        chains.append(chain)
    add_device_ms(rows, {"device_ms": calls, "chain_device_ms": chains})
    for row in rows:
        dev = row["device_ms"]
        share = "not measured" if dev is None else f"{100 * row['bound_ms'] / dev:.1f} %"
        log(f"geglu {row['label']:28s} {row['shape']} {row['dtype']} bit-equal; kernel "
            f"{row['ms']:.4f} ms (device {fmt_ms(dev)}, {share} of its bound)  eager chain "
            f"{row['chain_ms']:.4f} ms (device {fmt_ms(row['chain_device_ms'])})  bound "
            f"{row['bound_ms']:.4f} ms  launches a generation {row['launches_per_generation']}")
    for cell in GEGLU_CELLS:
        counted = [r for r in rows if r["cell"] == cell and r["launches_per_generation"]]
        per_gen = {key: total(None if r[key] is None else r[key] * r["launches_per_generation"]
                              for r in counted)
                   for key in ("device_ms", "chain_device_ms", "bound_ms")}
        log(f"geglu per {cell} generation: kernel {fmt_ms(per_gen['device_ms'])} ms, eager chain "
            f"{fmt_ms(per_gen['chain_device_ms'])} ms, bound {per_gen['bound_ms']:.2f} ms "
            f"({sum(r['launches_per_generation'] for r in counted)} launches)")
        for row in counted:
            row["per_generation"] = per_gen
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
    rows["flash_split_tf32"] = check_split_prepass(FLASH_SHAPES + MULTI_Q_SHAPES)
    # the f32 D = 512 rows of flash_attention: the 3xTF32 kernel's
    rows["flash_attention_wide_f32"] = [r for r in rows["flash_attention"]
                                        if (r["dtype"], r["D"]) == ("float32", 512)]
    for name, kernel_rows in rows.items():
        check_shape_launches(name, kernel_rows)
    rows["palettized_dense_fused"] = check_pal_kernel(pal_rows)
    # the GEGLU gate runs on every UNet path; its rows are the two cells'
    # shapes, not counted against PATHS
    rows["geglu"] = check_geglu_kernel(geglu_shapes())
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


def build_sd15_pipeline(tokdir: Path):
    """SD-1.5: CLIP-L (f32), ``UNetConfig.sd15`` (bf16), the VAE decoder
    (f32), speed weights."""
    from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
    from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEDecoder
    from ml_stable_diffusion_torch.pipelines import StableDiffusionPipeline

    gen = torch.Generator(device="cuda").manual_seed(15)
    with torch.device("meta"):
        te = CLIPTextEncoder(CLIPTextConfig.sd1())
        unet = UNet2DConditionModel(UNetConfig.sd15())
        vae = VAEDecoder(VAEConfig.sd())
    return StableDiffusionPipeline(
        tokenizer=letters_tokenizer(tokdir), text_encoder=materialize(te, gen),
        unet=materialize(unet, gen, torch.bfloat16), vae_decoder=materialize(vae, gen),
        device="cuda")


def with_encoder(pipe, seed: int):
    """The same pipeline over the same modules plus a full-width VAE encoder
    (f32, speed weights) for the pipeline's latent channels."""
    from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEEncoder

    cfg = VAEConfig.sd3() if pipe.latent_channels == 16 else VAEConfig.sd()
    with torch.device("meta"):
        enc = VAEEncoder(cfg)
    enc = materialize(enc, torch.Generator(device="cuda").manual_seed(seed))
    out = copy.copy(pipe)
    out.vae_encoder = enc.eval()
    return out


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
                    "sdxl": build_sdxl_pipeline, "sd15": build_sd15_pipeline}


def reset_counters(counters):
    for fn in counters.values():
        fn.launches = 0


def free_card():
    """Release what finished phases left on the card: a pipeline and its
    captured programs hold each other, so collect them before the
    allocator's cache is emptied."""
    gc.collect()
    torch.cuda.empty_cache()


def own_launches(pipe, counters, before, warm_before):
    """The launches of a generation itself, eager or credited by a replay:
    the counters' growth since ``before`` less the warm-ups of the programs
    it captured (real launches, made once a program; ``warm_before`` is
    ``pipe.programs.warmup_launches`` as it was)."""
    warm = pipe.programs.warmup_launches
    return {name: fn.launches - before[name] - (warm.get(name, 0) - warm_before.get(name, 0))
            for name, fn in counters.items()}


def launches_of(pipe, counters, fn):
    """-> (``fn()``, the launches it made itself (``own_launches``), its
    programs' warm-up launches)."""
    before = {name: f.launches for name, f in counters.items()}
    warm_before = dict(pipe.programs.warmup_launches)
    out = fn()
    own = own_launches(pipe, counters, before, warm_before)
    warm = {name: pipe.programs.warmup_launches.get(name, 0) - warm_before.get(name, 0)
            for name in counters}
    return out, own, warm


def reserved_gib() -> float:
    return torch.cuda.memory_reserved() / 2**30


def run_main_path(pipe, path, counters, timed=3, plain=True, warmup=True, extra=None,
                  results=None):
    """One warm-up (``warmup``) and ``timed`` generations with distinct
    prompts and seeds, the counters set to 0 just before and read just
    after (``launches``: every launch, the captures' warm-ups among them;
    each generation's own launches must be the path's); then (``plain``)
    the last generation again with attention forced to the plain path.  ``extra``: more configuration fields (the starting
    image and mask, the control images, a prompt); ``results``: a list that
    receives the generations' results."""
    spec = PATHS[path]

    def generate(i, attention="auto"):
        cfg = main_cfg(path, i, attention_implementation=attention, **(extra or {}))
        t0 = time.perf_counter()
        res, launched, warm = launches_of(
            pipe, counters, lambda: pipe.generate_images(cfg, image_hw=spec["image_hw"]))
        seconds = time.perf_counter() - t0  # the images reach the host in it
        for name, n in warm.items():
            warmups[name] = warmups.get(name, 0) + n
        want = (1, *spec["image_hw"], 3)
        if res.images.shape != want or res.images.dtype.name != "uint8":
            fail(f"{path}: images {res.images.shape} {res.images.dtype}, want {want} uint8")
        if res.latents.shape != spec["latents"] or not bool(
                torch.isfinite(torch.from_numpy(res.latents)).all()):
            fail(f"{path}: latents {res.latents.shape} not finite or not {spec['latents']}")
        return res, launched, seconds

    warmups = {}  # the captures' warm-up launches
    reset_counters(counters)
    t0 = time.perf_counter()
    runs = [generate(i) for i in range(int(warmup) + timed)]  # warm-up + timed
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    for _, launched, _ in runs:
        if launched != spec["per_generation"]:
            fail(f"{path}: a generation launched {launched}, want {spec['per_generation']}")
    sps = statistics.median(r.seconds_per_step for r, _, _ in runs[int(warmup):])
    spi = statistics.median(secs for _, _, secs in runs[int(warmup):])
    out = dict(seconds_per_step=sps, iter_per_s=1.0 / sps, seconds_per_image=spi,
               seconds_per_step_runs=[r.seconds_per_step for r, _, _ in runs],
               seconds_per_image_runs=[secs for _, _, secs in runs],
               wall_s_generations=wall, launches=launches, capture_warmup_launches=warmups,
               first_call=not warmup and any(warmups.values()),
               memory_reserved_gib=reserved_gib())
    if results is not None:
        results.extend(r for r, _, _ in runs)
    if not plain:
        return out
    # the same generation with attention forced to the plain path, on the
    # eager loop.  On these
    # N(0, 0.02) weights q.k is near zero and attention nearly uniform, so
    # this shows the plain path runs end to end more than it tests the
    # kernel: phases 4, 6 and 8, on variance-preserving weights, are the
    # in-model checks.  The GroupNorm kernel stays on.
    pipe.execution = "eager"  # a check of the plain path: no program of its own
    try:
        res, plain_launched, plain_secs = generate(len(runs) - 1, attention="plain")
    finally:
        pipe.execution = "program"
    want = {name: 0 if name in ATTENTION_KERNELS else n
            for name, n in spec["per_generation"].items()}
    if plain_launched != want:
        fail(f"{path}: attention_implementation='plain' launched {plain_launched}, "
             f"want {want}")
    rel = float(abs(runs[-1][0].latents - res.latents).max()
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


# -- phases 11 to 14 -----------------------------------------------------------------

def check_unet_calls():
    """UNET_CALLS against the schedulers' own plans (``plan.num_steps``)."""
    from ml_stable_diffusion_torch.schedulers import SCHEDULER_MAP

    for path, want in UNET_CALLS.items():
        spec = PATHS[path]
        strength = 1.0 if path == "sd15" else STRENGTH
        got = SCHEDULER_MAP[spec["scheduler"]]().set_timesteps(STEPS, strength=strength)
        if got.num_steps != want:
            fail(f"{path}: {spec['scheduler']} at strength {strength} plans {got.num_steps} "
                 f"UNet calls, the launch counts assume {want}")


def check_sd15_flash_vs_plain(counter):
    """Phase 11's model check: one full-width SD-1.5 UNet forward (heads of
    width 40, 80 and 160), variance-preserving weights."""
    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig

    gen = torch.Generator(device="cuda").manual_seed(11)
    with torch.device("meta"):
        unet = UNet2DConditionModel(UNetConfig.sd15())
    unet = materialize(unet, gen, torch.bfloat16, std=None)
    inputs = (torch.randn(2, 4, 64, 64, generator=gen, device="cuda"),
              torch.tensor(500.0, device="cuda"),
              torch.randn(2, 77, 768, generator=gen, device="cuda"))
    return check_model_flash_vs_plain("sd15 unet", unet, inputs, counter, 15)


def starting_image(hw, seed: int):
    """A seeded (1, H, W, 3) float32 image in [-1, 1]."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((1, *hw, 3), generator=gen) * 2 - 1).numpy()


def left_half_mask(hw):
    """(H, W) float32: 1 (repaint) on the left half, 0 on the right."""
    mask = torch.zeros(hw)
    mask[:, : hw[1] // 2] = 1.0
    return mask.numpy()


def check_inpaint_known_half(pipe, image, results):
    """After the last step the known (right) half of the latents is the
    starting image's latents z0 itself: recompute z0 from the same encoder
    and host noise (seed 1000 + i of generation i) and compare; the
    repainted half must differ from it."""
    from ml_stable_diffusion_torch.models.vae import sample_diagonal_gaussian
    from ml_stable_diffusion_torch.utils.rng import make_random_source

    worst = 0.0
    x = torch.from_numpy(image).cuda().permute(0, 3, 1, 2).contiguous()
    for i, res in enumerate(results):
        h, w = res.latents.shape[1:3]
        noise = torch.from_numpy(make_random_source("numpy", 1000 + i).normal((1, 4, h, w)))
        with torch.inference_mode():
            z0 = sample_diagonal_gaussian(pipe.vae_encoder(x), noise.cuda())
            z0 = (z0 * pipe.default_latent_scale).permute(0, 2, 3, 1).cpu()
        got = torch.from_numpy(res.latents)
        peak = z0.abs().max().item()
        known = (got[:, :, w // 2:] - z0[:, :, w // 2:]).abs().max().item() / peak
        repainted = (got[:, :, : w // 2] - z0[:, :, : w // 2]).abs().max().item() / peak
        if not known <= INPAINT_KNOWN_REL_ERR:
            fail(f"inpainting: the known half of generation {i} is {known} (rel) from z0, "
                 f"> {INPAINT_KNOWN_REL_ERR}")
        if not repainted > 1e-2:
            fail(f"inpainting: the repainted half of generation {i} stayed at z0 ({repainted})")
        worst = max(worst, known)
    log(f"inpainting: the known half within {worst:.3g} (rel) of the starting image's "
        f"latents z0 (bound {INPAINT_KNOWN_REL_ERR}) in {len(results)} generations")
    return dict(known_half_max_rel_err=worst, bound=INPAINT_KNOWN_REL_ERR)


def run_img2img_paths(pipe, counters, report):
    """Phase 12 on the SD-2.1 pipeline plus a VAE encoder: img2img, then
    inpainting of the left half.  -> ({path: timings and counts}, the
    inpainting check)."""
    enc_pipe = with_encoder(pipe, 12)
    image = starting_image((512, 512), 12)
    out = {}
    out["sd21_img2img"] = run_main_path(enc_pipe, "sd21_img2img", counters, timed=1,
                                        plain=False,
                                        extra=dict(starting_image=image, strength=STRENGTH))
    report("sd21_img2img", out["sd21_img2img"])
    results = []
    out["sd21_inpaint"] = run_main_path(
        enc_pipe, "sd21_inpaint", counters, timed=1, plain=False, results=results,
        extra=dict(starting_image=image, strength=STRENGTH,
                   mask_image=left_half_mask((512, 512))))
    report("sd21_inpaint", out["sd21_inpaint"])
    return out, check_inpaint_known_half(enc_pipe, image, results)


def run_scheduler_sweep(pipe, counters):
    """Phase 13: every scheduler on the SD-2.1 pipeline at SCHED_STEPS steps,
    one generation each, then LCM on a full-width guidance-embedded UNet
    (``time_cond_proj_dim=256``) at LCM_STEPS steps without CFG: finite
    latents and the launch counts of each generation."""
    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
    from ml_stable_diffusion_torch.pipelines import PipelineConfiguration
    from ml_stable_diffusion_torch.schedulers import SCHEDULER_MAP

    gen = torch.Generator(device="cuda").manual_seed(13)
    with torch.device("meta"):
        lcm_unet = UNet2DConditionModel(dataclasses.replace(UNetConfig.sd21(),
                                                            time_cond_proj_dim=256))
    lcm_pipe = copy.copy(pipe)
    lcm_pipe.unet = materialize(lcm_unet, gen, torch.bfloat16).eval()
    runs = [(name, pipe, name, SCHED_STEPS, 7.5) for name in sorted(SCHEDULER_MAP)]
    runs.append(("LCM, guidance-embedded UNet", lcm_pipe, "LCM", LCM_STEPS, 8.0))
    out = {}
    for k, (label, p, name, steps, guidance) in enumerate(runs):
        calls = SCHEDULER_MAP[name]().set_timesteps(steps).num_steps
        want = {"flash_attention": 15 * calls + 1, "flash_attention_multi_q": 0,
                **VAE_ATTENTION, "group_norm_silu": 0, "palettized_dense_fused": 0,
                "geglu": GEGLU_PER_CALL["sd"] * calls}
        cfg = PipelineConfiguration(prompt=PROMPTS[k % len(PROMPTS)], step_count=steps,
                                    guidance_scale=guidance, seed=2000 + k, scheduler=name,
                                    rng="numpy", disable_safety=True)
        reset_counters(counters)
        t0 = time.perf_counter()
        res, launched, _ = launches_of(p, counters,
                                   lambda: p.generate_images(cfg, image_hw=(512, 512)))
        seconds = time.perf_counter() - t0  # a first call: it captures its program
        if launched != want:
            fail(f"scheduler {label}: a generation launched {launched}, want {want}")
        if res.latents.shape != (1, 64, 64, 4) or not bool(
                torch.isfinite(torch.from_numpy(res.latents)).all()):
            fail(f"scheduler {label}: latents {res.latents.shape} not finite")
        out[label] = dict(unet_calls=calls, seconds_per_step=res.seconds_per_step,
                          seconds_per_image=seconds, launches=launched)
        log(f"scheduler {label}: {steps} steps ({calls} UNet calls, CFG "
            f"{'off' if p is lcm_pipe else 'on'}): {res.seconds_per_step * 1e3:.2f} ms/step, "
            f"{seconds:.3f} s/image, launches {launched}")
    del lcm_pipe
    return out


# -- phases 15 to 17 ----------------------------------------------------------------

#: phase 16's weighted prompt of four 77-token windows (239 letter tokens),
#: phase 17's of two (133)
LONG_PROMPT = (f"({PROMPTS[0]}:1.3) {' '.join(PROMPTS[1:])} [{PROMPTS[0]}] "
               f"{' '.join(PROMPTS[1:])} ({PROMPTS[2]})")
XL_PROMPT = f"({PROMPTS[0]}:1.2) {' '.join(PROMPTS[1:])} [{PROMPTS[3]}]"
#: the one-net latents against phase 11's of the same prompt and seed
#: (relative max abs): without the net they are the same bits; N(0, 0.02)
#: weights move them by ~3e-3
CONTROLNET_MIN_REL = 1e-4
#: serial batch-1 CFG against the batched generation: relative max abs of
#: the latents (bf16 products at batch 1 and 2 may round differently)
BATCH_ONE_REL_ERR = 1e-3


def build_controlnet(cfg, seed: int):
    """A full-width ControlNet of the UNet config ``cfg`` in bf16 on the card
    with speed weights from ``seed``: its zero convs are N(0, 0.02) too, so
    the residuals move the latents.  Its conditioning channels are (16, 32,
    96, 256), those of lllyasviel/control_v11p_sd15_canny and
    diffusers/controlnet-canny-sdxl-1.0 (named, not downloaded)."""
    from ml_stable_diffusion_torch.models.controlnet import ControlNetModel

    with torch.device("meta"):
        net = ControlNetModel(cfg)
    return materialize(net, torch.Generator(device="cuda").manual_seed(seed),
                       torch.bfloat16).eval()


def control_image(hw, seed: int):
    """A seeded (1, H, W, 3) float32 edge-map-like image of 0s and 1s."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((1, *hw, 3), generator=gen) > 0.9).float().numpy()


def with_modules(pipe, **attrs):
    """The same pipeline over the same modules, with ``attrs`` set."""
    out = copy.copy(pipe)
    for name, value in attrs.items():
        setattr(out, name, value)
    return out


def latents_rel(got, ref) -> float:
    return float(abs(got - ref).max() / max(abs(ref).max(), 1e-12))


def check_windows(tokenizer, prompt, want: int):
    from ml_stable_diffusion_torch.tokenizer.prompt_weights import weighted_token_chunks

    ids, _, weighted = weighted_token_chunks(tokenizer, prompt)
    if ids.shape[0] != want or not weighted:
        fail(f"the prompt spans {ids.shape[0]} windows (weighted: {weighted}), want {want}, "
             "weighted")


def run_controlnet_paths(pipe, counters, report, sd15_results):
    """Phase 15 on phase 11's SD-1.5 pipeline: one ControlNet (warm-up,
    median of 3, one generation forced plain), two ControlNets (one
    generation), and the one-net latents against phase 11's generation of
    the same prompt and seed without a net."""
    from ml_stable_diffusion_torch.models.unet import UNetConfig

    nets = [build_controlnet(UNetConfig.sd15(), 150), build_controlnet(UNetConfig.sd15(), 151)]
    conds = [control_image((512, 512), 152), control_image((512, 512), 153)]
    out, results = {}, []
    out["sd15_controlnet"] = run_main_path(with_modules(pipe, controlnets=nets[:1]),
                                           "sd15_controlnet", counters, results=results,
                                           extra=dict(controlnet_inputs=conds[:1]))
    report("sd15_controlnet", out["sd15_controlnet"])
    out["sd15_controlnet2"] = run_main_path(with_modules(pipe, controlnets=nets),
                                            "sd15_controlnet2", counters, timed=1, plain=False,
                                            warmup=False, extra=dict(controlnet_inputs=conds))
    report("sd15_controlnet2", out["sd15_controlnet2"])
    rel = latents_rel(results[0].latents, sd15_results[0].latents)
    log(f"sd15 ControlNet: latents with the net differ from those without by {rel:.4g} (rel)")
    if not rel > CONTROLNET_MIN_REL:
        fail(f"the ControlNet did not move the latents: rel {rel} <= {CONTROLNET_MIN_REL}")
    return out, dict(with_vs_without_latents_rel=rel)


def host_embedder(text: str):
    """A deterministic stand-in for an external multilingual embedding model:
    text -> (len(text) rows, at most 64, 512)."""
    rng = torch.Generator().manual_seed(sum(map(ord, text)) % 2 ** 31)
    return torch.randn((max(1, min(len(text), 64)), 512), generator=rng).numpy()


def run_handler_path(pipe, counters):
    """One generation with a progress handler that renders a latent preview
    of each step's denoised latents and stops after step STOP_AFTER."""
    import numpy as np

    from ml_stable_diffusion_torch.pipelines import PipelineConfiguration
    from ml_stable_diffusion_torch.utils.latent_preview import latent_to_rgb_preview

    seen = []

    def handler(progress):
        preview = latent_to_rgb_preview(progress.denoised)
        seen.append((progress.step, progress.step_count, preview.shape,
                     bool(np.isfinite(preview).all())))
        return progress.step < STOP_AFTER

    spec = PATHS["sd15_stop10"]
    cfg = PipelineConfiguration(prompt=PROMPTS[0], step_count=STEPS, guidance_scale=7.5,
                                seed=1000, scheduler="PNDM", rng="numpy", disable_safety=True,
                                use_denoised_intermediates=True)
    reset_counters(counters)
    t0 = time.perf_counter()
    res, launched, _ = launches_of(pipe, counters, lambda: pipe.generate_images(
        cfg, progress_handler=handler, image_hw=(512, 512)))
    seconds = time.perf_counter() - t0
    if launched != spec["per_generation"]:
        fail(f"sd15_stop10: the generation launched {launched}, want {spec['per_generation']}")
    want = [(i, SD15_CALLS, (1, 64, 64, 3), True) for i in range(1, STOP_AFTER + 1)]
    if seen != want:
        fail(f"sd15_stop10: the handler saw {seen}, want {want}")
    if res.images.shape != (1, 512, 512, 3) or not np.isfinite(res.latents).all():
        fail(f"sd15_stop10: images {res.images.shape}, latents finite: "
             f"{np.isfinite(res.latents).all()}")
    return dict(seconds_per_step=res.seconds_per_step, iter_per_s=1.0 / res.seconds_per_step,
                seconds_per_image=seconds, launches=launched, steps_seen=len(seen))


def run_feature_paths(pipe, counters, report, sd15_results):
    """Phase 16 on phase 11's SD-1.5 pipeline, one generation each: a
    weighted 4-window prompt, the multilingual projection, DeepCache, serial
    CFG (its latents held against phase 11's batched generation of the same
    prompt and seed), a progress handler that stops early, and the safety
    checker (its ms per image and flags)."""
    import numpy as np

    from ml_stable_diffusion_torch.models.multilingual import MultilingualProjection
    from ml_stable_diffusion_torch.models.safety import (
        SafetyChecker,
        SafetyCheckerConfig,
        check_images,
    )

    gen = torch.Generator(device="cuda").manual_seed(16)
    one = dict(timed=1, plain=False, warmup=False)
    out, checks = {}, {}
    check_windows(pipe.tokenizer, LONG_PROMPT, 4)
    out["sd15_long_prompt"] = run_main_path(pipe, "sd15_long_prompt", counters,
                                            extra=dict(prompt=LONG_PROMPT), **one)
    with torch.device("meta"):
        proj = MultilingualProjection(pipe.unet.config.cross_attention_dim)
    ml = with_modules(pipe, multilingual_encoder=(materialize(proj, gen).eval(), host_embedder))
    out["sd15_multilingual"] = run_main_path(ml, "sd15_multilingual", counters, **one)
    out["sd15_deepcache"] = run_main_path(pipe, "sd15_deepcache", counters,
                                          extra=dict(deepcache_interval=DEEPCACHE_INTERVAL), **one)
    results = []
    out["sd15_batch_one"] = run_main_path(pipe, "sd15_batch_one", counters, results=results,
                                          extra=dict(unet_batch_one=True), **one)
    rel = latents_rel(results[0].latents, sd15_results[0].latents)
    if not rel <= BATCH_ONE_REL_ERR:
        fail(f"serial CFG latents differ from the batched ones by {rel} (rel) > "
             f"{BATCH_ONE_REL_ERR}")
    checks["batch_one_vs_batched_latents_rel"] = rel
    out["sd15_stop10"] = run_handler_path(pipe, counters)
    with torch.device("meta"):
        checker = SafetyChecker(SafetyCheckerConfig())
    checker = materialize(checker, gen).eval()
    results = []
    out["sd15_safety"] = run_main_path(with_modules(pipe, safety_checker=checker), "sd15_safety",
                                       counters, results=results,
                                       extra=dict(disable_safety=False), **one)
    res = results[0]
    flagged = [bool(res.images[i].max() == 0) for i in range(len(res.nsfw_flags))]
    if [f for f, z in zip(res.nsfw_flags, flagged) if f and not z]:
        fail(f"the safety checker flagged {res.nsfw_flags} but left an image unblanked")
    images = sd15_results[0].images
    check_images(checker, images)  # warm-up
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        check_images(checker, images)  # ends in a host copy of the flags
        times.append(time.perf_counter() - t0)
    checks["safety"] = dict(ms_per_image=1e3 * statistics.median(times) / len(images),
                            flags=res.nsfw_flags)
    log(f"safety checker (ViT-L/14, f32, plain attention): "
        f"{checks['safety']['ms_per_image']:.2f} ms per 512x512 image, flags {res.nsfw_flags}; "
        f"serial CFG vs batched latents {rel:.3g} (rel)")
    for path, res in out.items():
        report(path, res)
    return out, checks


def run_sdxl_controlnet_path(pipe, counters, report):
    """Phase 17 on phase 7's SDXL base pipeline: one generation with one
    SDXL ControlNet and a weighted 2-window dual-encoder prompt."""
    from ml_stable_diffusion_torch.models.unet import UNetConfig

    check_windows(pipe.tokenizer2, XL_PROMPT, 2)
    net = build_controlnet(UNetConfig.sdxl(), 170)
    res = run_main_path(with_modules(pipe, controlnets=[net]), "sdxl_controlnet", counters,
                        timed=1, plain=False, warmup=False,
                        extra=dict(prompt=XL_PROMPT,
                                   controlnet_inputs=[control_image((1024, 1024), 171)]))
    report("sdxl_controlnet", res)
    return res


# -- phases 18 to 20 ----------------------------------------------------------------

#: a path's latents against phase 5's of the same prompt and seed (relative
#: max abs): the T5 context and a net's residuals must move them
SD3_MIN_REL = 1e-4


def t5_tokenizer_json(path: Path) -> Path:
    """A synthetic unigram ``tokenizer.json`` in T5's layout (<pad> 0, </s> 1,
    <unk> 2; the SpmConverter normalizer without a character map; Metaspace)
    over the prompts' letters and words."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    words = sorted({w for p in PROMPTS for w in p.split()})
    vocab = [["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0], ["\u2581", -3.0]]
    vocab += [[c, -3.0] for c in letters] + [["\u2581" + c, -3.5] for c in letters]
    vocab += [["\u2581" + w, -4.0] for w in words]
    special = [{"id": i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
                "normalized": False, "special": True}
               for i, c in enumerate(("<pad>", "</s>", "<unk>"))]
    path.write_text(json.dumps({
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": special,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Strip", "strip_left": False, "strip_right": True},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "\u2581"}]},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "\u2581",
                          "prepend_scheme": "always", "split": True},
        "post_processor": None, "decoder": None,
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab, "byte_fallback": False}}))
    return path


def build_t5(seed: int):
    """The full-width T5-XXL encoder on the card: bf16 weights N(0, 0.02)
    from ``seed``, allocated once in bf16, the relative-position table
    float32."""
    from ml_stable_diffusion_torch.models.init import init_random_
    from ml_stable_diffusion_torch.models.t5 import T5Config, T5Encoder

    with torch.device("meta"):
        t5 = T5Encoder(T5Config.xxl())
    t5 = t5.to(torch.bfloat16).to_empty(device="cuda")
    init_random_(t5, torch.Generator(device="cuda").manual_seed(seed), std=0.02)
    table = t5.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
    if table.dtype != torch.float32:
        fail(f"the T5 relative-position table is {table.dtype}, want float32")
    return t5.eval()


def time_t5_encode(t5, tokenizer):
    """The T5 encode of one CFG pair (the negative "" and a prompt, 77
    tokens each) on the card: CUDA-event ms, and the device's busy ms and
    kernel launches per encode from the profiler over 3 encodes, beside its
    bound, the larger of (the weights it reads once, the rows it gathers,
    its output) / 3.35 TB/s and its matrix products' operations / the bf16
    peak."""
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    rows = [tokenizer.tokenize(t, 77) for t in ("", PROMPTS[0])]
    ids = torch.from_numpy(np.stack([r[0] for r in rows])).long().cuda()
    mask = torch.from_numpy(np.stack([r[1] for r in rows])).long().cuda()

    @torch.inference_mode()
    def encode():
        return t5(ids, mask)["encoder_hidden_states"]

    cfg = t5.config
    B, S = ids.shape
    shared = t5.shared.weight
    weight_bytes = sum(p.numel() * p.element_size() for p in t5.parameters()
                       if p is not shared)
    nbytes = weight_bytes + 2 * B * S * cfg.d_model * shared.element_size()
    linear = sum(m.weight.numel() for m in t5.modules() if isinstance(m, torch.nn.Linear))
    ops = 2 * linear * B * S + 4 * B * cfg.num_heads * S * S * cfg.d_kv * cfg.num_layers
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[torch.bfloat16]
    ms = time_ms(encode, reps=3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            encode()
        torch.cuda.synchronize()
    busy_us, _, names = _device_time(prof)
    out = dict(ms=ms, device_ms=busy_us / 1e3 / 3,
               launches=sum(n for n, _ in names.values()) / 3,
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               weight_bytes=weight_bytes, operations=ops, tokens=[B, S])
    log(f"T5-XXL encode of (2, 77) tokens: {out['ms']:.3f} ms (device busy "
        f"{out['device_ms']:.3f} ms, {out['launches']:.0f} kernel launches) against a "
        f"bound of {out['bound_ms']:.3f} ms ({out['bound_by']}: {weight_bytes / 1e9:.2f} GB "
        "of weights)")
    return out


def run_t5_path(pipe, counters, report, sd3_results):
    """Phase 18 on phase 5's SD3 pipeline: the T5-XXL encoder and a T5
    tokenizer joined to it."""
    from ml_stable_diffusion_torch.tokenizer.t5 import T5Tokenizer

    with tempfile.TemporaryDirectory() as tmp:
        tokenizer = T5Tokenizer(t5_tokenizer_json(Path(tmp) / "tokenizer.json"))
    t5 = build_t5(18)
    n = sum(p.numel() for p in t5.parameters())
    log(f"T5-XXL: {n / 1e9:.3f} B parameters on the card")
    results = []
    res = run_main_path(with_modules(pipe, t5_encoder=t5, t5_tokenizer=tokenizer), "sd3_t5",
                        counters, timed=1, plain=False, results=results)
    report("sd3_t5", res)
    rel = latents_rel(results[0].latents, sd3_results[0].latents)
    log(f"sd3 T5: latents with the T5 context differ from those with the zero block by "
        f"{rel:.4g} (rel)")
    if not rel > SD3_MIN_REL:
        fail(f"the T5 context did not move the latents: rel {rel} <= {SD3_MIN_REL}")
    encode = time_t5_encode(t5, tokenizer)
    del t5
    free_card()
    return res, dict(parameters=n, with_vs_without_latents_rel=rel, encode=encode)


def build_sd3_controlnet(seed: int):
    """A full-width ``SD3ControlNetConfig.sd3_medium()`` net (12 joint
    blocks) in bf16 with speed weights from ``seed``: its zero-initialised
    patch embedding and projections are N(0, 0.02) too, so it moves the
    latents."""
    from ml_stable_diffusion_torch.models.controlnet_sd3 import (
        SD3ControlNetConfig,
        SD3ControlNetModel,
    )

    with torch.device("meta"):
        net = SD3ControlNetModel(SD3ControlNetConfig.sd3_medium())
    return materialize(net, torch.Generator(device="cuda").manual_seed(seed),
                       torch.bfloat16).eval()


def run_sd3_controlnet_paths(pipe, counters, report, sd3_results):
    """Phase 19 on phase 5's SD3 pipeline plus a VAE encoder: one SD3
    ControlNet (warm-up, median of 3), then two (one generation)."""
    nets = [build_sd3_controlnet(190), build_sd3_controlnet(191)]
    n = sum(p.numel() for p in nets[0].parameters())
    log(f"SD3 ControlNet: {n / 1e9:.3f} B parameters a net")
    conds = [control_image((1024, 1024), 192), control_image((1024, 1024), 193)]
    enc_pipe = with_encoder(pipe, 19)
    out, results = {}, []
    out["sd3_controlnet"] = run_main_path(with_modules(enc_pipe, controlnets=nets[:1]),
                                          "sd3_controlnet", counters, timed=1, plain=False,
                                          results=results,
                                          extra=dict(controlnet_inputs=conds[:1]))
    report("sd3_controlnet", out["sd3_controlnet"])
    out["sd3_controlnet2"] = run_main_path(with_modules(enc_pipe, controlnets=nets),
                                           "sd3_controlnet2", counters, timed=1, plain=False,
                                           warmup=False, extra=dict(controlnet_inputs=conds))
    report("sd3_controlnet2", out["sd3_controlnet2"])
    rel = latents_rel(results[0].latents, sd3_results[0].latents)
    log(f"sd3 ControlNet: latents with the net differ from those without by {rel:.4g} (rel)")
    if not rel > SD3_MIN_REL:
        fail(f"the SD3 ControlNet did not move the latents: rel {rel} <= {SD3_MIN_REL}")
    del nets, enc_pipe
    free_card()
    return out, dict(parameters_a_net=n, with_vs_without_latents_rel=rel)


def _save_diffusers_module(d: Path, config: dict, state_dict, filename: str):
    from ml_stable_diffusion_torch.convert.native_io import save_file

    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(config))
    save_file(state_dict, d / filename)


def save_diffusers_sd21(root: Path, pipe, encoder):
    """Phase 3's modules as a diffusers-layout SD-2.1 directory, each in the
    dtype it runs in; the VAE directory holds the decoder and ``encoder``."""
    root.mkdir()
    (root / "model_index.json").write_text(json.dumps(
        {"_class_name": "StableDiffusionPipeline"}))
    (root / "tokenizer").mkdir()
    letters_tokenizer(root / "tokenizer")
    te = pipe.text_encoder.config
    _save_diffusers_module(
        root / "text_encoder",
        {"architectures": ["CLIPTextModel"],
         **{k: getattr(te, k) for k in ("vocab_size", "hidden_size", "intermediate_size",
                                        "num_hidden_layers", "num_attention_heads",
                                        "max_position_embeddings", "hidden_act",
                                        "eos_token_id", "projection_dim")}},
        pipe.text_encoder.state_dict(), "model.safetensors")
    u = pipe.unet.config
    _save_diffusers_module(
        root / "unet",
        {"in_channels": u.in_channels, "out_channels": u.out_channels,
         "block_out_channels": list(u.block_out_channels),
         "down_block_types": list(u.down_block_types), "up_block_types": list(u.up_block_types),
         "layers_per_block": u.layers_per_block,
         "transformer_layers_per_block": list(u.transformer_layers_per_block),
         "attention_head_dim": list(u.num_attention_heads),
         "cross_attention_dim": u.cross_attention_dim, "norm_num_groups": u.norm_num_groups,
         "flip_sin_to_cos": u.flip_sin_to_cos, "freq_shift": u.freq_shift},
        pipe.unet.state_dict(), "diffusion_pytorch_model.safetensors")
    v = pipe.vae_decoder.config
    _save_diffusers_module(
        root / "vae",
        {"in_channels": v.in_channels, "out_channels": v.out_channels,
         "latent_channels": v.latent_channels, "block_out_channels": list(v.block_out_channels),
         "layers_per_block": v.layers_per_block, "norm_num_groups": v.norm_num_groups,
         "use_quant_conv": v.use_quant_conv},
        {**pipe.vae_decoder.state_dict(), **encoder.state_dict()},
        "diffusion_pytorch_model.safetensors")
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {k: getattr(v, "value", v) for k, v in dataclasses.asdict(pipe.scheduler_config).items()}))


def run_diffusers_path(pipe, counters, report, sd21_results):
    """Phase 20: phase 3's modules through a diffusers directory and
    ``load_pipeline``; the same prompt and seed give phase 3's latents bit
    for bit.  -> (the path's readings, the checks, the directory's
    ``TemporaryDirectory``, kept for phases 28, 31 and 32: clean it up
    after them, the generation's result)."""
    import numpy as np

    from ml_stable_diffusion_torch.convert.load import load_pipeline

    encoder = with_encoder(pipe, 20).vae_encoder
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name) / "sd21"
    t0 = time.perf_counter()
    save_diffusers_sd21(root, pipe, encoder)
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in root.rglob("*.safetensors"))
    del encoder
    free_card()
    t0 = time.perf_counter()
    loaded = load_pipeline(root, compute_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"diffusers directory: {nbytes / 1e9:.3f} GB saved in {save_s:.2f} s, "
        f"load_pipeline in {load_s:.2f} s")
    for name in ("text_encoder", "unet", "vae_decoder"):
        got, want = getattr(loaded, name), getattr(pipe, name)
        if got.config != want.config:
            fail(f"load_pipeline: {name} config {got.config} != {want.config}")
        if next(got.parameters()).dtype != next(want.parameters()).dtype:
            fail(f"load_pipeline: {name} loads in {next(got.parameters()).dtype}")
    if loaded.scheduler_config != pipe.scheduler_config:
        fail(f"load_pipeline: scheduler {loaded.scheduler_config} != {pipe.scheduler_config}")
    results = []
    res = run_main_path(loaded, "sd21_diffusers", counters, timed=1, plain=False, warmup=False,
                        results=results)
    report("sd21_diffusers", res)
    same = bool(np.array_equal(results[0].latents, sd21_results[0].latents))
    log(f"load_pipeline: latents {'equal' if same else 'NOT equal'} to phase 3's bit for bit")
    if not same:
        fail("the diffusers-loaded pipeline's latents differ from phase 3's: max abs "
             f"{float(np.abs(results[0].latents - sd21_results[0].latents).max())}")
    del loaded
    free_card()
    return res, dict(directory_bytes=nbytes, save_s=save_s, load_s=load_s,
                     latents_bit_equal=same), tmp, results[0]


# -- phases 21 and 22 ----------------------------------------------------------------

#: the synthetic LoRA adapters: rank, alpha (a factor alpha / rank = 0.5), and
#: factors N(0, 0.02) from a seeded generator, as the weights are drawn: each
#: delta is a few per cent of its weight
LORA_RANK, LORA_ALPHA, LORA_STD = 16, 8.0, 0.02
#: the modules the adapters cover: every UNet attention and FF projection,
#: every CLIP layer's q/k/v/out and fc1/fc2, every MMDiT joint-attention
#: projection
UNET_LORA_RE = re.compile(
    r"transformer_blocks\.\d+\.(attn[12]\.(to_q|to_k|to_v|to_out\.0)|ff\.net\.(0\.proj|2))$")
CLIP_LORA_RE = re.compile(r"^text_model\.encoder\.layers\.\d+\.(self_attn\.(q|k|v|out)_proj|"
                          r"mlp\.fc[12])$")
MMDIT_LORA_RE = re.compile(r"^transformer_blocks\.\d+\.attn\.(to_q|to_k|to_v|add_q_proj|"
                           r"add_k_proj|add_v_proj|to_out\.0|to_add_out)$")
#: an adapter must move a generation's latents from those without it
#: (relative max abs; N(0, 0.02) factors move them by ~1e-2)
ADAPTER_MIN_REL = 1e-4
#: the textual-inversion witness: a placeholder whose vectors are the token
#: rows of PROMPTS[0]'s two-token word "on" in the letters vocabulary
TI_WORD, TI_TOKEN = "on", "<on>"
TI_PROMPT = PROMPTS[0].replace(f" {TI_WORD} ", f" {TI_TOKEN} ")
#: the IP-Adapter reference image's seed; its size is the encoder's (224)
IP_IMAGE_SEED = 210
#: the IP-Adapter image encoders: OpenCLIP ViT-H/14 (h94/IP-Adapter's SD-1.5
#: adapters) and ViT-bigG/14 (ip-adapter_sdxl), vision towers at 224x224
VIT_H14 = dict(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
               num_attention_heads=16, projection_dim=1024)
VIT_BIGG14 = dict(hidden_size=1664, intermediate_size=8192, num_hidden_layers=48,
                  num_attention_heads=16, projection_dim=1280)


def kohya_stem(prefix):
    return lambda name: prefix + name.replace(".", "_")


def sgm_stem(name: str) -> str:
    """A diffusers SDXL UNet attention module name in kohya's sgm naming
    (the inverse of the loader's block arithmetic at layers_per_block=2)."""
    m = re.match(r"(down|up)_blocks\.(\d+)\.attentions\.(\d+)\.(.+)$", name)
    if m:
        side, b, layer, rest = m.group(1), int(m.group(2)), int(m.group(3)), m.group(4)
        idx = f"input_blocks_{3 * b + layer + 1}" if side == "down" else f"output_blocks_{3 * b + layer}"
        return f"lora_unet_{idx}_1_{rest.replace('.', '_')}"
    rest = re.match(r"mid_block\.attentions\.0\.(.+)$", name).group(1)
    return f"lora_unet_middle_block_1_{rest.replace('.', '_')}"


def lora_state(model, pattern, stem, gen, peft=False, dtype=torch.float16):
    """-> (a synthetic LoRA state dict over every module of ``model`` whose
    name matches ``pattern``, its keys ``stem(name)``; the names).  kohya
    keys carry an alpha; PEFT ones (``peft``) none (factor 1)."""
    sd, names = {}, []
    for name, module in model.named_modules():
        if not pattern.search(name):
            continue
        out_ch, in_ch = module.weight.shape[:2]
        down = (torch.randn(LORA_RANK, in_ch, generator=gen) * LORA_STD).to(dtype)
        up = (torch.randn(out_ch, LORA_RANK, generator=gen) * LORA_STD).to(dtype)
        key = stem(name)
        if peft:
            sd.update({f"{key}.lora_A.weight": down, f"{key}.lora_B.weight": up})
        else:
            sd.update({f"{key}.lora_down.weight": down, f"{key}.lora_up.weight": up,
                       f"{key}.alpha": torch.tensor(LORA_ALPHA)})
        names.append(name)
    return sd, names


def save_adapter(d: Path, name: str, sd: dict, want):
    """Write a LoRA adapter file; its parsed modules must be ``want``
    ({(target, module name)}): the demangling at full width."""
    from ml_stable_diffusion_torch.convert.lora import load_lora
    from ml_stable_diffusion_torch.convert.native_io import save_file

    path = d / f"{name}.safetensors"
    save_file(sd, path)
    got = set(load_lora(path).modules)
    if got != set(want):
        fail(f"{name}: the adapter parses to {len(got)} modules, {len(got & set(want))} of "
             f"the {len(want)} written (e.g. {sorted(got ^ set(want))[:3]})")
    return path, path.stat().st_size


def timed_call(fn):
    """-> (``fn()``, its seconds by the host's clock, the card's work
    included)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed_host(fn):
    """-> seconds of ``fn()`` by the host's clock, the card's work included."""
    return timed_call(fn)[1]


def state_snapshot(modules: dict):
    return {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for name, m in modules.items()}


def check_restored(modules: dict, before: dict, what: str):
    """Every tensor of every module equal to its snapshot, byte for byte."""
    for name, m in modules.items():
        now = m.state_dict()
        if set(now) != set(before[name]):
            fail(f"{what}: {name}'s state dict keys changed")
        bad = [k for k, v in now.items() if not torch.equal(v, before[name][k])]
        if bad:
            fail(f"{what}: {len(bad)} tensors of {name} differ from the originals, e.g. {bad[:3]}")


def check_same_latents(res, ref, what: str):
    import numpy as np

    if not np.array_equal(res.latents, ref.latents):
        fail(f"{what}: latents differ from the adapter-free generation's by "
             f"{latents_rel(res.latents, ref.latents)} (rel), not bit for bit")
    log(f"{what}: latents bit-equal to the adapter-free generation of the same prompt and seed")


def check_moved(res, ref, what: str) -> float:
    rel = latents_rel(res.latents, ref.latents)
    if not rel > ADAPTER_MIN_REL:
        fail(f"{what} did not move the latents: rel {rel} <= {ADAPTER_MIN_REL}")
    return rel


def build_vision(cfg, seed: int):
    """A CLIP vision encoder of ``cfg`` in bf16 on the card, speed weights."""
    from ml_stable_diffusion_torch.models.clip_vision import CLIPVisionEncoder

    with torch.device("meta"):
        enc = CLIPVisionEncoder(cfg)
    return materialize(enc, torch.Generator(device="cuda").manual_seed(seed),
                       torch.bfloat16).eval()


def ip_image(size: int, seed: int):
    """A seeded (size, size, 3) float32 reference image in [0, 1]."""
    return torch.rand((size, size, 3), generator=torch.Generator().manual_seed(seed)).numpy()


def ip_adapter_groups(unet, kind: str, embed_dim: int, gen, tokens: int = 4):
    """Synthetic h94 groups for ``unet``: ``ip_adapter`` (to_k_ip / to_v_ip
    of every cross attention at index 2i+1) and a BASE (``tokens`` tokens)
    or PLUS (ip-adapter-plus_sd15's resampler: dim 768, depth 4, 12 heads of
    64, 16 queries, ff x4) ``image_proj``; N(0, 0.02) weights, LayerNorms at
    1 and 0."""
    from ml_stable_diffusion_torch.convert.ip_adapter import cross_attention_paths
    from ml_stable_diffusion_torch.models.ip_adapter import IPImageProjection, IPResampler

    cross = unet.config.cross_attention_dim
    groups = {"ip_adapter": {}}
    for i, name in enumerate(cross_attention_paths(unet.config)):
        inner = unet.get_submodule(name).to_q.weight.shape[0]
        for kv in ("to_k_ip", "to_v_ip"):
            groups["ip_adapter"][f"{2 * i + 1}.{kv}.weight"] = (
                torch.randn(inner, cross, generator=gen) * LORA_STD).half()
    proj = (IPImageProjection(embed_dim, cross, tokens) if kind == "base" else
            IPResampler(output_dim=cross, dim=768, depth=4, heads=12, dim_head=64,
                        num_queries=16, ff_mult=4, embedding_dim=embed_dim))
    sd = proj.state_dict()  # LayerNorms at 1 and 0 as built
    for key, value in sd.items():
        if "norm" in key or re.search(r"\.1\.0\.", key):
            continue
        if key == "latents":
            sd[key] = torch.randn(value.shape, generator=gen)
        elif key.endswith(".weight"):
            sd[key] = torch.randn(value.shape, generator=gen) * LORA_STD
        else:
            sd[key] = torch.zeros_like(value)
    groups["image_proj"] = {k: v.half() for k, v in sd.items()}
    return groups


def save_ip_adapter(d: Path, name: str, groups: dict, fmt: str):
    """The h94 layouts: flat ``image_proj.*`` / ``ip_adapter.*`` safetensors,
    or the torch-pickled nested .bin."""
    from ml_stable_diffusion_torch.convert.native_io import save_file

    if fmt == "safetensors":
        path = d / f"{name}.safetensors"
        save_file({f"{g}.{k}": v for g, sd in groups.items() for k, v in sd.items()}, path)
    else:
        path = d / f"{name}.bin"
        torch.save(groups, path)
    return path


def vision_bound_ms(enc, batch: int) -> float:
    """The least time of one encode: its weights read once against its
    products at the bf16 peak (the patch conv, 4 projections and the MLP a
    layer, q.k and p.v over all tokens, the visual projection)."""
    c = enc.config
    tokens = (c.image_size // c.patch_size) ** 2 + 1
    C, inter = c.hidden_size, c.intermediate_size
    flops = batch * (2 * (tokens - 1) * 3 * c.patch_size ** 2 * C
                     + c.num_hidden_layers * (2 * tokens * (4 * C * C + 2 * C * inter)
                                              + 4 * tokens * tokens * C)
                     + 2 * C * c.projection_dim)
    nbytes = sum(p.numel() * p.element_size() for p in enc.parameters())
    return 1e3 * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[torch.bfloat16])


def device_busy(fn, calls: int = 3):
    """-> (the device's busy ms per call of ``fn``, kernels per call) from
    the profiler over ``calls`` calls after a warm-up, as phase 18 reads the
    T5 encode; (None, None) when the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    if not any(e.device_type == DeviceType.CUDA for e in prof.events()):
        return None, None
    busy_us, _, names = _device_time(prof)
    return busy_us / 1e3 / calls, sum(n for n, _ in names.values()) / calls


def time_vision(enc, label: str):
    """The encoder at batch 1 and 2: ms by CUDA events around back-to-back
    calls (the host's issue rate, on this eager path), the device's busy ms
    and kernels per encode, and the bound."""
    S = enc.config.image_size
    out = {}
    with torch.inference_mode():
        for b in (1, 2):
            fn = functools.partial(enc, torch.rand((b, 3, S, S), device="cuda"))
            busy, kernels = device_busy(fn)
            out[f"batch{b}"] = dict(ms=time_ms(fn, reps=3), device_ms=busy, kernels=kernels,
                                    bound_ms=vision_bound_ms(enc, b))
    log(f"{label} encode: " + "; ".join(
        f"batch {b}: {r['ms']:.3f} ms (device busy {fmt_ms(r['device_ms'])}, "
        f"{r['kernels'] or 0:.0f} kernels; bound {r['bound_ms']:.3f})"
        for b, r in zip((1, 2), out.values())))
    return out


def time_decoupled_attention(unet, tokens):
    """One SD-1.5 UNet call at CFG batch 2 (64x64 latents, 77 context rows)
    without and with the IP tokens: ms by CUDA events, the device's busy ms
    and kernels per call."""
    gen = torch.Generator(device="cuda").manual_seed(211)
    x = torch.randn(2, 4, 64, 64, generator=gen, device="cuda")
    t = torch.tensor(500.0, device="cuda")
    ctx = torch.randn(2, 77, unet.config.cross_attention_dim, generator=gen, device="cuda")
    ip = torch.cat([tokens, tokens])
    out = {}
    with torch.inference_mode():
        for key, fn in (("without", functools.partial(unet, x, t, ctx)),
                        ("with", functools.partial(unet, x, t, ctx, ip_context=ip,
                                                   ip_scale=1.0))):
            busy, kernels = device_busy(fn)
            out[key] = dict(ms=time_ms(fn, reps=3), device_ms=busy, kernels=kernels)
    a, b = out["without"], out["with"]
    log(f"sd15 UNet call, CFG batch 2, without / with the IP tokens: {a['ms']:.3f} / "
        f"{b['ms']:.3f} ms (+{100 * (b['ms'] / a['ms'] - 1):.1f} %); device busy "
        f"{fmt_ms(a['device_ms'])} / {fmt_ms(b['device_ms'])} ms, {a['kernels'] or 0:.0f} / "
        f"{b['kernels'] or 0:.0f} kernels")
    return out


def run_sd15_adapter_paths(pipe, counters, report, sd15_results):
    """Phase 21 on phase 11's SD-1.5 pipeline: a kohya LoRA stacked with a
    PEFT one, generated from, then cleared (weights and latents back bit
    for bit); the textual-inversion word witness; IP-Adapter BASE at scale 0
    (bit-equal) and 1, and PLUS."""
    from ml_stable_diffusion_torch.models.clip_vision import CLIPVisionConfig

    gen = torch.Generator().manual_seed(21)
    one = dict(timed=1, plain=False, warmup=False)
    out, checks = {}, {}
    base = sd15_results[0]  # PROMPTS[0], seed 1000: what every witness compares with
    modules = {"unet": pipe.unet, "text_encoder": pipe.text_encoder}
    before = state_snapshot(modules)
    unet_sd, unet_names = lora_state(pipe.unet, UNET_LORA_RE, kohya_stem("lora_unet_"), gen)
    te_sd, te_names = lora_state(pipe.text_encoder, CLIP_LORA_RE, kohya_stem("lora_te_"), gen)
    peft_sd, peft_names = lora_state(pipe.unet, re.compile(r"attn2\.(to_k|to_v)$"),
                                     lambda n: f"unet.{n}", gen, peft=True,
                                     dtype=torch.float32)
    with tempfile.TemporaryDirectory() as d:
        kohya, kohya_bytes = save_adapter(
            Path(d), "kohya", {**unet_sd, **te_sd},
            [("unet", n) for n in unet_names] + [("text_encoder", n) for n in te_names])
        peft, _ = save_adapter(Path(d), "peft", peft_sd, [("unet", n) for n in peft_names])
        merge_s = timed_host(lambda: pipe.apply_lora(kohya))
        stack_s = timed_host(lambda: pipe.apply_lora(peft, 0.5))
    results = []
    out["sd15_lora"] = run_main_path(pipe, "sd15_lora", counters, results=results, **one)
    rel = check_moved(results[0], base, "the LoRA adapters")
    clear_s = timed_host(pipe.clear_loras)
    check_restored(modules, before, "clear_loras")
    del before
    results = []
    out["sd15_lora_cleared"] = run_main_path(pipe, "sd15_lora_cleared", counters,
                                             results=results, **one)
    check_same_latents(results[0], base, "sd15 after clear_loras")
    checks["lora"] = dict(modules=len(unet_names) + len(te_names), peft_modules=len(peft_names),
                          file_bytes=kohya_bytes, merge_s=merge_s, stack_s=stack_s,
                          clear_s=clear_s, latents_rel_moved=rel)
    log(f"sd15 LoRA: kohya rank {LORA_RANK} over {len(unet_names)} UNet and {len(te_names)} "
        f"CLIP-L modules ({kohya_bytes / 1e6:.1f} MB) merged in {merge_s:.3f} s, the PEFT one "
        f"({len(peft_names)} modules) stacked in {stack_s:.3f} s, cleared in {clear_s:.4f} s; "
        f"latents moved {rel:.3g} (rel); weights and latents back bit for bit")

    ids = pipe.tokenizer.encode(TI_WORD)
    if len(ids) != 2:
        fail(f"the witness word {TI_WORD!r} is {len(ids)} tokens, want 2")
    table = pipe.text_encoder.text_model.embeddings.token_embedding.weight
    rows = table[torch.tensor(ids, device=table.device)].detach().float().cpu().numpy()
    new_ids = pipe.load_textual_inversion(rows, token=TI_TOKEN)
    results = []
    out["sd15_ti"] = run_main_path(pipe, "sd15_ti", counters, results=results,
                                   extra=dict(prompt=TI_PROMPT), **one)
    check_same_latents(results[0], base, f"sd15 textual inversion ({TI_PROMPT!r}, ids {new_ids})")

    encoder = build_vision(CLIPVisionConfig(**VIT_H14), 212)
    image = ip_image(encoder.config.image_size, IP_IMAGE_SEED)
    with tempfile.TemporaryDirectory() as d:
        path = save_ip_adapter(Path(d), "ip-adapter_sd15", ip_adapter_groups(
            pipe.unet, "base", encoder.config.projection_dim, gen), "safetensors")
        load_base_s = timed_host(lambda: pipe.load_ip_adapter(path, encoder))
    results = []
    out["sd15_ip_scale0"] = run_main_path(pipe, "sd15_ip_scale0", counters, results=results,
                                          extra=dict(ip_adapter_image=image,
                                                     ip_adapter_scale=0.0), **one)
    check_same_latents(results[0], base, "sd15 IP-Adapter at ip_adapter_scale 0")
    results = []
    out["sd15_ip_base"] = run_main_path(pipe, "sd15_ip_base", counters, plain=False,
                                        results=results, extra=dict(ip_adapter_image=image))
    rel_base = check_moved(results[0], base, "IP-Adapter BASE")
    checks["vision_h14"] = time_vision(encoder, "ViT-H/14 (bf16, 257 tokens)")
    with torch.inference_mode():
        S = encoder.config.image_size
        tokens = pipe.ip_projection[0](encoder(torch.from_numpy(image).cuda().permute(
            2, 0, 1)[None].contiguous())["image_embeds"])
    checks["decoupled_attention"] = time_decoupled_attention(pipe.unet, tokens)
    with tempfile.TemporaryDirectory() as d:
        path = save_ip_adapter(Path(d), "ip-adapter-plus_sd15", ip_adapter_groups(
            pipe.unet, "plus", encoder.config.hidden_size, gen), "bin")
        load_plus_s = timed_host(lambda: pipe.load_ip_adapter(path, encoder))
    results = []
    out["sd15_ip_plus"] = run_main_path(pipe, "sd15_ip_plus", counters, plain=False,
                                        results=results, extra=dict(ip_adapter_image=image))
    rel_plus = check_moved(results[0], base, "IP-Adapter PLUS")
    checks["ip_adapter"] = dict(load_base_s=load_base_s, load_plus_s=load_plus_s,
                                latents_rel_moved_base=rel_base, latents_rel_moved_plus=rel_plus,
                                image_size=S)
    for p, res in out.items():
        report(p, res)
    return out, checks


def run_sdxl_adapter_paths(pipe, counters, report, sdxl_results):
    """Phase 22 on phase 7's SDXL base pipeline: a kohya-sgm LoRA on the UNet
    and both CLIPs, generated from and cleared (weights back bit for bit);
    a clip_l/clip_g placeholder of the witness word (latents bit-equal to
    phase 7's); IP-Adapter with ViT-bigG/14."""
    from ml_stable_diffusion_torch.models.clip_vision import CLIPVisionConfig

    gen = torch.Generator().manual_seed(22)
    one = dict(timed=1, plain=False, warmup=False)
    out, checks = {}, {}
    base = sdxl_results[0]
    modules = {"unet": pipe.unet, "text_encoder": pipe.text_encoder,
               "text_encoder2": pipe.text_encoder2}
    before = state_snapshot(modules)
    unet_sd, unet_names = lora_state(pipe.unet, UNET_LORA_RE, sgm_stem, gen)
    te1_sd, te1_names = lora_state(pipe.text_encoder, CLIP_LORA_RE, kohya_stem("lora_te1_"), gen)
    te2_sd, te2_names = lora_state(pipe.text_encoder2, CLIP_LORA_RE, kohya_stem("lora_te2_"),
                                   gen)
    with tempfile.TemporaryDirectory() as d:
        path, nbytes = save_adapter(
            Path(d), "kohya_sdxl", {**unet_sd, **te1_sd, **te2_sd},
            [("unet", n) for n in unet_names] + [("text_encoder", n) for n in te1_names]
            + [("text_encoder_2", n) for n in te2_names])
        merge_s = timed_host(lambda: pipe.apply_lora(path))
    results = []
    out["sdxl_lora"] = run_main_path(pipe, "sdxl_lora", counters, results=results, **one)
    rel = check_moved(results[0], base, "the SDXL LoRA")
    clear_s = timed_host(pipe.clear_loras)
    check_restored(modules, before, "SDXL clear_loras")
    del before
    checks["lora"] = dict(modules=len(unet_names) + len(te1_names) + len(te2_names),
                          file_bytes=nbytes, merge_s=merge_s, clear_s=clear_s,
                          latents_rel_moved=rel)
    log(f"sdxl LoRA: kohya-sgm rank {LORA_RANK} over {len(unet_names)} UNet, {len(te1_names)} "
        f"CLIP-L and {len(te2_names)} CLIP-G modules ({nbytes / 1e6:.1f} MB) merged in "
        f"{merge_s:.3f} s, cleared in {clear_s:.4f} s; latents moved {rel:.3g} (rel); weights "
        "back bit for bit")

    ids = pipe.tokenizer.encode(TI_WORD)
    if ids != pipe.tokenizer2.encode(TI_WORD) or len(ids) != 2:
        fail(f"the witness word {TI_WORD!r}: ids {ids}, want 2 tokens in both tokenizers")
    rows = {}
    for key, enc in (("clip_l", pipe.text_encoder), ("clip_g", pipe.text_encoder2)):
        table = enc.text_model.embeddings.token_embedding.weight
        rows[key] = table[torch.tensor(ids, device=table.device)].detach().float().cpu().numpy()
    pipe.load_textual_inversion(rows, token=TI_TOKEN)
    results = []
    out["sdxl_ti"] = run_main_path(pipe, "sdxl_ti", counters, results=results,
                                   extra=dict(prompt=TI_PROMPT), **one)
    check_same_latents(results[0], base, "sdxl clip_l/clip_g textual inversion (and the "
                                         "weights after clear_loras)")

    encoder = build_vision(CLIPVisionConfig(**VIT_BIGG14), 220)
    with tempfile.TemporaryDirectory() as d:
        path = save_ip_adapter(Path(d), "ip-adapter_sdxl", ip_adapter_groups(
            pipe.unet, "base", encoder.config.projection_dim, gen), "safetensors")
        load_s = timed_host(lambda: pipe.load_ip_adapter(path, encoder))
    results = []
    out["sdxl_ip"] = run_main_path(
        pipe, "sdxl_ip", counters, results=results,
        extra=dict(ip_adapter_image=ip_image(encoder.config.image_size, IP_IMAGE_SEED)), **one)
    checks["ip_adapter"] = dict(load_s=load_s,
                                latents_rel_moved=check_moved(results[0], base, "SDXL IP-Adapter"))
    checks["vision_bigg14"] = time_vision(encoder, "ViT-bigG/14 (bf16, 257 tokens)")
    for p, res in out.items():
        report(p, res)
    return out, checks


def run_sd3_lora_path(pipe, counters, report, sd3_results):
    """Phase 22 on phase 5's SD3 pipeline: a PEFT ``transformer.`` LoRA over
    every joint-attention projection, one generation, cleared (weights back
    bit for bit)."""
    gen = torch.Generator().manual_seed(23)
    modules = {"mmdit": pipe.unet}
    before = state_snapshot(modules)
    sd, names = lora_state(pipe.unet, MMDIT_LORA_RE, lambda n: f"transformer.{n}", gen,
                           peft=True)
    with tempfile.TemporaryDirectory() as d:
        path, nbytes = save_adapter(Path(d), "peft_sd3", sd, [("transformer", n) for n in names])
        merge_s = timed_host(lambda: pipe.apply_lora(path))
    results = []
    res = run_main_path(pipe, "sd3_lora", counters, timed=1, plain=False, warmup=False,
                        results=results)
    rel = check_moved(results[0], sd3_results[0], "the SD3 LoRA")
    clear_s = timed_host(pipe.clear_loras)
    check_restored(modules, before, "SD3 clear_loras")
    log(f"sd3 LoRA: PEFT rank {LORA_RANK} over {len(names)} MMDiT modules ({nbytes / 1e6:.1f} "
        f"MB) merged in {merge_s:.3f} s, cleared in {clear_s:.4f} s; latents moved {rel:.3g} "
        "(rel); weights back bit for bit")
    report("sd3_lora", res)
    return res, dict(modules=len(names), file_bytes=nbytes, merge_s=merge_s, clear_s=clear_s,
                     latents_rel_moved=rel)


# -- phases 23 to 25 ----------------------------------------------------------------

#: phase 25: each served request's latents against the same request run
#: alone, relative max abs.  tests/test_serving.py holds the JAX server at
#: 2e-4 absolute on f32 CPU models (tests/test_torch_serving.py holds the
#: port's there too); on the card the bf16 UNet at batch 8 rounds otherwise
#: than at batch 2 (other matmul and flash tilings), which 20 steps carry
#: to ~1e-2, so the bound is GEN_MAX_REL_ERR's, the one the bf16
#: generations are held to; a request given another's noise or prompt
#: moves its latents by O(1).  The served batch itself must equal the
#: pipeline's own generation of the merged batch bit for bit.
SERVE_MAX_REL_ERR = GEN_MAX_REL_ERR


def port_kernel_records(names) -> dict:
    """The profiler's kernel records of the port's kernels, by kind, from
    ``_device_time``'s {kernel name: (records, us)}: the bf16 flash kernels
    (one a non-f32-D=512 wrapper launch), the 3xTF32 pre-pass, main kernel
    and combine pass, and the GroupNorm kernel."""
    rec = {"flash": 0, "split": 0, "wide": 0, "combine": 0, "gn": 0}
    for name, (n, _) in names.items():
        low = name.lower()
        kind = ("gn" if "gn_silu" in low else "split" if "flash_split_tf32" in low else
                "wide" if "3xtf32" in low else "combine" if "flash_combine" in low else
                "flash" if ("flash_wgmma" in low or "flash_fma" in low) else None)
        if kind:
            rec[kind] += n
    return rec


def records_of_launches(launched) -> dict:
    """What the profiler must record for a generation's wrapper launches."""
    wide = launched["flash_attention_wide_f32"]
    return {"flash": launched["flash_attention"] + launched["flash_attention_multi_q"] - wide,
            "split": launched["flash_split_tf32"], "wide": wide,
            "gn": launched["group_norm_silu"]}


def run_graphs_vs_eager(pipe, path, counters):
    """Phase 23 on ``path``'s pipeline, its programs cleared first: one eager
    and one captured generation of one prompt and seed (latents and images
    bit-equal, each launching the path's counts), the eager one's s/step and
    one captured replay's, the captures' seconds and pool bytes,
    and one generation of each under the profiler: busy share, and the
    port's kernel records against the launches counted (credited, for the
    replay)."""
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

    spec = PATHS[path]
    hw = spec["image_hw"]

    def run(mode, i):
        cfg = PipelineConfiguration(prompt=PROMPTS[i % len(PROMPTS)], step_count=STEPS,
                                    guidance_scale=spec["guidance"], seed=3000 + i,
                                    scheduler=spec["scheduler"], rng="numpy",
                                    disable_safety=True, **spec.get("extra", {}))
        pipe.execution = mode
        try:
            return launches_of(pipe, counters, lambda: pipe.generate_images(cfg, image_hw=hw))
        finally:
            pipe.execution = "program"

    pipe.clear_programs()
    free_card()
    first = len(pipe.programs.captures)
    eager, eager_launched, _ = run("eager", 0)
    graph, graph_launched, warm = run("program", 0)
    if not (np.array_equal(graph.latents, eager.latents)
            and np.array_equal(graph.images, eager.images)):
        fail(f"{path}: the captured program's latents differ from the eager loop's by "
             f"{float(abs(graph.latents - eager.latents).max())} (max abs): not bit for bit")
    for mode, launched in (("eager", eager_launched), ("captured", graph_launched),
                           ("capture warm-up", warm)):
        if launched != spec["per_generation"]:
            fail(f"{path}: the {mode} generation launched {launched}, "
                 f"want {spec['per_generation']}")
    captures = [dict(program="decode" if key[0] == "decode" else "generation",
                     capture_s=secs, pool_bytes=pool)
                for key, secs, pool in pipe.programs.captures[first:]]
    # the eager loop's s/step is its one generation's above; the captured
    # program's one replay's (captured s/step moves under 3 % between replays)
    sps = {"eager": [eager.seconds_per_step], "program": [run("program", 1)[0].seconds_per_step]}
    profiled = {}
    for mode in ("eager", "program"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, launched, _ = run(mode, 4)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, _, names = _device_time(prof)
        records = port_kernel_records(names)
        want = records_of_launches(launched)
        if any(records[k] != n for k, n in want.items()):
            fail(f"{path} ({mode}): the profiler recorded {records} kernels of the port's; "
                 f"the launches counted ({launched}) give {want}")
        profiled[mode] = dict(wall_s=wall, device_busy_s=busy / 1e6,
                              device_busy_share=busy / 1e6 / wall, kernel_records=records)
    out = dict(latents_bit_equal=True, launches=graph_launched, captures=captures,
               seconds_per_step_runs=sps,
               seconds_per_step={m: statistics.median(v) for m, v in sps.items()},
               profiled=profiled, memory_reserved_gib=reserved_gib())
    log(f"phase 23, {path}: captured latents and images bit-equal to the eager loop's; "
        f"s/step eager {out['seconds_per_step']['eager'] * 1e3:.2f} ms (one generation), "
        f"captured {out['seconds_per_step']['program'] * 1e3:.2f} ms (one replay); device "
        f"busy {100 * profiled['eager']['device_busy_share']:.1f} % eager, "
        f"{100 * profiled['program']['device_busy_share']:.1f} % captured; captures "
        + ", ".join(f"{c['program']} {c['capture_s']:.2f} s, pool {c['pool_bytes'] / 2**30:.3f} "
                    f"GiB" for c in captures)
        + f"; kernel records {profiled['program']['kernel_records']} = the credited launches; "
        f"{out['memory_reserved_gib']:.2f} GiB reserved")
    return out


def run_reduce_memory(pipe, counters):
    """Phase 24 on phase 7's SDXL base + refiner: a default (captured)
    generation from a cleared cache, then the weights offloaded and one
    staged generation; latents and images bit-equal, both peaks, each
    stage's transfer."""
    import numpy as np

    from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

    spec = PATHS["sdxl_refiner"]
    cfg = PipelineConfiguration(prompt=PROMPTS[0], step_count=STEPS, guidance_scale=5.0,
                                seed=4000, scheduler=spec["scheduler"], rng="numpy",
                                disable_safety=True, **spec["extra"])
    out = {}
    results = {}
    for mode in ("default", "staged"):
        pipe.clear_programs()
        if mode == "staged":
            t0 = time.perf_counter()
            pipe.offload_params_to_host()
            out["offload_s"] = time.perf_counter() - t0
        free_card()
        at_rest = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        c = dataclasses.replace(cfg, reduce_memory=mode == "staged")
        (res, launched, _), secs = timed_call(lambda: launches_of(
            pipe, counters, lambda: pipe.generate_images(c, image_hw=spec["image_hw"])))
        peak = torch.cuda.max_memory_allocated()  # the default's with its capture
        if mode == "default":  # timed again on its replay
            (res, launched, _), secs = timed_call(lambda: launches_of(
                pipe, counters, lambda: pipe.generate_images(c, image_hw=spec["image_hw"])))
        if launched != spec["per_generation"]:
            fail(f"reduce_memory ({mode}): the generation launched {launched}, want "
                 f"{spec['per_generation']}")
        results[mode] = res
        out[mode] = dict(max_memory_allocated=peak, memory_allocated_at_rest=at_rest,
                         seconds_per_image=secs, seconds_per_step=res.seconds_per_step,
                         launches=launched)
    if not (np.array_equal(results["staged"].latents, results["default"].latents)
            and np.array_equal(results["staged"].images, results["default"].images)):
        fail("reduce_memory: the staged latents differ from the default generation's by "
             f"{float(abs(results['staged'].latents - results['default'].latents).max())}")
    out["stages"] = [dict(stage=name, bytes=n, seconds=t, gb_per_s=n / t / 1e9)
                     for name, n, t in pipe.stage_transfers]
    want = ["encode", "unet", "refiner", "decode"]
    if [st["stage"] for st in out["stages"]] != want:
        fail(f"reduce_memory: stages {[st['stage'] for st in out['stages']]}, want {want}")
    for mode in ("default", "staged"):
        r = out[mode]
        log(f"phase 24, {mode}: peak {r['max_memory_allocated'] / 2**30:.3f} GiB allocated "
            f"({r['memory_allocated_at_rest'] / 2**30:.3f} GiB at rest), "
            f"{r['seconds_per_step'] * 1e3:.2f} ms/step, {r['seconds_per_image']:.3f} s/image")
    for st in out["stages"]:
        log(f"phase 24, stage {st['stage']}: {st['bytes'] / 1e9:.3f} GB to the card in "
            f"{st['seconds'] * 1e3:.1f} ms, {st['gb_per_s']:.2f} GB/s")
    log(f"phase 24: staged latents and images bit-equal to the default generation's; "
        f"offload {out['offload_s']:.2f} s")
    out["latents_bit_equal"] = True
    return out


def run_serving(pipe):
    """Phase 25 on phase 3's SD-2.1 pipeline (a copy with a VAE encoder, for
    the img2img request): precompile at batch 1, 2 and 4, four concurrent
    submits in one batch, each against its request run alone, one img2img
    request run alone, the server's stats and requests a second."""
    import numpy as np

    from ml_stable_diffusion_torch.pipelines import PipelineConfiguration
    from ml_stable_diffusion_torch.serving import GenerationServer, ServeConfig

    served = with_encoder(pipe, 25)
    hw = (512, 512)
    server = GenerationServer(served, [ServeConfig(image_hw=hw, step_count=STEPS,
                                                   scheduler="DPMSolverMultistep",
                                                   guidance_scale=7.5)],
                              max_batch=4, batch_window_s=0.5)
    out = {}
    try:
        _, out["precompile_s"] = timed_call(
            lambda: server.precompile(batch_sizes=(1, 2, 4)))
        built = served.programs.built
        cfgs = [PipelineConfiguration(prompt=PROMPTS[i], seed=5000 + i, step_count=STEPS,
                                      scheduler="DPMSolverMultistep", guidance_scale=7.5,
                                      rng="numpy", disable_safety=True) for i in range(4)]
        t0 = time.perf_counter()
        futures = [server.submit(c, image_hw=hw) for c in cfgs]
        results = [f.result(timeout=600) for f in futures]
        out["batch_wall_s"] = time.perf_counter() - t0
        out["requests_per_s"] = len(cfgs) / out["batch_wall_s"]
        if server.batches_run != 1:
            fail(f"serving: four submits ran as {server.batches_run} batches, want 1")
        if served.programs.built != built:
            fail("serving: the batch captured a program precompile had not built")
        merged = served.generate_images(dataclasses.replace(
            cfgs[0], prompt=[c.prompt for c in cfgs],
            negative_prompt=[c.negative_prompt for c in cfgs], seed=[c.seed for c in cfgs],
            image_count=len(cfgs)), image_hw=hw)
        if not np.array_equal(np.concatenate([r.latents for r in results]), merged.latents):
            fail("serving: the served batch differs from the pipeline's generation of the "
                 "merged batch")
        diffs = []
        t0 = time.perf_counter()
        for c, r in zip(cfgs, results):
            alone = served.generate_images(c, image_hw=hw)
            diffs.append(latents_rel(r.latents, alone.latents))
        out["alone_s"] = time.perf_counter() - t0
        out["alone_requests_per_s"] = len(cfgs) / out["alone_s"]
        out["rel_err_vs_alone"] = diffs
        if max(diffs) > SERVE_MAX_REL_ERR:
            fail(f"serving: batched latents differ from each request run alone by {diffs} "
                 f"(rel max abs) > {SERVE_MAX_REL_ERR}")
        direct = server.submit(dataclasses.replace(
            cfgs[0], starting_image=starting_image(hw, 25), strength=STRENGTH), image_hw=hw)
        res = direct.result(timeout=600)
        if server.batches_run != 1 or not np.isfinite(res.latents).all():
            fail(f"serving: the img2img request ran in a batch ({server.batches_run}) or gave "
                 "non-finite latents")
        out["stats"] = server.stats()
    finally:
        server.shutdown()
    log(f"phase 25: precompile of batch 1, 2, 4 in {out['precompile_s']:.2f} s; four "
        f"submits in one batch: {out['batch_wall_s']:.3f} s, {out['requests_per_s']:.2f} "
        f"requests/s (alone, one after another: {out['alone_requests_per_s']:.2f}); "
        f"the batch bit-equal to the merged generation, each request against itself "
        f"alone {max(out['rel_err_vs_alone']):.3g} (rel); "
        f"stats {out['stats']}")
    del served
    free_card()
    return out


# -- phases 26 to 29 ----------------------------------------------------------------

#: each W8A8 Linear of one full-width denoiser call against its simulation
#: in float32 on the same input, relative RMS.  The simulation quantizes the
#: input as the JAX op does (divided by its scale rounded to bf16) and the
#: float layer's weight per output channel, and multiplies the dequantized
#: operands in float32 (full float32: the port turns TF32 off), so the two
#: differ only by the int8 layer's bf16 output rounding, under 2e-3 at any
#: shape (bf16 keeps 8 significant bits).  The control, the float layer on
#: the same input against the same simulation, reads the quantization noise
#: an int8 layer must reproduce: an int8 step of a per-channel weight absmax
#: of ~3-4 sigma alone is ~1 % of a Gaussian weight's RMS, and the
#: activation's step adds as much.  The bound sits between, and each run
#: shows it does: it fails if any layer's control reads at or below it.  (The whole call is printed,
#: not bounded: one rounding difference upstream moves activations across
#: int8 rounding boundaries, and the calls drift apart by about the
#: quantization noise itself, which the PSNR against the float call reads.)
W8A8_LAYER_REL_RMS = 4e-3
#: H100 SXM dense int8 tensor-core peak (operations a second)
PEAK_INT8_OPS = 1979e12
PATHS.update({
    "sd21_w8a8": dict(PATHS["sd21"], label="SD-2.1-base 512x512 W8A8 (enable_w8a8(): "
                      "ConstantScales, dense layers), 20 steps DPM++ 2M, CFG batch 2"),
    "sd21_w8a8_convs": dict(PATHS["sd21"], label="SD-2.1-base 512x512 W8A8 with "
                            "include_convs=True, 20 steps DPM++ 2M, CFG batch 2"),
    "sdxl_w8a8": dict(PATHS["sdxl"], label="SDXL-base 1024x1024 W8A8 (dense), 20 steps "
                      "DPM++ 2M, CFG batch 2"),
    "sd3_w8a8": dict(PATHS["sd3"], label="SD3-medium 1024x1024 (no T5) W8A8 (dense), 20 "
                     "steps DiscreteFlow, CFG batch 2"),
    "sd21_fused_qkv": dict(PATHS["sd21"], label="SD-2.1-base 512x512 loaded with "
                           "fuse_qkv=True, 20 steps DPM++ 2M, CFG batch 2"),
})


def main_cfg(path, i, **extra):
    """The configuration of ``run_main_path``'s generation ``i`` of ``path``
    (prompt ``PROMPTS[i]``, seed 1000 + i)."""
    from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

    spec = PATHS[path]
    fields = dict(prompt=PROMPTS[i % len(PROMPTS)], step_count=STEPS,
                  guidance_scale=spec["guidance"], seed=1000 + i, scheduler=spec["scheduler"],
                  rng="numpy", disable_safety=True)
    fields.update(spec.get("extra", {}))
    fields.update(extra)
    return PipelineConfiguration(**fields)


def module_bytes(module) -> int:
    """Bytes of a module's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in (*module.parameters(), *module.buffers()))


def int8_layers(module) -> dict:
    from ml_stable_diffusion_torch.ops.int8 import Int8Conv2d, Int8Linear

    return {k: m for k, m in module.named_modules() if isinstance(m, (Int8Linear, Int8Conv2d))}


def generation_busy(pipe, path, i):
    """One generation of ``path`` under the profiler: -> (busy share,
    {kernel name: (records, us)})."""
    from torch.profiler import ProfilerActivity, profile

    cfg = main_cfg(path, i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.generate_images(cfg, image_hw=PATHS[path]["image_hw"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, _, names = _device_time(prof)
    return busy / 1e6 / wall, names


def run_in_turns(pipes: dict, paths: dict, counters, rounds: int = 1):
    """Each pipeline's warm-up (its capture) with generation 0 of its path,
    then ``rounds`` generations of each in turns (1, 2, ...: phase 3's prompts
    and seeds), every generation's own launches held to its path's; then one
    more of each under the profiler.  -> {label: dict(s/step median and
    runs, busy share, the results)}."""
    out = {label: dict(runs=[], results=[]) for label in pipes}
    reset_counters(counters)

    def one(label, i):
        pipe, path = pipes[label], paths[label]
        spec = PATHS[path]
        res, launched, _ = launches_of(pipe, counters, lambda: pipe.generate_images(
            main_cfg(path, i), image_hw=spec["image_hw"]))
        if launched != spec["per_generation"]:
            fail(f"{path}: a generation launched {launched}, want {spec['per_generation']}")
        if not bool(torch.isfinite(torch.from_numpy(res.latents)).all()):
            fail(f"{path}: latents not finite")
        return res

    for label in pipes:
        one(label, 0)
    for i in range(1, rounds + 1):
        for label in pipes:
            res = one(label, i)
            out[label]["runs"].append(res.seconds_per_step)
            out[label]["results"].append(res)
    launches = {name: fn.launches for name, fn in counters.items()}
    for label in pipes:
        out[label]["seconds_per_step"] = statistics.median(out[label]["runs"])
        out[label]["launches"] = launches
        out[label]["device_busy_share"], _ = generation_busy(pipes[label], paths[label],
                                                             rounds + 1)
    return out


def unet_call_inputs(gen, batch=2, hw=64, ctx=(77, 1024)):
    return (torch.randn(batch, 4, hw, hw, generator=gen, device="cuda"),
            torch.tensor(500.0, device="cuda"),
            torch.randn(batch, *ctx, generator=gen, device="cuda"))


def int_mm_records(module, inputs) -> int:
    """``aten::_int_mm`` records of one eager call of ``module``."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        module(*inputs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            module(*inputs)
            torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.name == "aten::_int_mm")


def record_int8_calls(module, inputs) -> list:
    """(name, layer, input shape) of every int8 layer of one call."""
    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: calls.append((name, mod, tuple(args[0].shape))))
        for name, m in int8_layers(module).items()]
    try:
        with torch.inference_mode():
            module(*inputs)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return calls


def check_int8_exactness(calls):
    """Phase 26.1: the three largest Linear weight shapes and the largest
    3x3 convolution of the UNet call, random operands at their call shapes:
    ``quantize_weight_int8``, ``int8_dense`` and ``int8_conv`` (with a bias)
    in float32 and in bf16, the dtype the pipelines serve, on the card and
    on the host, bit for bit (int32 accumulation is exact)."""
    from ml_stable_diffusion_torch.ops.int8 import Int8Conv2d, int8_conv, int8_dense
    from ml_stable_diffusion_torch.ops.int8 import quantize_weight_int8

    dense = {}
    conv = None
    for _, m, shape in calls:
        w = tuple(m.weight_q.shape)
        if isinstance(m, Int8Conv2d):
            if w[2:] == (3, 3) and (conv is None or math.prod(w) > math.prod(conv[1])):
                conv = (m, w, shape)
        else:
            dense.setdefault(w, (m, w, shape))
    picks = sorted(dense.values(), key=lambda r: -math.prod(r[1]))[:3]
    picks += [conv] if conv is not None else []
    gen = torch.Generator().manual_seed(26)
    rows = []
    for m, w_shape, x_shape in picks:
        w = torch.randn(w_shape, generator=gen) * 0.05
        x = torch.randn(x_shape, generator=gen)
        amax = float(x.abs().max())
        same = {}
        for dt in (torch.float32, torch.bfloat16):
            (qc, sc), (qh, sh) = (quantize_weight_int8(w.to(dt).to(d)) for d in ("cuda", "cpu"))
            same[f"quantize_weight_{str(dt)[6:]}"] = bool(
                torch.equal(qc.cpu(), qh) and torch.equal(sc.cpu(), sh))
        bias = torch.randn(w_shape[0], generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            wq, ws = quantize_weight_int8(w.to(dt))
            if isinstance(m, Int8Conv2d):
                def op(d):
                    return int8_conv(x.to(dt).to(d), wq.to(d), ws.to(d), amax,
                                     bias=bias.to(dt).to(d), stride=m.stride, padding=m.padding)
            else:
                def op(d):
                    return int8_dense(x.to(dt).to(d), wq.to(d), ws.to(d), amax,
                                      bias=bias.to(dt).to(d))
            same[f"output_{str(dt)[6:]}"] = bool(torch.equal(op("cuda").cpu(), op("cpu")))
        rows.append(dict(kind="conv" if isinstance(m, Int8Conv2d) else "dense",
                         weight=list(w_shape), input=list(x_shape), bit_equal=same))
        log(f"phase 26.1: {rows[-1]['kind']} weight {w_shape} input {x_shape}: card against "
            f"host bit-equal {same}")
        if not all(same.values()):
            fail(f"int8 ops on the card differ from the host at weight {w_shape}: {same}")
    return rows


def graph_ms(fn, calls: int = 20, windows: int = 3) -> float:
    """Device ms per call of ``fn``: a CUDA graph of ``calls`` back-to-back
    calls replayed between CUDA events (median of ``windows``), so that the
    host's issue rate does not pace the short ones; the graph's own launch
    gaps (~1 us a kernel) are in it, for every row alike."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(times)


def int8_shape_table(calls):
    """Phase 26.5: for each distinct int8 layer shape of the UNet call, the
    device ms (``graph_ms``) of its quantize pass (with the im2col of a
    convolution), its ``_int_mm`` and its rescale (with a convolution's NCHW
    store), the whole layer, and bf16 ``F.linear`` / ``F.conv2d`` at that
    shape; each row's bound (bytes or operations) for the int8 layer and
    the bf16 call."""
    import torch.nn.functional as F

    from ml_stable_diffusion_torch.ops.int8 import (
        Int8Conv2d,
        _rescale,
        int_mm,
        quantize_activation,
    )

    groups = {}
    for _, m, shape in calls:
        key = (type(m).__name__, tuple(m.weight_q.shape), shape, getattr(m, "stride", None),
               getattr(m, "padding", None))
        groups.setdefault(key, [m, 0])[1] += 1
    gen = torch.Generator(device="cuda").manual_seed(265)
    rows, fns = [], []
    for (kind, w_shape, x_shape, stride, padding), (m, n) in groups.items():
        x = torch.randn(x_shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        w16 = torch.randn(w_shape, generator=gen, device="cuda", dtype=torch.bfloat16) * 0.05
        b16 = None if m.bias is None else m.bias.detach()
        conv = isinstance(m, Int8Conv2d)
        O = w_shape[0]
        K = math.prod(w_shape[1:])
        if conv and w_shape[2:] != (1, 1):
            B, C, H, W = x_shape
            kh, kw = w_shape[2:]
            Ho = (H + 2 * padding[0] - kh) // stride[0] + 1
            Wo = (W + 2 * padding[1] - kw) // stride[1] + 1
            M = B * Ho * Wo

            def quant(x=x, m=m, kh=kh, kw=kw, Ho=Ho, Wo=Wo, B=B, K=K):
                xr = quantize_activation(x, m.x_scale, dtype=x.dtype)
                cols = F.unfold(xr, (kh, kw), padding=m.padding, stride=m.stride)
                a = torch.empty((B, Ho * Wo, K), dtype=torch.int8, device="cuda")
                a.copy_(cols.transpose(1, 2))
                return a.reshape(-1, K)

            def ref(x=x, w16=w16, b16=b16, m=m):
                return F.conv2d(x, w16, b16, m.stride, m.padding)
        else:
            M = math.prod(x_shape) // (x_shape[1] if conv else x_shape[-1])

            def quant(x=x, m=m, conv=conv, K=K):
                xx = x.permute(0, 2, 3, 1) if conv else x
                return quantize_activation(xx, m.x_scale).reshape(-1, K)

            if conv:
                def ref(x=x, w16=w16, b16=b16):
                    return F.conv2d(x, w16, b16)
            else:
                def ref(x=x, w16=w16, b16=b16):
                    return F.linear(x, w16, b16)
        a = quant()
        wq = m.weight_q.reshape(O, -1)
        acc = int_mm(a, wq)

        def mm(a=a, wq=wq):
            return int_mm(a, wq)

        def rescale(acc=acc, m=m, conv=conv, x=x):
            y = _rescale(acc, m.rescale, m.bias, x.dtype)
            return y.view(x.shape[0], -1, O).transpose(1, 2).contiguous() if conv else y

        def layer(m=m, x=x):
            return m(x)

        fns += [quant, mm, rescale, layer, ref]
        bias_b = 0 if m.bias is None else O * 2
        int8_bytes = math.prod(x_shape) * 2 + O * K + O * 4 + bias_b + M * O * 2
        bf16_bytes = math.prod(x_shape) * 2 + O * K * 2 + M * O * 2 + bias_b
        rows.append(dict(kind="conv" if conv else "dense", weight=list(w_shape),
                         input=list(x_shape), M=M, K=K, N=O, launches_per_unet_call=n,
                         int8_bound_ms=1e3 * max(int8_bytes / PEAK_BYTES_PER_S,
                                                 2 * M * K * O / PEAK_INT8_OPS),
                         bf16_bound_ms=1e3 * max(bf16_bytes / PEAK_BYTES_PER_S,
                                                 2 * M * K * O / PEAK_FLOPS[torch.bfloat16])))
    ms = [graph_ms(fn) for fn in fns]
    for i, row in enumerate(rows):
        q, mm_, rs, whole, ref = ms[5 * i:5 * i + 5]
        row.update(quantize_ms=q, int_mm_ms=mm_, rescale_ms=rs, int8_layer_ms=whole,
                   bf16_ms=ref)
    tot = {k: total(r[k] * r["launches_per_unet_call"] if r[k] is not None else None
                    for r in rows) for k in ("int8_layer_ms", "bf16_ms", "quantize_ms",
                                             "int_mm_ms", "rescale_ms")}
    for r in sorted(rows, key=lambda r: -(r["bf16_ms"] or 0) * r["launches_per_unet_call"]):
        log(f"phase 26.5: {r['kind']:5s} w {tuple(r['weight'])} x {tuple(r['input'])} "
            f"(M {r['M']}, K {r['K']}, N {r['N']}) x{r['launches_per_unet_call']}: quantize "
            f"{fmt_ms(r['quantize_ms'])} + _int_mm {fmt_ms(r['int_mm_ms'])} + rescale "
            f"{fmt_ms(r['rescale_ms'])}; layer {fmt_ms(r['int8_layer_ms'])} ms (bound "
            f"{r['int8_bound_ms']:.4f}) against bf16 {fmt_ms(r['bf16_ms'])} ms (bound "
            f"{r['bf16_bound_ms']:.4f})")
    log(f"phase 26.5: per UNet call (device ms, {card_line()}): int8 layers {tot}")
    return dict(rows=rows, per_unet_call=tot)


def run_w8a8_sd21(pipe, counters, sd21_results):
    """Phase 26 on phase 3's SD-2.1 pipeline: the defaults and include_convs
    on copies of it, in turns with it; the exactness, quality and per-shape
    readings.  -> (readings, the dense W8A8 pipeline)."""
    import numpy as np

    from ml_stable_diffusion_torch.compress.w8a8 import (
        capture_activation_scales,
        quantize_tree_dense_int8,
        w8a8_interceptor,
        w8a8_serving_swap,
    )
    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
    from ml_stable_diffusion_torch.pipelines.sd import _own_tree

    out = {}
    snapshot = {k: v.detach().clone() for k, v in pipe.unet.state_dict().items()}
    pipes = {"bf16": pipe}
    gen = torch.Generator(device="cuda").manual_seed(26)
    inputs = unet_call_inputs(gen)
    for label, kw in (("w8a8", {}), ("w8a8_convs", dict(include_convs=True))):
        w8 = copy.copy(pipe)
        (_, secs) = timed_call(lambda: w8.enable_w8a8(**kw))
        layers = int8_layers(w8.unet)
        records = int_mm_records(w8.unet, inputs)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with torch.inference_mode():
            w8.unet(*inputs)
        torch.cuda.synchronize()
        out[label] = dict(enable_s=secs, int8_layers=len(layers), int_mm_records=records,
                          unet_bytes=module_bytes(w8.unet),
                          unet_call_peak_bytes=torch.cuda.max_memory_allocated() - before)
        log(f"phase 26, {label}: enable_w8a8({kw}) in {secs:.2f} s: {len(layers)} int8 layers, "
            f"{records} aten::_int_mm records in one UNet call; UNet "
            f"{out[label]['unet_bytes'] / 2**30:.3f} GiB on the card against "
            f"{module_bytes(pipe.unet) / 2**30:.3f} (bf16); one UNet call's peak above rest "
            f"{out[label]['unet_call_peak_bytes'] / 2**30:.3f} GiB")
        if records != len(layers) or not layers:
            fail(f"{label}: {records} _int_mm records in one UNet call for {len(layers)} layers")
        pipes[label] = w8
    out["bf16_unet_bytes"] = module_bytes(pipe.unet)
    if not all(torch.equal(v, pipe.unet.state_dict()[k]) for k, v in snapshot.items()):
        fail("enable_w8a8 changed phase 3's UNet")
    del snapshot
    turns = run_in_turns(pipes, {"bf16": "sd21", "w8a8": "sd21_w8a8",
                                 "w8a8_convs": "sd21_w8a8_convs"}, counters)
    same = np.array_equal(turns["bf16"]["results"][0].latents, sd21_results[1].latents)
    if not same:
        fail("phase 3's pipeline no longer gives its own latents after enable_w8a8 on a copy")
    for label in pipes:
        t = turns[label]
        rel = latents_rel(t["results"][0].latents, turns["bf16"]["results"][0].latents)
        out.setdefault(label, {}).update(
            seconds_per_step=t["seconds_per_step"], seconds_per_step_runs=t["runs"],
            device_busy_share=t["device_busy_share"], latents_rel_vs_bf16=rel)
        log(f"phase 26, {label}: {t['seconds_per_step'] * 1e3:.2f} ms/step (median of "
            f"{len(t['runs'])} in turns; runs {[round(s * 1e3, 2) for s in t['runs']]}), busy "
            f"{100 * t['device_busy_share']:.1f} %, latents against bf16 {rel:.3g} (rel) "
            f"({card_line()})")
    out["phase3_replay_bit_equal"] = True
    calls = record_int8_calls(pipes["w8a8_convs"].unet, inputs)
    out["exactness"] = check_int8_exactness(calls)
    out["per_shape"] = int8_shape_table(calls)
    del pipes["w8a8_convs"], calls
    free_card()

    # 26.4: calibrated scales on variance-preserving weights
    vgen = torch.Generator(device="cuda").manual_seed(4)
    with torch.device("meta"):
        unet = UNet2DConditionModel(UNetConfig.sd21())
    unet = materialize(unet, vgen, torch.bfloat16, std=None).eval()
    calib = [unet_call_inputs(vgen) for _ in range(2)]
    test = unet_call_inputs(vgen)
    scales = capture_activation_scales(unet, lambda b: unet(*b), calib)
    weights = {k: v for k, v in quantize_tree_dense_int8(
        unet, skip_patterns=("to_out.0",)).items() if k in scales}
    served = _own_tree(unet, weights)
    w8a8_serving_swap(served, scales, weights)
    out["quality"] = dict(calibrated_layers=len(weights),
                          **int8_layers_vs_simulation(served, unet, scales, test, "26.4"))
    with torch.inference_mode():
        ref = unet(*test)
        got = served(*test)
        with w8a8_interceptor(unet, scales, set(weights)):
            sim = unet(*test)
    torch.cuda.synchronize()
    _, psnr, _ = psnr_db(got, ref)
    _, rel_float = abs_and_rel_rms(got, ref)
    _, sim_rel = abs_and_rel_rms(got, sim)
    out["quality"].update(psnr_vs_float_db=psnr, rel_rms_vs_float=rel_float,
                          rel_rms_vs_simulation=sim_rel)
    log(f"phase 26.4: calibrated W8A8 UNet call ({len(weights)} layers, scales from two "
        f"calibration calls): PSNR {psnr:.2f} dB (rel RMS {rel_float:.3g}) against the float "
        f"call; the whole call against the fake-quant simulation (w8a8_interceptor) rel RMS "
        f"{sim_rel:.3g}")
    del unet, served, ref, got, sim
    free_card()
    return out, pipes["w8a8"]


def _rel_rms(got, ref) -> float:
    """``abs_and_rel_rms``'s relative RMS, 0 where both are zero."""
    diff = (got.float() - ref.float()).norm().item()
    return 0.0 if diff == 0 else diff / ref.float().norm().item()


def int8_layers_vs_simulation(served, float_module, scales, inputs, phase: str) -> dict:
    """Each int8 Linear of one eager call of ``served`` against its float32
    simulation on the same input, and the control: the float layer of
    ``float_module`` (same name) on that input against the same simulation.
    Fails unless every layer is read, every int8 reading is within
    ``W8A8_LAYER_REL_RMS`` and every control reading above it."""
    import torch.nn.functional as F

    from ml_stable_diffusion_torch.ops.int8 import Int8Linear, quantize_weight_int8

    layers = int8_layers(served)
    readings = {}

    def hook(name):
        def fn(mod, args, y):
            x, fl = args[0], float_module.get_submodule(name)
            s = max(float(scales[name]), 1e-8) / 127.0
            qx = torch.clamp(torch.round(x / torch.full((), s, dtype=x.dtype, device=x.device)),
                             -127, 127)
            wq, ws = quantize_weight_int8(fl.weight)
            sim = F.linear(qx.float() * s, wq.float() * ws)
            flo = F.linear(x, fl.weight.to(x.dtype))
            if fl.bias is not None:
                sim, flo = sim + fl.bias.float(), flo + fl.bias.to(x.dtype)
            readings[name] = (_rel_rms(y, sim), _rel_rms(flo, sim))
        return fn

    if not all(isinstance(m, Int8Linear) for m in layers.values()):
        fail(f"phase {phase}: the per-layer simulation reads Linear layers only")
    hooks = [m.register_forward_hook(hook(k)) for k, m in layers.items()]
    try:
        with torch.inference_mode():
            served(*inputs)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    int8 = {k: r[0] for k, r in readings.items()}
    control = {k: r[1] for k, r in readings.items()}
    worst, closest = max(int8, key=int8.get), min(control, key=control.get)
    out = dict(layers_read=len(readings), layer_bound=W8A8_LAYER_REL_RMS,
               layer_rel_rms_vs_simulation_max=int8[worst],
               layer_rel_rms_vs_simulation_median=statistics.median(int8.values()),
               layer_rel_rms_vs_simulation_worst=worst,
               float_layer_rel_rms_vs_simulation_min=control[closest],
               float_layer_rel_rms_vs_simulation_median=statistics.median(control.values()),
               float_layer_rel_rms_vs_simulation_closest=closest)
    log(f"phase {phase}: {len(readings)} int8 layers of one call, each against its float32 "
        f"simulation on its own input: median {out['layer_rel_rms_vs_simulation_median']:.3g}, "
        f"max {int8[worst]:.3g} ({worst}); the float layer against the same simulation "
        f"(control): min {control[closest]:.3g} ({closest}), median "
        f"{out['float_layer_rel_rms_vs_simulation_median']:.3g}; bound {W8A8_LAYER_REL_RMS}")
    if len(readings) != len(layers) or not (int8[worst] <= W8A8_LAYER_REL_RMS
                                            < control[closest]):
        fail(f"phase {phase}: {len(readings)} of {len(layers)} int8 layers read; max "
             f"{int8[worst]} ({worst}) and control min {control[closest]} ({closest}) "
             f"against the bound {W8A8_LAYER_REL_RMS}")
    return out


def denoiser_call_inputs(module, gen, hw: int) -> tuple:
    """The inputs of one CFG-batch call of a full-width UNet (SDXL's added
    conditions when it has them) or MMDiT at latent size ``hw``."""
    cfg = module.config
    x = torch.randn(2, cfg.in_channels, hw, hw, generator=gen, device="cuda")
    t = torch.tensor(500.0, device="cuda")
    if hasattr(cfg, "pooled_dim"):
        return (x, t, torch.randn(2, 154, cfg.context_dim, generator=gen, device="cuda"),
                torch.randn(2, cfg.pooled_dim, generator=gen, device="cuda"))
    ctx = torch.randn(2, 77, cfg.cross_attention_dim, generator=gen, device="cuda")
    if cfg.addition_embed_type is None:
        return x, t, ctx
    size = 8 * hw
    text = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
    return x, t, ctx, {"text_embeds": torch.randn(2, text, generator=gen, device="cuda"),
                       "time_ids": torch.tensor([[size, size, 0.0, 0.0, size, size]] * 2,
                                                device="cuda")}


def run_w8a8_family(pipe, path, counters):
    """Phase 27 on phase 7's SDXL base or phase 5's SD3 pipeline: W8A8
    (dense) on a copy, in turns with the bf16 pipeline.  -> (readings, the
    W8A8 pipeline)."""
    w8 = copy.copy(pipe)
    _, secs = timed_call(lambda: w8.enable_w8a8())
    gen = torch.Generator(device="cuda").manual_seed(27)
    layers = int8_layers_vs_simulation(
        w8.unet, pipe.unet, w8.int8_act_scales,
        denoiser_call_inputs(pipe.unet, gen, PATHS[path]["image_hw"][0] // 8), f"27, {path}")
    free_card()
    turns = run_in_turns({"bf16": pipe, "w8a8": w8}, {"bf16": path, "w8a8": f"{path}_w8a8"},
                         counters)
    out = dict(enable_s=secs, int8_layers=len(int8_layers(w8.unet)),
               unet_bytes=module_bytes(w8.unet), bf16_unet_bytes=module_bytes(pipe.unet),
               layers_vs_simulation=layers)
    for label, t in turns.items():
        out[label] = dict(seconds_per_step=t["seconds_per_step"],
                          seconds_per_step_runs=t["runs"],
                          device_busy_share=t["device_busy_share"])
        log(f"phase 27, {path} {label}: {t['seconds_per_step'] * 1e3:.2f} ms/step (median of "
            f"{len(t['runs'])} in turns; runs {[round(s * 1e3, 2) for s in t['runs']]}), busy "
            f"{100 * t['device_busy_share']:.1f} % ({card_line()})")
    out["latents_rel_vs_bf16"] = latents_rel(turns["w8a8"]["results"][0].latents,
                                             turns["bf16"]["results"][0].latents)
    out["latents"] = turns["w8a8"]["results"][0].latents
    log(f"phase 27, {path}: {out['int8_layers']} int8 layers, enable_w8a8 in {secs:.2f} s; "
        f"denoiser {out['unet_bytes'] / 2**30:.3f} GiB against {out['bf16_unet_bytes'] / 2**30:.3f}"
        f" (bf16); latents against bf16 {out['latents_rel_vs_bf16']:.3g} (rel); launches as "
        f"the bf16 path's")
    return out, w8


def run_w8a8_staged(pipe, unstaged_latents, counters):
    """Phase 29.2: phase 7's SDXL base with W8A8, on copies of its modules
    (offloading rebinds a module's tensors, and phase 7's pipeline goes on
    with its own), offloaded and staged: the int8 buffers packed with the
    base UNet (its stage moves them), latents bit-equal to phase 27's
    unstaged generation 1."""
    import numpy as np

    w8 = copy.copy(pipe)
    for name in ("text_encoder", "text_encoder2", "unet", "vae_decoder"):
        setattr(w8, name, copy.deepcopy(getattr(pipe, name)))
    w8.enable_w8a8()
    w8.offload_params_to_host()
    pack = w8._host_weights[id(w8.unet)]
    base = pack.flat.untyped_storage().data_ptr()
    inside = all(base <= t.untyped_storage().data_ptr() < base + pack.nbytes
                 for m in int8_layers(w8.unet).values() for t in m.buffers())
    if not inside:
        fail("W8A8 staged: the int8 buffers are not packed with the base UNet")
    free_card()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    res, launched, _ = launches_of(w8, counters, lambda: w8.generate_images(
        main_cfg("sdxl_w8a8", 1, reduce_memory=True), image_hw=PATHS["sdxl"]["image_hw"]))
    peak = torch.cuda.max_memory_allocated()
    if launched != PATHS["sdxl"]["per_generation"]:
        fail(f"W8A8 staged launched {launched}")
    same = bool(np.array_equal(res.latents, unstaged_latents))
    stages = [dict(stage=n, bytes=b, seconds=s) for n, b, s in w8.stage_transfers]
    log(f"phase 29.2: SDXL base W8A8 staged: latents {'bit-equal' if same else 'DIFFERENT'} to "
        f"phase 27's unstaged ones; peak {peak / 2**30:.3f} GiB; stages "
        + ", ".join(f"{s['stage']} {s['bytes'] / 1e9:.3f} GB" for s in stages)
        + "; the int8 weights move with the base UNet's stage")
    if not same or [s["stage"] for s in stages] != ["encode", "unet", "decode"]:
        fail(f"W8A8 staged: latents bit-equal {same}, stages {stages}")
    return dict(latents_bit_equal=same, stages=stages, max_memory_allocated=peak,
                int8_packed_with_unet=inside, seconds_per_step=res.seconds_per_step)


def run_fuse_qkv(pipe, root: Path, counters, sd21_results):
    """Phase 28: phase 20's diffusers directory loaded with fuse_qkv=True:
    one generation bit-equal to phase 3's of the same prompt and seed (the
    fused GEMM reduces each output over K as the three did: cuBLAS tiles N
    = 3C as it tiles C at these shapes, and a slip in the split or concat
    would show in every bit), 301 flash launches, s/step in turns with
    phase 3's pipeline."""
    import numpy as np

    from ml_stable_diffusion_torch.convert.load import load_pipeline

    fused = load_pipeline(root, compute_dtype=torch.bfloat16, fuse_qkv=True, device="cuda")
    n = sum(1 for k, _ in fused.unet.named_modules() if k.endswith("attn1.to_qkv"))
    turns = run_in_turns({"unfused": pipe, "fused": fused},
                         {"unfused": "sd21", "fused": "sd21_fused_qkv"}, counters)
    got = turns["fused"]["results"][0].latents
    want = sd21_results[1].latents
    same = bool(np.array_equal(got, want))
    _, rel = abs_and_rel_rms(torch.from_numpy(got), torch.from_numpy(want))
    out = dict(fused_projections=n, latents_bit_equal=same, latents_rel_rms_vs_unfused=rel,
               **{f"{k}_seconds_per_step": t["seconds_per_step"] for k, t in turns.items()},
               **{f"{k}_device_busy_share": t["device_busy_share"] for k, t in turns.items()})
    log(f"phase 28: fuse_qkv ({n} fused self-attention projections): latents "
        f"{'bit-equal' if same else 'DIFFERENT'} to phase 3's (rel RMS {rel:.3g}); s/step fused "
        f"{out['fused_seconds_per_step'] * 1e3:.2f} ms, unfused "
        f"{out['unfused_seconds_per_step'] * 1e3:.2f} ms (one replay each, in turns; "
        f"{card_line()})")
    if not same or n != 16:
        fail(f"fuse_qkv: {n} fused projections, latents bit-equal {same} (rel RMS {rel})")
    del fused
    free_card()
    return out


# -- phases 31 and 32 ----------------------------------------------------------------

#: the convert-time gates phase 31.2 must print (phase 20's directory holds
#: no safety checker)
CONVERT_GATES = {"text_encoder", "unet", "vae_decoder", "vae_encoder"}


def run_command_line(tmpdir: Path, counters, diffusers_res, diffusers_first, sd21_main) -> dict:
    """Phase 31: the port's command line on phase 20's diffusers directory.
    31.1 ``generate`` with phase 20's first generation flag for flag: its
    PNG, read back by ``utils/png.py``, bit-equal to phase 20's image, the
    counters grown by phase 20's launches, the file name ``_name``'s.  31.2
    ``convert --convert-all --check-output-correctness
    --bundle-resources-for-generation``: each convert-time gate's dB (full
    width, float32, on the card), the bundle's bytes and seconds, and
    ``load_pipeline_from_artifacts`` on the bundle giving phase 20's
    latents bit for bit with phase 20's launches.  31.3 ``benchmark
    --repeats 1 --step-count 20 --scheduler DPMSolverMultistep``: its
    report beside phase 3's captured s/step, the warm-up's and the repeat's
    launches."""
    import numpy as np

    from ml_stable_diffusion_torch.cli import benchmark, convert, generate
    from ml_stable_diffusion_torch.convert.load import load_pipeline_from_artifacts
    from ml_stable_diffusion_torch.utils import png

    root, spec = tmpdir / "sd21", PATHS["sd21"]
    want = diffusers_res["launches"]
    out = {}

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    # 31.1 generate
    argv = [PROMPTS[0], "-i", str(root), "-o", str(tmpdir / "generate"), "--seed", "1000",
            "--step-count", str(STEPS), "--scheduler", spec["scheduler"], "--guidance-scale",
            str(spec["guidance"]), "--rng", "numpy", "--disable-safety", "--size",
            "x".join(map(str, spec["image_hw"]))]
    reset_counters(counters)
    t0 = time.perf_counter()
    paths = generate.run(generate.parser_spec().parse_args(argv))
    secs = time.perf_counter() - t0
    launched = counts()
    free_card()
    name = generate._name(PROMPTS[0], 1000, 0)
    same = bool(np.array_equal(png.read_png(paths[0]), diffusers_first.images[0]))
    out["generate"] = dict(seconds=secs, file=paths[0].name, png_bit_equal=same,
                           launches=launched)
    log(f"phase 31.1: generate -> {paths[0].name} in {secs:.2f} s (the pipeline's load "
        f"included); PNG {'bit-equal' if same else 'DIFFERENT'} to phase 20's image; "
        f"launches {launched} (phase 20's {want})")
    if [p.name for p in paths] != [name] or not same or launched != want:
        fail(f"generate: files {[p.name for p in paths]} (want {name}), PNG bit-equal {same}, "
             f"launches {launched} (want {want})")

    # 31.2 convert, then the bundle's generation
    bundle = tmpdir / "bundle"
    t0 = time.perf_counter()
    report = convert.run(convert.parser_spec().parse_args(
        ["-i", str(root), "-o", str(bundle), "--convert-all", "--check-output-correctness",
         "--bundle-resources-for-generation"]))
    convert_s = time.perf_counter() - t0
    free_card()
    nbytes = sum(f.stat().st_size for f in bundle.rglob("*") if f.is_file())
    gates = report["psnr_db"]
    for label, db in sorted(gates.items()):
        log(f"phase 31.2: convert gate {label}: {db:.2f} dB (>= 35; full width, float32 on "
            f"the card)")
    log(f"phase 31.2: convert --convert-all --check-output-correctness: {nbytes / 1e9:.3f} GB "
        f"bundle in {convert_s:.2f} s (the gates and the reload checks included)")
    if set(gates) != CONVERT_GATES or min(gates.values()) < 35.0:
        fail(f"convert gates {gates}: want {sorted(CONVERT_GATES)}, each >= 35 dB")
    t0 = time.perf_counter()
    loaded = load_pipeline_from_artifacts(bundle, compute_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    reset_counters(counters)
    res = loaded.generate_images(main_cfg("sd21", 0), image_hw=spec["image_hw"])
    bundle_launched = counts()
    del loaded
    free_card()
    same_latents = bool(np.array_equal(res.latents, diffusers_first.latents))
    out["convert"] = dict(psnr_db=gates, bundle_bytes=nbytes, seconds=convert_s,
                          bundle_load_s=load_s, latents_bit_equal=same_latents,
                          launches=bundle_launched)
    log(f"phase 31.2: load_pipeline_from_artifacts in {load_s:.2f} s; latents "
        f"{'bit-equal' if same_latents else 'DIFFERENT'} to phase 20's; launches "
        f"{bundle_launched}")
    if not same_latents or bundle_launched != want:
        fail(f"the bundle's generation: latents bit-equal {same_latents}, launches "
             f"{bundle_launched} (want {want})")

    # 31.3 benchmark: the warm-up captures, the repeat replays
    reset_counters(counters)
    t0 = time.perf_counter()
    bench = benchmark.run(benchmark.parser_spec().parse_args(
        ["-i", str(root), "--repeats", "1", "--step-count", str(STEPS), "--scheduler",
         "DPMSolverMultistep", "-o", str(tmpdir / "benchmark.json")]))
    secs = time.perf_counter() - t0
    launched = counts()
    free_card()
    want_bench = {k: want[k] + spec["per_generation"][k] for k in want}
    out["benchmark"] = dict(report=bench, seconds=secs, launches=launched,
                            phase3_seconds_per_step=sd21_main["seconds_per_step"])
    log(f"phase 31.3: benchmark {json.dumps(bench)} in {secs:.2f} s; its s/step "
        f"{bench['seconds_per_step_median'] * 1e3:.2f} ms against phase 3's captured "
        f"{sd21_main['seconds_per_step'] * 1e3:.2f} ms ({card_line()}); launches {launched}")
    if launched != want_bench:
        fail(f"benchmark: launches {launched}, want {want_bench} (a first call and a replay)")
    return out


def run_native_libraries(pipe, tmpdir: Path, sd21_first) -> dict:
    """Phase 32: the native host libraries (``utils/native.py``, built in
    phase 1), each required (a native path not taken fails the run): the
    build's seconds; the C++ BPE's ids against the Python tokenizer's on
    PROMPTS and phase 16's four-window prompt; ``denormalize_to_uint8``'s
    converter against its numpy rule on phase 3's first latents decoded in
    float32; the C++ unigram Viterbi against the Python segmentation on
    phase 18's ``tokenizer.json``; the C++ safetensors header parse against
    the Python parse of phase 20's UNet file."""
    import numpy as np

    from ml_stable_diffusion_torch.convert import native_io
    from ml_stable_diffusion_torch.tokenizer import CLIPTokenizer
    from ml_stable_diffusion_torch.tokenizer.native import NativeCLIPTokenizer
    from ml_stable_diffusion_torch.tokenizer.t5 import T5Tokenizer
    from ml_stable_diffusion_torch.utils import native
    from ml_stable_diffusion_torch.utils.image import denormalize_to_uint8_numpy
    from ml_stable_diffusion_torch.utils.native_image import denormalize_to_uint8_native

    if native.build_seconds is None:
        fail("the native libraries were not built in phase 1")
    out = dict(build_s=native.build_seconds, build_dir=str(native.BUILD_DIR))
    log(f"phase 32: native libraries built in phase 1 in {native.build_seconds:.2f} s into "
        f"{native.BUILD_DIR}")

    texts = PROMPTS + [LONG_PROMPT]
    tokdir = tmpdir / "sd21" / "tokenizer"
    py = CLIPTokenizer.from_pretrained_dir(tokdir)
    nat = NativeCLIPTokenizer(tokdir / "vocab.json", tokdir / "merges.txt", fallback=py)
    for text in texts:
        if nat.encode(text) != py.encode(text) or not all(
                np.array_equal(a, b) for a, b in zip(nat.tokenize(text), py.tokenize(text))):
            fail(f"native BPE ids differ from the Python tokenizer's on {text!r}")
    if nat.native_calls < 2 * len(texts):
        fail(f"the native BPE encoded {nat.native_calls} of {2 * len(texts)} prompts")
    out["bpe"] = dict(prompts=len(texts), native_calls=nat.native_calls, ids_equal=True)

    with torch.inference_mode():
        z = torch.from_numpy(sd21_first.latents).to("cuda").permute(0, 3, 1, 2)
        x = pipe.vae_decoder(z / pipe.default_latent_scale).permute(0, 2, 3, 1).float()
        x = np.ascontiguousarray(x.cpu().numpy())
    t0 = time.perf_counter()
    got = denormalize_to_uint8_native(x)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = denormalize_to_uint8_numpy(x)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    same = bool(np.array_equal(got, want))
    # the pipeline's own decode rounds halves to even on the card
    off_by_rounding = int((got != sd21_first.images).sum())
    out["image"] = dict(values=int(x.size), equal=same, native_ms=native_ms, numpy_ms=numpy_ms,
                        differ_from_device_rounding=off_by_rounding)
    if not same:
        fail(f"native denormalize_to_uint8 differs from numpy on {int((got != want).sum())} "
             "values")

    t5_path = t5_tokenizer_json(tmpdir / "t5_tokenizer.json")
    nat5, py5 = T5Tokenizer(t5_path), T5Tokenizer(t5_path, prefer_native=False)
    if not nat5.uses_native:
        fail("T5Tokenizer did not take the native unigram path")
    for text in texts:
        if nat5.encode(text) != py5.encode(text):
            fail(f"native unigram ids differ from the Python path's on {text!r}")
    if nat5.native_calls == 0:
        fail("the native unigram encoded no prompt")
    out["unigram"] = dict(prompts=len(texts), native_calls=nat5.native_calls, ids_equal=True)

    unet_file = tmpdir / "sd21" / "unet" / "diffusion_pytorch_model.safetensors"
    t0 = time.perf_counter()
    parsed = native_io.parse_table(unet_file, native=True)
    native_parse_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    parsed_py = native_io.parse_table(unet_file, native=False)
    python_parse_ms = (time.perf_counter() - t0) * 1e3
    same_table = parsed[0] == parsed_py[0] and sorted(parsed[1]) == sorted(parsed_py[1])
    out["header"] = dict(tensors=len(parsed[1]), equal=same_table, native_ms=native_parse_ms,
                         python_ms=python_parse_ms)
    if not same_table:
        fail("the native safetensors header parse differs from the Python parse")
    log(f"phase 32: native paths taken and equal: BPE {out['bpe']}, image {out['image']}, "
        f"unigram {out['unigram']}, header {out['header']}")
    return out


def run_serving_preset(w8):
    """Phase 25's preset: the dense W8A8 SD-2.1 pipeline with DeepCache at
    interval 2 behind a server of batch 4: four submits coalesced into one
    batch, the batch bit-equal to the pipeline's merged generation, each
    request finite."""
    import numpy as np

    from ml_stable_diffusion_torch.pipelines import PipelineConfiguration
    from ml_stable_diffusion_torch.serving import GenerationServer, ServeConfig

    hw = (512, 512)
    server = GenerationServer(w8, [ServeConfig(image_hw=hw, step_count=STEPS,
                                               scheduler="DPMSolverMultistep",
                                               guidance_scale=7.5, deepcache_interval=2)],
                              max_batch=4, batch_window_s=0.5)
    out = {}
    try:
        _, out["precompile_s"] = timed_call(lambda: server.precompile(batch_sizes=(4,)))
        cfgs = [PipelineConfiguration(prompt=PROMPTS[i], seed=5100 + i, step_count=STEPS,
                                      scheduler="DPMSolverMultistep", guidance_scale=7.5,
                                      deepcache_interval=2, rng="numpy", disable_safety=True)
                for i in range(4)]
        t0 = time.perf_counter()
        results = [f.result(timeout=600) for f in [server.submit(c, image_hw=hw) for c in cfgs]]
        out["batch_wall_s"] = time.perf_counter() - t0
        out["requests_per_s"] = len(cfgs) / out["batch_wall_s"]
        merged = w8.generate_images(dataclasses.replace(
            cfgs[0], prompt=[c.prompt for c in cfgs], seed=[c.seed for c in cfgs],
            negative_prompt=[c.negative_prompt for c in cfgs], image_count=4), image_hw=hw)
        same = bool(np.array_equal(np.concatenate([r.latents for r in results]),
                                   merged.latents))
        finite = all(bool(np.isfinite(r.latents).all()) for r in results)
        out.update(batches_run=server.batches_run, batch_bit_equal_to_merged=same,
                   each_finite=finite)
    finally:
        server.shutdown()
    log(f"phase 25, the W8A8 + DeepCache 2 + batch-4 preset: precompile {out['precompile_s']:.2f}"
        f" s; four submits in {out['batches_run']} batch(es), {out['batch_wall_s']:.3f} s, "
        f"{out['requests_per_s']:.2f} requests/s ({card_line()}); the batch "
        f"{'bit-equal' if out['batch_bit_equal_to_merged'] else 'NOT equal'} to the merged "
        f"generation; each request finite: {out['each_finite']}")
    if out["batches_run"] != 1 or not out["batch_bit_equal_to_merged"] or not out["each_finite"]:
        fail(f"the serving preset: {out}")
    return out


def run_palettized_staged(pipe, unstaged_latents):
    """Phase 29.1: phase 9's pipeline in program mode, its weights offloaded,
    one staged generation: the stages gather their own palettized weights,
    the latents equal the unstaged program mode's bit for bit; the peak of
    both."""
    import numpy as np

    out = {}
    free_card()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    unstaged = fixed_latents(pipe)
    out["unstaged_peak_bytes"] = torch.cuda.max_memory_allocated()
    if not np.array_equal(unstaged, unstaged_latents):
        fail("palettized program mode: a second generation differs from the first")
    pipe.offload_params_to_host()
    free_card()
    at_rest = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    staged = pipe.generate_images(dataclasses.replace(fixed_cfg(), reduce_memory=True),
                                  image_hw=PATHS["sd21"]["image_hw"]).latents
    out.update(staged_peak_bytes=torch.cuda.max_memory_allocated(),
               unstaged_at_rest_bytes=base, staged_at_rest_bytes=at_rest,
               stages=[dict(stage=n, bytes=b, seconds=t) for n, b, t in pipe.stage_transfers])
    same = bool(np.array_equal(staged, unstaged))
    out["latents_bit_equal"] = same
    log(f"phase 29.1: palettized program mode staged with offloaded weights: latents "
        f"{'bit-equal' if same else 'DIFFERENT'} to unstaged program mode; peak "
        f"{out['staged_peak_bytes'] / 2**30:.3f} GiB ({at_rest / 2**30:.3f} at rest) against "
        f"{out['unstaged_peak_bytes'] / 2**30:.3f} GiB unstaged ({base / 2**30:.3f} at rest); "
        f"stages {[(s['stage'], round(s['bytes'] / 1e9, 3)) for s in out['stages']]}")
    if not same:
        fail("palettized program mode: staged latents differ from unstaged, max abs "
             f"{float(np.abs(staged - unstaged).max())}")
    return out


# -- phase 30 -----------------------------------------------------------------------

TRAIN_LR = 1e-5
TRAIN_STEPS = 3
TRAIN_BATCH = 2
#: parameters of UNetConfig.sd21()
SD21_UNET_PARAMS = 865_910_724


def layer_flops_by_shapes(model, *inputs) -> int:
    """One forward's flops worked out from shapes: 2 x the multiply-adds of
    every convolution and linear layer (weight and output shapes), plus
    attention's two products, 4 B Sq Sk C."""
    from ml_stable_diffusion_torch.models.unet import Attention

    total = 0

    def conv(m, args, out):
        nonlocal total
        total += 2 * out.numel() * m.weight[0].numel()

    def linear(m, args, out):
        nonlocal total
        total += 2 * out.numel() * m.in_features

    def attn(m, args, out):
        nonlocal total
        x = args[0]
        context = args[1] if len(args) > 1 and args[1] is not None else x
        total += 4 * x.shape[0] * x.shape[1] * context.shape[1] * x.shape[2]

    kinds = {torch.nn.Conv2d: conv, torch.nn.Linear: linear, Attention: attn}
    hooks = [m.register_forward_hook(kinds[type(m)]) for m in model.modules()
             if type(m) in kinds]
    try:
        with torch.inference_mode():
            model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return total


def print_summary(label: str, summary: dict, rows: int = 6):
    log(f"{label}: {summary['total_ms_per_step']:.3f} ms of device time")
    for key in ("by_category", "by_source"):
        for r in summary[key][:rows]:
            tf = "" if r["tflops"] is None else f", {r['tflops']:.2f} TFLOP/s"
            log(f"  {key} {r['name']}: {r['us_per_step']:.1f} us, "
                f"{r['launches_per_step']:g} launches{tf}")


def run_generation_trace(pipe, counters) -> dict:
    """Phase 30.4-30.5 on phase 3's pipeline, its program captured: one
    SD-2.1 generation (a replay) under ``utils.profiling.trace``, its flash
    family held to the kernels of the path's 301 wrapper launches; then
    ``cost_summary`` of one UNet forward at CFG batch 2 on the plain
    attention path, beside the count worked out from the layers' shapes."""
    from ml_stable_diffusion_torch.ops.attention import AttentionImpl, set_attention_implementation
    from ml_stable_diffusion_torch.ops.flash_attention import wide_f32_plan
    from ml_stable_diffusion_torch.utils.profiling import cost_summary, trace, trace_summary

    spec = PATHS["sd21"]
    flash = spec["per_generation"]["flash_attention"]
    # the VAE head is one wrapper launch of three kernels: the split pre-pass,
    # the 3xTF32 kernel and, with kv splits, the combine pass
    wide = 2 + int(wide_f32_plan([4096], 4096, 1, 1).splits > 1)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with trace(d):
            _, launched, _ = launches_of(pipe, counters, lambda: pipe.generate_images(
                main_cfg("sd21", 0), image_hw=spec["image_hw"]))
        traced_s = time.perf_counter() - t0
        summary = trace_summary(d, steps=1, top=8)
    if launched != spec["per_generation"]:
        fail(f"phase 30: the traced generation launched {launched}")
    families = {r["name"]: r for r in summary["by_category"]}
    got = families.get("flash", {}).get("launches_per_step")
    if got != flash - 1 + wide:
        fail(f"phase 30: the trace's flash family holds {got} kernels, want {flash - 1} bf16 "
             f"+ {wide} for the VAE head")
    print_summary("phase 30.4: SD-2.1 generation (captured) under trace", summary)

    unet = pipe.unet
    g = torch.Generator().manual_seed(30)
    inputs = (torch.randn(2, 4, 64, 64, generator=g).cuda(), torch.tensor([999.0, 999.0]).cuda(),
              torch.randn(2, 77, 1024, generator=g).cuda())
    set_attention_implementation(AttentionImpl.PLAIN)
    try:
        with torch.inference_mode():
            cost = cost_summary(unet, *inputs)
        by_shapes = layer_flops_by_shapes(unet, *inputs)
    finally:
        set_attention_implementation(AttentionImpl.AUTO)
    log(f"phase 30.5: cost_summary of one SD-2.1 UNet forward at batch 2 (bf16, plain "
        f"attention): {cost['flops'] / 1e12:.4f} TFLOP against {by_shapes / 1e12:.4f} from the "
        f"layers' shapes; compute bound {cost['compute_bound_ms']:.3f} ms, bandwidth bound "
        f"{cost['bandwidth_bound_ms']:.3f} ms")
    if cost["flops"] != by_shapes:
        fail(f"phase 30.5: cost_summary counts {cost['flops']} flops, the shapes {by_shapes}")
    return dict(generation_trace=summary, traced_generation_s=traced_s, flash_kernels=got,
                unet_forward_cost=cost, unet_forward_flops_by_shapes=by_shapes)


def check_kernels_refuse_grad(counters):
    """Phase 30.2: each kernel wrapper on CUDA inputs that require grad
    raises, and launches nothing."""
    from ml_stable_diffusion_torch.ops.flash_attention import (
        flash_attention_cuda,
        flash_attention_multi_q_cuda,
        flash_attention_wide_f32_cuda,
    )
    from ml_stable_diffusion_torch.ops.activations import geglu_cuda
    from ml_stable_diffusion_torch.ops.groupnorm import group_norm_silu_cuda
    from ml_stable_diffusion_torch.ops.palettized import palettized_dense_fused_cuda

    def leaf(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device="cuda", dtype=dtype).requires_grad_(True)

    q, k = leaf(2, 4096, 5, 64), leaf(2, 4096, 5, 64)
    wide = leaf(1, 4096, 1, 512, dtype=torch.float32)
    calls = {
        "flash_attention_cuda": lambda: flash_attention_cuda(q, k, k),
        "flash_attention_multi_q_cuda": lambda: flash_attention_multi_q_cuda([q], k, k),
        "flash_attention_wide_f32_cuda": lambda: flash_attention_wide_f32_cuda([wide], wide, wide),
        "group_norm_silu_cuda": lambda: group_norm_silu_cuda(
            leaf(2, 320, 64, 64), leaf(320), leaf(320)),
        "palettized_dense_fused_cuda": lambda: palettized_dense_fused_cuda(
            leaf(64, 320), torch.zeros(320 * 320 * 6 // 8, dtype=torch.uint8, device="cuda"),
            leaf(64), (320, 320)),
        "geglu_cuda": lambda: geglu_cuda(leaf(2, 64, 2 * 1280)),
    }
    before = {name: fn.launches for name, fn in counters.items()}
    raised = {}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            raised[name] = str(e)
        else:
            fail(f"phase 30.2: {name} ran on inputs that require grad")
    if {name: fn.launches for name, fn in counters.items()} != before:
        fail("phase 30.2: a wrapper launched its kernel under grad")
    log(f"phase 30.2: every wrapper raised under grad: {raised['flash_attention_cuda']}")
    return sorted(raised)


def training_unet_and_batch():
    """Phases 30 and 34's SD-2.1 UNet (float32, seeded N(0, 0.02) weights)
    and batch (2 latents of 4x64x64 and a 77x1024 context from seeded host
    noise, a generator on the card for the draws)."""
    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig

    with torch.device("meta"):
        unet = UNet2DConditionModel(UNetConfig.sd21())
    unet = materialize(unet, torch.Generator(device="cuda").manual_seed(30), torch.float32)
    host = torch.Generator().manual_seed(30)
    batch = {"latents": torch.randn(TRAIN_BATCH, 4, 64, 64, generator=host).cuda(),
             "context": torch.randn(TRAIN_BATCH, 77, 1024, generator=host).cuda(),
             "generator": torch.Generator(device="cuda")}
    return unet, batch


def train_steps(step_fn, state, batch, steps: int = TRAIN_STEPS):
    """``steps`` steps on the fixed batch, the draws fixed (the generator
    seeded alike before each) -> (state, losses, ms per step by CUDA
    events)."""
    losses, ms = [], []
    for _ in range(steps):
        batch["generator"].manual_seed(TRAIN_BATCH * 1000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, loss = step_fn(state, batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(loss))
    return state, losses, ms


def check_restored_state(state, restored):
    """Every parameter and optimizer moment, and the step, bit for bit."""
    if restored.step != state.step:
        fail(f"phase 30.3: restored step {restored.step}, saved {state.step}")
    for name, p in state.params.items():
        if not torch.equal(restored.params[name], p):
            fail(f"phase 30.3: restored parameter {name} differs")
    live, back = state.optimizer.state_dict(), restored.optimizer.state_dict()
    moments = 0
    for i, entry in live["state"].items():
        for key, x in entry.items():
            if not torch.equal(back["state"][i][key].to(x.device), x):
                fail(f"phase 30.3: restored optimizer {key} of parameter {i} differs")
            moments += key != "step"
    return moments


def run_training(counters) -> dict:
    """Phase 30: the training step on the card at full width.  The SD-2.1
    UNet (``UNetConfig.sd21()``, float32, seeded N(0, 0.02) weights), AdamW
    at lr 1e-5, one batch of 2 latents of 4x64x64 and a 77x1024 context from
    seeded host noise; three steps on it with fixed draws, without and then
    with remat: the loss finite and falling, s/step (median, CUDA events),
    samples/s, peak memory, and no kernel launched.  Then each wrapper's
    raise under grad (30.2), the checkpoint saved and restored bit for bit
    with the next step's loss equal under deterministic algorithms (30.3),
    and one step under ``utils.profiling.trace`` (30.4)."""
    import os

    from ml_stable_diffusion_torch.parallel import (
        adamw,
        make_train_step,
        restore_train_state,
        save_train_state,
    )
    from ml_stable_diffusion_torch.utils.profiling import trace, trace_summary

    unet, batch = training_unet_and_batch()
    n_params = sum(p.numel() for p in unet.parameters())
    if n_params != SD21_UNET_PARAMS:
        fail(f"phase 30: the SD-2.1 UNet has {n_params} parameters, want {SD21_UNET_PARAMS}")
    out = {"parameters": n_params}
    states = {}
    reset_counters(counters)
    for remat in (False, True):
        init_fn, step_fn = make_train_step(unet, adamw(TRAIN_LR), remat=remat, device="cuda")
        free_card()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, losses, ms = train_steps(step_fn, init_fn(), batch)
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            fail(f"phase 30 (remat={remat}): losses {losses} not finite and falling")
        sps = statistics.median(ms) / 1e3
        key = "remat" if remat else "no_remat"
        out[key] = dict(losses=losses, ms_per_step=ms, seconds_per_step=sps,
                        samples_per_s=TRAIN_BATCH / sps, peak_gib=peak / 2**30,
                        peak_over_start_gib=(peak - base) / 2**30)
        log(f"phase 30 (remat={remat}): losses {losses}; {sps * 1e3:.2f} ms/step (median of "
            f"{TRAIN_STEPS}, events: {[round(x, 2) for x in ms]}), {TRAIN_BATCH / sps:.2f} "
            f"samples/s, peak {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} over the "
            f"{base / 2**30:.3f} GiB at its start)")
        states[key] = (state, init_fn, step_fn)
        if remat:
            if not torch.equal(torch.tensor(losses), torch.tensor(out["no_remat"]["losses"])):
                log(f"phase 30: remat losses {losses} against {out['no_remat']['losses']}")
            del state
            states.pop(key)
    launched = {name: fn.launches for name, fn in counters.items()}
    if any(launched.values()):
        fail(f"phase 30: training launched {launched}; its paths are the plain ones")
    out["launches_in_training"] = launched
    out["refused_under_grad"] = check_kernels_refuse_grad(counters)

    # 30.3: the checkpoint round trip of the remat=False state
    state, init_fn, step_fn = states.pop("no_remat")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_train_state(d, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = restore_train_state(d, init_fn())
        restore_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in Path(d).iterdir())
    moments = check_restored_state(state, restored)
    wanted = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        next_losses = []
        for s in (state, restored):
            batch["generator"].manual_seed(TRAIN_BATCH * 1000)
            next_losses.append(float(step_fn(s, batch)[1]))
    finally:
        torch.use_deterministic_algorithms(False)
        if wanted is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = wanted
    if next_losses[0] != next_losses[1]:
        fail(f"phase 30.3: the next step's loss {next_losses[1]} from the restored state, "
             f"{next_losses[0]} from the live one")
    out["checkpoint"] = dict(bytes=ckpt_bytes, save_s=save_s, restore_s=restore_s,
                             moments=moments, next_step_loss=next_losses[0])
    log(f"phase 30.3: checkpoint of {ckpt_bytes / 2**30:.3f} GiB saved in {save_s:.2f} s, "
        f"restored in {restore_s:.2f} s; {len(state.params)} parameters, {moments} AdamW "
        f"moments and the step bit-equal; the next step's loss {next_losses[0]!r} from both")
    del state

    # 30.4: one training step under the trace
    with tempfile.TemporaryDirectory() as d:
        reset_counters(counters)
        with trace(d):
            batch["generator"].manual_seed(TRAIN_BATCH * 1000)
            step_fn(restored, batch)
        summary = trace_summary(d, steps=1, top=8)
    if any(fn.launches for fn in counters.values()) or any(
            r["name"] == "flash" for r in summary["by_category"]):
        fail("phase 30.4: the traced training step launched a hand-written kernel")
    print_summary("phase 30.4: one training step (remat=False) under trace", summary)
    out["step_trace"] = summary
    del restored, unet
    free_card()
    return out


# -- phases 9 and 10 ----------------------------------------------------------------

def fixed_cfg():
    """One SD-2.1 configuration with a fixed prompt and seed."""
    from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

    spec = PATHS["sd21"]
    return PipelineConfiguration(
        prompt=PROMPTS[0], step_count=STEPS, guidance_scale=spec["guidance"], seed=2024,
        scheduler=spec["scheduler"], rng="numpy", disable_safety=True)


def fixed_latents(pipe):
    """Latents of one SD-2.1 generation with a fixed prompt and seed."""
    return pipe.generate_images(fixed_cfg(), image_hw=PATHS["sd21"]["image_hw"]).latents


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
        free_card()

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
            free_card()
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
    del dense, unet_d, te_d
    # phase 29.1: program mode on the staged path, the weights offloaded
    out["staged_program_mode"] = run_palettized_staged(pipe, latents["program"])
    del pipe
    free_card()
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
    free_card()
    return dict(max_abs=max_abs, psnr_db=psnr, predicted_psnr_db=list(PAL_PREDICTED_PSNR_DB),
                peak=peak, launches=launches, modules_with_bias=with_bias,
                unet_call_ms_fused=fused_ms, unet_call_ms_install=install_ms)


#: what the kernels line keeps of a kernel's phase-2 rows: the shape, its
#: launches, and what this run measured, with the bound.  The launch plans,
#: the executed-ops bound and the exp floor are models, not measurements:
#: they stay in phase 2's log and in --compare.
LINE_ROW_KEYS = ("label", "q_lens", "sk", "B", "H", "D", "shape", "groups", "apply_silu",
                 "M", "K", "N", "nbits", "dtype", "launches_per_generation", "calls_per_unet",
                 "max_abs_err", "rel_rms_err", "dropped_tile_max_abs", "dropped_tile_rel_rms",
                 "dropped_channel_max_abs", "dropped_channel_rel_rms", "dropped_k_tile_max_abs",
                 "dropped_k_tile_rel_rms", "ms", "plain_ms", "library", "library_ms",
                 "device_ms", "library_device_ms", "gather_matmul_ms",
                 "gather_matmul_device_ms", "bound_ms", "bound_by")


# -- phase 33: tensor and spatial parallelism -----------------------------------------

#: sharded forwards against the unsharded one on the same card, in bf16
PARALLEL_MIN_PSNR_DB = 40.0
#: 33.2's sharded SD-2.1 generation: a depth cut for time (gloo stages every
#: collective through the host)
PARALLEL_STEPS = 4
#: the flash shapes that only the sharded forwards launch (their other
#: shapes are phase 2's): SD-2.1 at tp=2 with the heads split (levels 2 and
#: 3: 10 -> 5 and 20 -> 10; level 1's 5 heads take the generic form), and
#: the spatial forwards' local query rows over all keys (SD-2.1's 16x16
#: level leaves 128 query rows a rank, below the 256-row dispatch threshold)
PARALLEL_FLASH_SHAPES = [
    ("sd21 tp2 32x32", (1024,), 1024, 2, 5, 64, torch.bfloat16, {}),
    ("sd21 tp2 16x16", (256,), 256, 2, 10, 64, torch.bfloat16, {}),
    ("sd21 rows/2 64x64", (2048,), 4096, 2, 5, 64, torch.bfloat16, {}),
    ("sd21 rows/2 32x32", (512,), 1024, 2, 10, 64, torch.bfloat16, {}),
    ("sdxl rows/2 64x64", (2048,), 4096, 2, 10, 64, torch.bfloat16, {}),
    ("sdxl rows/2 32x32", (512,), 1024, 2, 20, 64, torch.bfloat16, {}),
]
#: launches of one UNet call in each mode: (flash, group_norm_silu).  The
#: spatial SD-2.1 call's 16x16 level has 128 local query rows: plain path
PARALLEL_LAUNCHES = {("sd21", "unsharded"): (15, 0), ("sd21", "tensor"): (15, 0),
                     ("sd21", "spatial"): (10, 0), ("sdxl", "unsharded"): (70, 34),
                     ("sdxl", "tensor"): (70, 34), ("sdxl", "spatial"): (70, 34)}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_nccl():
    """A one-rank NCCL process group in this process (33.1 and 34.1)."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_nccl_one_rank(pipe, counters, sd21_results) -> dict:
    """33.1, inside ``one_rank_nccl``: phase 3's pipeline on a one-rank NCCL
    mesh, its generation one captured program whose collectives are NCCL
    calls: one replay of the unsharded program, then ``shard`` and phase 3's
    warm-up and first timed generation again, their latents against phase
    3's."""
    from ml_stable_diffusion_torch.parallel import make_mesh

    before = run_main_path(pipe, "sd21", counters, timed=1, plain=False, warmup=False)
    pipe.shard(make_mesh(1))
    runs, captures = [], len(pipe.programs.captures)
    res = run_main_path(pipe, "sd21", counters, timed=1, plain=False, results=runs)
    captured = len(pipe.programs.captures) - captures
    if captured != 2:
        fail(f"33.1: the sharded pipeline captured {captured} programs, want 2 (the "
             f"generation's and the decode's)")
    diffs = [float(abs(r.latents - ref.latents).max()) for r, ref in zip(runs, sd21_results)]
    rel = max(diffs) / max(float(abs(sd21_results[0].latents).max()), 1e-12)
    if not rel <= GEN_MAX_REL_ERR:
        fail(f"33.1: the one-rank sharded latents differ from phase 3's by {rel} (rel) > "
             f"{GEN_MAX_REL_ERR}")
    out = dict(ms_per_step=1e3 * res["seconds_per_step"],
               unsharded_ms_per_step=1e3 * before["seconds_per_step"],
               launches=res["launches"], max_abs_vs_phase3=diffs, rel_vs_phase3=rel,
               bit_equal=all(d == 0.0 for d in diffs), backend="nccl")
    log(f"33.1 one-rank NCCL mesh, captured: {out['ms_per_step']:.2f} ms/step against "
        f"{out['unsharded_ms_per_step']:.2f} unsharded in turn (phase 3: "
        f"{1e3 * statistics.median(r.seconds_per_step for r in sd21_results[1:]):.2f}); "
        f"launches {res['launches']} (warm-up + timed); latents against phase 3's: max abs "
        f"{diffs} ({'bit-equal' if out['bit_equal'] else 'not bit-equal: a row-parallel '
        'Linear adds its bias after the float32 reduce, to the bf16-rounded product, where '
        'nn.Linear adds it inside the GEMM'}), rel {rel:.3g} (max {GEN_MAX_REL_ERR})")
    return out


def _recording(modules, name, shapes):
    """Wrap the dispatch function ``name`` where each of ``modules`` calls it
    to append its first input's shape to ``shapes``; -> a function that puts
    them back.  The kernel wrappers below stay as they are, their
    ``.launches`` counting."""
    originals = [getattr(m, name) for m in modules]

    def wrap(fn):
        def recorded(*args, **kw):
            shapes.append(tuple(args[0].shape))
            return fn(*args, **kw)
        return recorded

    for m, fn in zip(modules, originals):
        setattr(m, name, wrap(fn))
    return lambda: [setattr(m, name, fn) for m, fn in zip(modules, originals)]


def _sharded_forwards(label, unet, inputs, mesh, counters):
    """One UNet call unsharded, spatially sharded and tensor sharded (the
    UNet sharded in place last); each sharded output against the unsharded
    one (PSNR), and each call's flash and GroupNorm launches and shapes."""
    from ml_stable_diffusion_torch.models import unet as unet_module
    from ml_stable_diffusion_torch.ops import flash_attention as flash_module
    from ml_stable_diffusion_torch.parallel import (
        layers,
        make_spatial_sharded_forward,
        make_tensor_sharded_forward,
    )

    sample, t, ctx, *rest = inputs
    kw = {"added_cond": rest[0]} if rest else {}
    out, ref = {}, None
    for mode in ("unsharded", "spatial", "tensor"):
        if mode == "spatial":
            fn = make_spatial_sharded_forward(unet, mesh)
        elif mode == "tensor":
            _, fn = make_tensor_sharded_forward(unet, mesh)
        else:
            fn = unet
        # the dispatch functions, as ops/attention.py and the resnets (and the
        # spatial GroupNorm) call them
        flash_shapes, gn_shapes_seen = [], []
        undo_flash = _recording([flash_module], "flash_attention", flash_shapes)
        undo_gn = _recording([unet_module, layers], "group_norm_silu", gn_shapes_seen)
        before = {k: f.launches for k, f in counters.items()}
        try:
            with torch.inference_mode():
                t0 = time.perf_counter()
                y = fn(sample, t, ctx, **kw)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        finally:
            undo_flash()
            undo_gn()
        launched = {k: f.launches - before[k] for k, f in counters.items()}
        row = dict(seconds=seconds, flash_launches=launched["flash_attention"],
                   group_norm_silu_launches=launched["group_norm_silu"],
                   flash_shapes=sorted(set(flash_shapes)),
                   group_norm_shapes=sorted(set(gn_shapes_seen)))
        if mode == "unsharded":
            ref = y
        else:
            row["max_abs"], row["psnr_db"], row["peak"] = psnr_db(y.float(), ref.float())
        out[mode] = row
    return out


def parallel_rank_main(rank: int, world: int, tmp: Path):
    """One of 33.2-34.2's two ranks on the one card, over gloo: the full-width
    SD-2.1 UNet's forwards at (2, 4, 64, 64), a sharded SD-2.1 generation of
    PARALLEL_STEPS steps (eager: a gloo mesh cannot be captured) against the
    unsharded one, the SDXL-base UNet's forwards at 1024x1024 (fused
    GroupNorm), then the training step at tp=2 (``tp_training_rank``).
    Writes ``rank{rank}.json`` into ``tmp``."""
    import torch.distributed as dist

    from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
    from ml_stable_diffusion_torch.ops.flash_attention import flash_attention_cuda
    from ml_stable_diffusion_torch.ops.groupnorm import group_norm_silu_cuda
    from ml_stable_diffusion_torch.parallel import make_mesh
    from ml_stable_diffusion_torch.utils.numerics import apply_numerics

    torch.cuda.set_device(0)
    apply_numerics()
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=rank,
                            world_size=world)
    counters = {"flash_attention": flash_attention_cuda, "group_norm_silu": group_norm_silu_cuda}
    try:
        mesh = make_mesh(world)
        out = {"backend": str(dist.get_backend()), "rank": rank}
        # 33.2: the SD-2.1 UNet with variance-preserving weights, as phase 4
        gen = torch.Generator(device="cuda").manual_seed(1)
        with torch.device("meta"):
            unet = UNet2DConditionModel(UNetConfig.sd21())
        unet = materialize(unet, gen, torch.bfloat16, std=None)
        inputs = (torch.randn(2, 4, 64, 64, generator=gen, device="cuda"),
                  torch.tensor(500.0, device="cuda"),
                  torch.randn(2, 77, 1024, generator=gen, device="cuda"))
        out["sd21"] = _sharded_forwards("sd21", unet, inputs, mesh, counters)
        del unet
        free_card()
        # 33.2: phase 3's pipeline sharded at tp=2, PARALLEL_STEPS steps
        with tempfile.TemporaryDirectory() as tokdir:
            pipe = build_sd21_pipeline(Path(tokdir))
        cfg = main_cfg("sd21", 0, step_count=PARALLEL_STEPS)
        with torch.inference_mode():
            for _ in range(2):  # a capture, then the replay compared and timed
                ref = pipe.generate_images(cfg, image_hw=(512, 512))
        pipe.shard(mesh)
        try:
            pipe.generate_images(cfg, image_hw=(512, 512))
            fail("33.2: a captured generation on a gloo mesh ran; it must raise")
        except RuntimeError as e:
            if "execution = 'eager'" not in str(e):
                raise
            out["captured_refusal"] = str(e)
        pipe.execution = "eager"
        before = flash_attention_cuda.launches
        t0 = time.perf_counter()
        res = pipe.generate_images(cfg, image_hw=(512, 512))
        diff = float(abs(res.latents - ref.latents).max())
        out["generation"] = dict(
            steps=PARALLEL_STEPS, seconds=time.perf_counter() - t0,
            seconds_per_step=res.seconds_per_step, unsharded_seconds_per_step=ref.seconds_per_step,
            flash_launches=flash_attention_cuda.launches - before, max_abs=diff,
            rel=diff / max(float(abs(ref.latents).max()), 1e-12),
            finite=bool(torch.isfinite(torch.from_numpy(res.latents)).all()))
        del pipe, ref, res
        free_card()
        # 33.3: the SDXL base UNet at 1024x1024 on the fused GroupNorm, as phase 8
        unet, inputs = sdxl_unet_and_inputs(torch.Generator(device="cuda").manual_seed(8))
        out["sdxl"] = _sharded_forwards("sdxl", unet, inputs, mesh, counters)
        del unet, inputs
        free_card()
        # 34.2: the training step at tp=2
        before = {k: f.launches for k, f in counters.items()}
        out["training"] = tp_training_rank(mesh, tmp)
        out["training"]["launches"] = {k: f.launches - before[k] for k, f in counters.items()}
        (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def run_parallel_ranks(counters) -> dict:
    """33.2, 33.3 and 34.2: two ranks on the one card over gloo (NCCL takes
    one rank a device), each in a process of its own; their forwards,
    launches and shapes and their training steps checked here.  Then the
    kernel at the sharded shapes that no earlier phase timed, against its
    plain version, with its bound."""
    from ml_stable_diffusion_torch.ops.flash_attention import (
        flash_attention_cuda,
        flash_attention_reference,
    )

    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        outs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, __file__, "--parallel-rank", str(r),
                                   str(world), str(tmp)], stdout=fh, stderr=subprocess.STDOUT)
                 for r, fh in enumerate(outs)]
        try:
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p, fh in zip(procs, outs):
                p.kill()
                p.wait()
                fh.close()
        for r, p in enumerate(procs):
            text = (tmp / f"rank{r}.log").read_text()
            for line in text.splitlines()[-40:]:
                log(f"  [rank {r}] {line}")
            if p.returncode != 0:
                fail(f"33.2/33.3: rank {r} exited {p.returncode}")
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]
    known = {(B, q[0], sk, H, D) for _, q, sk, B, H, D, dt, _ in FLASH_SHAPES
             if dt == torch.bfloat16}
    new = {(B, q[0], sk, H, D) for _, q, sk, B, H, D, _, _ in PARALLEL_FLASH_SHAPES}
    for r, out in enumerate(ranks):
        for model in ("sd21", "sdxl"):
            for mode, row in out[model].items():
                want = PARALLEL_LAUNCHES[(model, mode)]
                got = (row["flash_launches"], row["group_norm_silu_launches"])
                if got != want:
                    fail(f"33: rank {r} {model} {mode}: launched (flash, GroupNorm) {got}, "
                         f"want {want}")
                if mode != "unsharded" and not row["psnr_db"] >= PARALLEL_MIN_PSNR_DB:
                    fail(f"33: rank {r} {model} {mode} against unsharded: PSNR "
                         f"{row['psnr_db']} dB < {PARALLEL_MIN_PSNR_DB}")
                for B, S, H, D in map(tuple, row["flash_shapes"]):
                    if not any((B, S, H, D) == (b, q, h, d) for b, q, _, h, d in known | new):
                        fail(f"33: rank {r} {model} {mode} launched the kernel at q "
                             f"{(B, S, H, D)}, a shape no phase times")
                log(f"33 rank {r} {model} {mode}: {row['flash_launches']} flash, "
                    f"{row['group_norm_silu_launches']} GroupNorm launches, q shapes "
                    f"{row['flash_shapes']}, GroupNorm shapes {row['group_norm_shapes']}, "
                    f"{row['seconds']:.3f} s (gloo, eager)"
                    + ("" if mode == "unsharded" else
                       f"; against unsharded: max abs {row['max_abs']:.4g}, PSNR "
                       f"{row['psnr_db']:.2f} dB (min {PARALLEL_MIN_PSNR_DB})"))
        g = out["generation"]
        if not (g["finite"] and g["rel"] <= GEN_MAX_REL_ERR):
            fail(f"33.2: rank {r}'s sharded generation against unsharded: rel {g['rel']} "
                 f"(max {GEN_MAX_REL_ERR}), finite {g['finite']}")
        log(f"33.2 rank {r} SD-2.1 tp=2 generation, {g['steps']} steps (a depth cut for "
            f"time), eager over gloo: {1e3 * g['seconds_per_step']:.1f} ms/step against "
            f"{1e3 * g['unsharded_seconds_per_step']:.1f} unsharded (a replay); "
            f"{g['flash_launches']} flash launches; latents max abs {g['max_abs']:.4g}, rel "
            f"{g['rel']:.3g} (max {GEN_MAX_REL_ERR}); captured run refused: "
            f"{out['captured_refusal']!r}")
        if ranks[0]["generation"]["max_abs"] != g["max_abs"]:
            fail("33.2: the ranks' sharded generations differ")
        check_tp_training_rank(r, out["training"], ranks[0]["training"])
    rows = check_kernel(lambda qs, k, v: [flash_attention_cuda(qs[0], k, v)],
                        lambda qs, k, v: [flash_attention_reference(qs[0], k, v)],
                        PARALLEL_FLASH_SHAPES)
    return {"ranks": ranks, "flash_rows": rows}


# -- phase 34: the training step over a (dp, tp) mesh ---------------------------------

#: 34.2's SGD step: at lr 1 the update p_after - p_before is minus the
#: gradient, to within the rounding of p (at phase 30's lr 1e-5 it would be
#: at the scale of p's last bit)
TP_SGD_LR = 1.0
#: 34.1's losses against phase 30's, 34.2's against the unsharded step's
TP_LOSS_MAX_REL = 1e-5
#: 34.2's update against the unsharded one, relative RMS (a gradient scaled
#: by tp reads tp - 1)
TP_UPDATE_MAX_REL_RMS = 1e-4


def sharded_tensor_count(model) -> int:
    from ml_stable_diffusion_torch.parallel.layers import shard_layout

    return len(shard_layout(model))


def run_tp_training_one_rank(counters, phase30) -> dict:
    """34.1, inside ``one_rank_nccl``: phase 30's UNet, batch, AdamW and fixed
    draws through ``make_train_step(mesh=make_mesh(1))`` (every rule's layer
    installed, its collectives NCCL calls over one rank), after a warm-up
    step of each on a state of its own, three steps in turn with the
    unsharded step: the losses against phase 30's, ms/step of each, and no
    hand-written kernel launched."""
    from ml_stable_diffusion_torch.parallel import adamw, make_mesh, make_train_step

    unet, batch = training_unet_and_batch()
    steps = {"unsharded": make_train_step(unet, adamw(TRAIN_LR), device="cuda"),
             "mesh": make_train_step(unet, adamw(TRAIN_LR), make_mesh(1), device="cuda")}
    reset_counters(counters)
    for init_fn, step_fn in steps.values():  # a warm-up step each on a state of its own
        train_steps(step_fn, init_fn(), batch, steps=1)
        free_card()
    states = {k: init_fn() for k, (init_fn, _) in steps.items()}
    sharded = sharded_tensor_count(states["mesh"].model)
    losses, ms = {k: [] for k in steps}, {k: [] for k in steps}
    for _ in range(TRAIN_STEPS):
        for k, (_, step_fn) in steps.items():
            states[k], loss, t = train_steps(step_fn, states[k], batch, steps=1)
            losses[k] += loss
            ms[k] += t
    launched = {name: fn.launches for name, fn in counters.items()}
    if any(launched.values()):
        fail(f"34.1: the mesh's training steps launched {launched}")
    want = phase30["no_remat"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"], want))
    if not (all(math.isfinite(x) for x in losses["mesh"]) and rel <= TP_LOSS_MAX_REL):
        fail(f"34.1: the mesh's losses {losses['mesh']} against phase 30's {want}: rel {rel} "
             f"> {TP_LOSS_MAX_REL}")
    out = dict(losses=losses, ms_per_step=ms, rel_vs_phase30=rel, sharded_tensors=sharded,
               median_ms={k: statistics.median(v) for k, v in ms.items()}, launches=launched)
    log(f"34.1 one-rank NCCL mesh, training (SD-2.1 UNet f32, AdamW, batch {TRAIN_BATCH}): "
        f"{sharded} sharded tensors installed; losses {losses['mesh']} against phase "
        f"30's {want}: max rel {rel:.3g} (max {TP_LOSS_MAX_REL}); in turn with the unsharded "
        f"step ({losses['unsharded']}): {out['median_ms']['mesh']:.2f} against "
        f"{out['median_ms']['unsharded']:.2f} ms/step (medians of {TRAIN_STEPS}, events: "
        f"{[round(x, 2) for x in ms['mesh']]} / {[round(x, 2) for x in ms['unsharded']]}); "
        f"launches {launched}")
    del states, steps, unet
    free_card()
    return out


def rel_rms_of(got: dict, want: dict) -> float:
    """The relative RMS of ``got`` against ``want`` over all their tensors."""
    num = sum(float(((got[k].double() - w.double()) ** 2).sum()) for k, w in want.items())
    den = sum(float((w.double() ** 2).sum()) for w in want.values())
    return math.sqrt(num / den)


def tp_training_rank(mesh, tmp: Path) -> dict:
    """34.2 on one of the two gloo ranks (dp = 1, tp = 2): phase 30's UNet and
    batch.  One SGD step (``TP_SGD_LR``) against the unsharded one that rank
    0 runs first: the loss and the update gathered whole; one AdamW step
    from a new state: the tp-replicated parameters bit-equal on both ranks;
    its checkpoint saved at tp = 2, restored unsharded on each rank and cut
    to its shards, held to the live state.  s/step and peak memory of each
    step."""
    import torch.distributed as dist

    from ml_stable_diffusion_torch.parallel import (
        adamw,
        make_train_step,
        restore_train_state,
        save_train_state,
        sgd,
    )
    from ml_stable_diffusion_torch.parallel.layers import (
        all_gather,
        axis_group,
        full_tensors,
        shard_layout,
        take_shards,
    )

    tp = axis_group(mesh, "tp")
    unet, batch = training_unet_and_batch()
    before = unet.state_dict()
    out = {}
    if tp.rank == 0:
        init_fn, step_fn = make_train_step(unet, sgd(TP_SGD_LR), device="cuda")
        state, loss, t = train_steps(step_fn, init_fn(), batch, steps=1)
        want = {k: p.detach() - before[k] for k, p in state.params.items()}
        out["unsharded"] = dict(loss=loss[0], ms=t[0])
        del state, init_fn, step_fn
        free_card()
    dist.barrier(group=tp.group)  # the ranks' steps start together

    def measured(step_fn, state):
        free_card()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, loss, _ = train_steps(step_fn, state, batch, steps=1)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        return state, dict(loss=loss[0], seconds=seconds, peak_gib=peak / 2**30,
                           peak_over_start_gib=(peak - start) / 2**30)

    init_fn, step_fn = make_train_step(unet, sgd(TP_SGD_LR), mesh, device="cuda")
    state = init_fn()
    out["sharded_tensors"] = sharded_tensor_count(state.model)
    state, out["sgd"] = measured(step_fn, state)
    mine = take_shards(state.model, before)
    got = full_tensors(state.model, {k: p.detach() - mine[k] for k, p in state.params.items()})
    if tp.rank == 0:
        out["sgd"]["loss_rel"] = abs(out["sgd"]["loss"] - out["unsharded"]["loss"]) / abs(
            out["unsharded"]["loss"])
        out["sgd"]["update_rel_rms"] = rel_rms_of(got, want)
        del want
    del state, got, mine, init_fn, step_fn

    init_fn, step_fn = make_train_step(unet, adamw(TRAIN_LR), mesh, device="cuda")
    state, out["adamw"] = measured(step_fn, init_fn())
    sharded = shard_layout(state.model)
    replicated = torch.cat([p.detach().flatten() for k, p in state.params.items()
                            if k not in sharded])
    both = all_gather(replicated[None], 0, tp)
    out["adamw"]["replicated_elements"] = replicated.numel()
    out["adamw"]["replicated_equal"] = all(torch.equal(x, both[0]) for x in both)
    del both, replicated

    ckpt = tmp / "tp_checkpoint"
    t0 = time.perf_counter()
    save_train_state(ckpt, state)
    out["checkpoint"] = dict(save_s=time.perf_counter() - t0)
    init_u, _ = make_train_step(unet, adamw(TRAIN_LR), device="cuda")
    t0 = time.perf_counter()
    back = restore_train_state(ckpt, init_u())
    out["checkpoint"]["restore_s"] = time.perf_counter() - t0
    # each rank holds the restored whole state, cut to its shards, to its
    # live one: together, the restored state equals the gathered one
    def tensors(st, kind):
        return {k: p.detach() if kind == "params" else st.optimizer.state[p][kind]
                for k, p in st.params.items()}

    equal = back.step == state.step
    for kind in ("params", "exp_avg", "exp_avg_sq"):
        restored = take_shards(state.model, tensors(back, kind))
        equal = equal and all(torch.equal(restored[k], x)
                              for k, x in tensors(state, kind).items())
    out["checkpoint"]["equal"] = equal
    dist.barrier(group=tp.group)
    if tp.rank == 0:
        out["checkpoint"]["bytes"] = sum(f.stat().st_size for f in ckpt.iterdir())
        shutil.rmtree(ckpt)
    del back, state
    free_card()
    return out


def check_tp_training_rank(r: int, tr: dict, rank0: dict):
    """34.2's checks and lines for rank ``r`` (``rank0``: rank 0's results)."""
    if any(tr["launches"].values()):
        fail(f"34.2: rank {r}'s training steps launched {tr['launches']}")
    if not tr["adamw"]["replicated_equal"]:
        fail(f"34.2: the tp-replicated parameters differ between the ranks after AdamW")
    if tr["sgd"]["loss"] != rank0["sgd"]["loss"]:
        fail(f"34.2: rank {r}'s loss {tr['sgd']['loss']} differs from rank 0's")
    if not tr["checkpoint"]["equal"]:
        fail(f"34.2: the tp=2 checkpoint restored unsharded differs from rank {r}'s live state")
    if r == 0:
        sgd = tr["sgd"]
        if not (sgd["loss_rel"] <= TP_LOSS_MAX_REL
                and sgd["update_rel_rms"] <= TP_UPDATE_MAX_REL_RMS):
            fail(f"34.2: the tp=2 SGD step against the unsharded one: loss rel "
                 f"{sgd['loss_rel']} (max {TP_LOSS_MAX_REL}), update rel RMS "
                 f"{sgd['update_rel_rms']} (max {TP_UPDATE_MAX_REL_RMS})")
        log(f"34.2 tp=2 training, SD-2.1 UNet f32 batch {TRAIN_BATCH}: "
            f"{tr['sharded_tensors']} sharded tensors; SGD (lr {TP_SGD_LR}) loss "
            f"{sgd['loss']!r} against the unsharded "
            f"{tr['unsharded']['loss']!r} (rel {sgd['loss_rel']:.3g}, max {TP_LOSS_MAX_REL}), "
            f"update rel RMS {sgd['update_rel_rms']:.3g} (max {TP_UPDATE_MAX_REL_RMS}); "
            f"checkpoint saved at tp=2 ({tr['checkpoint']['bytes'] / 2**30:.3f} GiB, "
            f"{tr['checkpoint']['save_s']:.2f} s) restored unsharded in "
            f"{tr['checkpoint']['restore_s']:.2f} s: parameters, AdamW moments and step "
            f"bit-equal to the live state on both ranks")
    for name in ("sgd", "adamw"):
        st = tr[name]
        log(f"34.2 rank {r} {name} step at tp=2: {st['seconds']:.3f} s/step, peak "
            f"{st['peak_gib']:.3f} GiB ({st['peak_over_start_gib']:.3f} over its start); two "
            f"ranks share one card over gloo (host-staged, eager): this measures nothing "
            f"about scaling")
    log(f"34.2 rank {r}: after one AdamW step the {tr['adamw']['replicated_elements']} "
        f"tp-replicated parameter elements are bit-equal on both ranks; launches "
        f"{tr['launches']}")


def line_rows(rows):
    """``rows`` with only the keys the kernels line keeps."""
    return [{k: r[k] for k in LINE_ROW_KEYS if k in r} for r in rows]


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
                shapes=line_rows(rows))


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
    entry["library_ms"] = total(g["library_ms"] for g in per_gen.values())
    entry["device_ms"] = total(g["device_ms"] for g in per_gen.values())
    entry["library_device_ms"] = total(g["library_device_ms"] for g in per_gen.values())
    entry["launches_by_path"] = {p: main_launches[p][name] for p in paths}
    entry["per_generation"] = per_gen
    entry["shapes"] = line_rows(rows)
    return entry


#: kernel name fragments -> group; the first match wins (cuDNN's implicit-GEMM
#: convolutions carry "gemm" in their names too)
_KERNEL_GROUPS = (("groupnorm kernel", ("gn_silu",)),
                  ("geglu kernel", ("geglu",)),
                  ("flash kernel", ("flash_wgmma", "flash_fma", "flash_split", "flash_combine")),
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
    steps), all of the captured program; then one eager generation's wall
    time and device busy share beside it."""
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
    log(f"profiled one {path} generation, its captured program (profiler on: host work "
        f"is slower than in phases 3/5): wall {wall:.3f} s, {res.seconds_per_step * 1e3:.2f} ms/step, "
        f"device busy {busy / 1e6:.3f} s ({100 * busy / 1e6 / wall:.1f} % of wall), "
        f"of it the VAE decode {dec_busy / 1e6:.3f} s")
    step_total = sum(per_step.values())
    for g, ms in sorted(per_step.items(), key=lambda kv: -kv[1]):
        log(f"  {g:12s} {ms:8.2f} ms per step ({100 * ms / step_total:.1f} %); "
            f"decode {dec_groups.get(g, 0.0) / 1e3:8.2f} ms")
    for name, (n, us) in sorted(names.items(), key=lambda kv: -kv[1][1])[:25]:
        log(f"  {us / 1e3:10.2f} ms  {n:6d} x  {name[:110]}")
    pipe.execution = "eager"
    generate(2)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_eager:
        t0 = time.perf_counter()
        res = generate(1)
        torch.cuda.synchronize()
        eager_wall = time.perf_counter() - t0
    eager_busy = _device_time(prof_eager)[0] / 1e6
    summary["eager"] = dict(wall_s=eager_wall, seconds_per_step=res.seconds_per_step,
                            device_busy_s=eager_busy, device_busy_share=eager_busy / eager_wall)
    log(f"the same generation on the eager loop: wall {eager_wall:.3f} s, "
        f"{res.seconds_per_step * 1e3:.2f} ms/step, device busy {eager_busy:.3f} s "
        f"({100 * eager_busy / eager_wall:.1f} % of wall; captured "
        f"{100 * summary['device_busy_share']:.1f} %)")
    log(json.dumps({"profile": summary}))


#: what --compare keeps of each phase-2 row
COMPARE_KEYS = ("label", "q_lens", "sk", "B", "H", "D", "dtype", "tile", "plan", "device_ms",
                "library_device_ms", "bound_ms", "bound_by", "exp_floor_ms",
                "executed_ops_bound_ms", "launches_per_generation", "max_abs_err",
                "rel_rms_err")
#: phase 2 of the tree in the working directory, in a process of its own;
#: its rows as the last line
_PHASE2_CHILD = f"""
import json, sys
sys.path.insert(0, ".")
import chip_smoke
from ml_stable_diffusion_torch.utils import cuda_build
from ml_stable_diffusion_torch.utils.numerics import apply_numerics
apply_numerics()
cuda_build.build_all()
rows, _ = chip_smoke.check_kernels()
print("PHASE2 " + json.dumps({{name: [{{k: r.get(k) for k in {COMPARE_KEYS!r}}} for r in rs]
                               for name, rs in rows.items()}}))
"""


def _child(tree: Path, argv, marker: str):
    """Run ``argv`` in ``tree``, echo its output, and return its last line
    that starts with ``marker``."""
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=tree, capture_output=True, text=True, timeout=1500)
    for line in proc.stdout.splitlines():
        log(f"  [{tree.name}] {line}")
    if proc.returncode != 0:
        fail(f"{' '.join(argv[:2])} in {tree} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    found = [line for line in proc.stdout.splitlines() if line.startswith(marker)]
    if not found:
        fail(f"{' '.join(argv[:2])} in {tree} printed no {marker!r} line")
    log(f"{tree}: {' '.join(argv[1:3])} took {time.perf_counter() - t0:.1f} s")
    return found[-1]


def compare_trees(parent: Path):
    """Phase 2 of the parent's tree and of this one in turns (parent,
    change, change, parent), each in a process of its own on the same card,
    then ``--profile sd15`` of each: every row's device ms per launch side by
    side, and each path's flash ms per generation (rows times their launches
    on it)."""
    here = Path(__file__).resolve().parent
    runs = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        tree = parent if who == "parent" else here
        line = _child(tree, [sys.executable, "-c", _PHASE2_CHILD], "PHASE2 ")
        runs[who].append(json.loads(line[len("PHASE2 "):]))
    profiles = {who: json.loads(_child(tree, [sys.executable, "chip_smoke.py", "--profile",
                                              "sd15"], '{"profile": '))["profile"]
                for who, tree in (("parent", parent), ("change", here))}

    def mean(values):
        values = [v for v in values if v is not None]
        return statistics.mean(values) if values else None

    table, per_gen = {}, {}
    for name, rows in runs["change"][0].items():
        if any(name not in run for run in runs["parent"]):
            log(f"{name}: new in the change, the parent has no rows to compare")
            continue
        out = []
        for i, row in enumerate(rows):
            both = {who: [run[name][i] for run in runs[who]] for who in runs}
            if any(r["label"] != row["label"] for rs in both.values() for r in rs):
                fail(f"{name}: the parent's and the change's phase-2 rows differ")
            entry = {k: row.get(k) for k in ("label", "q_lens", "sk", "B", "H", "D", "dtype",
                                             "bound_ms", "bound_by", "exp_floor_ms",
                                             "executed_ops_bound_ms", "tile", "plan",
                                             "launches_per_generation")}
            entry.update(parent_device_ms=[r["device_ms"] for r in both["parent"]],
                         change_device_ms=[r["device_ms"] for r in both["change"]],
                         library_device_ms=mean(r["library_device_ms"]
                                                for rs in both.values() for r in rs),
                         parent_tile=both["parent"][0]["tile"],
                         parent_executed_ops_bound_ms=both["parent"][0].get(
                             "executed_ops_bound_ms"))
            for who in ("parent", "change"):
                entry[f"{who}_ms"] = mean(entry[f"{who}_device_ms"])
            out.append(entry)
            if entry["parent_ms"] is None or entry["change_ms"] is None:
                rel = "not measured"
            else:
                rel = f"{entry['change_ms'] / entry['parent_ms']:.3f}x the parent"
            lib = entry["library_device_ms"]
            log(f"{name:24s} {row['label']:17s} parent "
                f"{' / '.join(fmt_ms(v) for v in entry['parent_device_ms'])}  change "
                f"{' / '.join(fmt_ms(v) for v in entry['change_device_ms'])} ms ({rel})  "
                f"library {fmt_ms(lib)}  bound {entry['bound_ms']:.4f}  exp floor "
                f"{fmt_ms(entry['exp_floor_ms'])}  [{row.get('tile') or row.get('plan')}]")
        table[name] = out
        if name != "flash_attention":
            continue
        for path in sorted({p for r in out for p in r["launches_per_generation"]}):
            counted = [(r, r["launches_per_generation"].get(path, 0)) for r in out]
            per_gen[path] = {
                key: total(None if r[key] is None else r[key] * n for r, n in counted if n)
                for key in ("parent_ms", "change_ms", "library_device_ms", "bound_ms",
                            "exp_floor_ms")}
            g = per_gen[path]
            log(f"flash per generation, {path:18s}: parent {fmt_ms(g['parent_ms'])}  change "
                f"{fmt_ms(g['change_ms'])}  library {fmt_ms(g['library_device_ms'])}  bound "
                f"{g['bound_ms']:.4f}  exp floor {g['exp_floor_ms']:.4f} ms")
    for who, prof in profiles.items():
        ms = prof["device_ms_by_group"].get("flash kernel")
        log(f"--profile sd15, {who}: flash kernel {fmt_ms(ms)} ms of device time in one "
            f"generation; device busy {prof['device_busy_s']:.4f} s of {prof['wall_s']:.4f} s")
    log(json.dumps({"compare": {"rows": table, "flash_per_generation": per_gen,
                                "profiles": profiles}}))


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
    if len(sys.argv) == 3 and sys.argv[1] == "--compare" and Path(sys.argv[2]).is_dir():
        if not torch.cuda.is_available():
            print("chip_smoke.py: no CUDA device; nothing was run", file=sys.stderr)
            return 1
        card = card_line()
        log(f"card: {card}")
        compare_trees(Path(sys.argv[2]).resolve())
        log(card)
        return 0
    if len(sys.argv) == 5 and sys.argv[1] == "--parallel-rank":
        if not torch.cuda.is_available():
            print("chip_smoke.py: no CUDA device; nothing was run", file=sys.stderr)
            return 1
        parallel_rank_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
        return 0
    if len(sys.argv) > 1:
        print(f"usage: {sys.argv[0]} [--profile {'|'.join(PROFILE_BUILDERS)} | "
              f"--compare PARENT_CHECKOUT]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from ml_stable_diffusion_torch.ops.flash_attention import (
        flash_attention_cuda,
        flash_attention_multi_q_cuda,
        flash_attention_wide_f32_cuda,
        flash_split_tf32_cuda,
    )
    from ml_stable_diffusion_torch.ops.activations import geglu_cuda
    from ml_stable_diffusion_torch.ops.groupnorm import group_norm_silu_cuda
    from ml_stable_diffusion_torch.ops.palettized import palettized_dense_fused_cuda
    from ml_stable_diffusion_torch.utils import cuda_build, native
    from ml_stable_diffusion_torch.utils.numerics import apply_numerics, numerics_settings

    counters = {"flash_attention": flash_attention_cuda,
                "flash_attention_multi_q": flash_attention_multi_q_cuda,
                "flash_attention_wide_f32": flash_attention_wide_f32_cuda,
                "flash_split_tf32": flash_split_tf32_cuda,
                "group_norm_silu": group_norm_silu_cuda,
                "palettized_dense_fused": palettized_dense_fused_cuda,
                "geglu": geglu_cuda}
    t_start = time.perf_counter()
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
    # the native host libraries, timed here rather than inside the first
    # phase that reads a safetensors file (phase 20's load)
    if native.build_native(force=True) is None:
        fail("the native libraries did not build (make -C native)")
    log(f"native libraries built in {native.build_seconds:.2f} s into {native.BUILD_DIR}")

    rows, pal_calls = check_kernels()
    log(f"phases 1 and 2: {time.perf_counter() - t_start:.1f} s")

    main_paths, model_checks = {}, {}

    def report(path, res):
        warm = res.get("capture_warmup_launches")
        captured = ("" if warm is None else
                    f" (of them the captures' warm-ups {warm}"
                    + ("; a first call: its s/step includes its capture" if res["first_call"]
                       else "") + f"); {res['memory_reserved_gib']:.2f} GiB reserved")
        plain = ("" if "seconds_per_step_plain" not in res else
                 f"; plain attention {res['seconds_per_step_plain'] * 1e3:.2f} ms/step; flash "
                 f"vs plain latents rel err {res['flash_vs_plain_latents_rel_err']:.3g}")
        log(f"main path {path}: {PATHS[path]['label']}: "
            f"{res['seconds_per_step'] * 1e3:.2f} ms/step, {res['iter_per_s']:.2f} iter/s, "
            f"{res['seconds_per_image']:.3f} s/image ({card}){plain}; "
            f"launches {res['launches']}{captured}; at {time.perf_counter() - t_start:.1f} s")

    check_unet_calls()
    schedulers = inpainting = None
    #: phases 18 to 20's checks; phases 21 and 22's; phases 3, 5 and 7's generations
    sd3_checks, adapters, results = {}, {}, {"sd21": [], "sd3": [], "sdxl": []}
    #: phase 23 by path; phases 24 and 25
    graphs, reduce_memory, serving = {}, None, None
    #: phases 26 and 27 by path, 28, 29, 30, 31, 32; seconds of phases 26 to 32
    w8a8, fuse_qkv, staged, training, phase_s = {}, {}, {}, {}, {}
    command_line, native_libs = {}, {}
    #: phase 33
    parallel = {}

    def sd21_more(pipe):
        """Phases 23, 30, 26, 25, 12, 13, 20, 28, 31 and 32 on phase 3's
        pipeline."""
        nonlocal schedulers, inpainting, serving
        graphs["sd21"] = run_graphs_vs_eager(pipe, "sd21", counters)
        t1 = time.perf_counter()
        training.update(run_generation_trace(pipe, counters))
        training.update(run_training(counters))
        phase_s["30"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        w8a8["sd21"], w8 = run_w8a8_sd21(pipe, counters, results["sd21"])
        phase_s["26"] = time.perf_counter() - t1
        serving = run_serving(pipe)
        serving["w8a8_deepcache_preset"] = run_serving_preset(w8)
        del w8
        free_card()
        paths, inpainting = run_img2img_paths(pipe, counters, report)
        main_paths.update(paths)
        schedulers = run_scheduler_sweep(pipe, counters)
        (main_paths["sd21_diffusers"], sd3_checks["diffusers_loader"], tmp,
         diffusers_first) = run_diffusers_path(pipe, counters, report, results["sd21"])
        try:
            t1 = time.perf_counter()
            fuse_qkv.update(run_fuse_qkv(pipe, Path(tmp.name) / "sd21", counters,
                                         results["sd21"]))
            phase_s["28"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            command_line.update(run_command_line(
                Path(tmp.name), counters, main_paths["sd21_diffusers"], diffusers_first,
                main_paths["sd21"]))
            phase_s["31"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            native_libs.update(run_native_libraries(pipe, Path(tmp.name), results["sd21"][0]))
            phase_s["32"] = time.perf_counter() - t1
        finally:
            tmp.cleanup()
        # phase 33.1, last on this pipeline: shard leaves it split; then 34.1
        # on the same one-rank group
        with one_rank_nccl():
            t1 = time.perf_counter()
            parallel["nccl_one_rank"] = run_nccl_one_rank(pipe, counters, results["sd21"])
            phase_s["33.1"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            training["tp_one_rank"] = run_tp_training_one_rank(counters, training)
            phase_s["34.1"] = time.perf_counter() - t1

    def sd3_more(pipe):
        """Phase 23, phase 14's SD3 img2img, then phases 18 and 19, on phase
        5's pipeline."""
        graphs["sd3"] = run_graphs_vs_eager(pipe, "sd3", counters)
        main_paths["sd3_img2img"] = run_main_path(
            with_encoder(pipe, 14), "sd3_img2img", counters, timed=1, plain=False,
            warmup=False, extra=dict(starting_image=starting_image((1024, 1024), 14),
                                     strength=STRENGTH))
        report("sd3_img2img", main_paths["sd3_img2img"])
        free_card()
        main_paths["sd3_t5"], sd3_checks["t5"] = run_t5_path(pipe, counters, report,
                                                             results["sd3"])
        paths, sd3_checks["controlnet"] = run_sd3_controlnet_paths(pipe, counters, report,
                                                                   results["sd3"])
        main_paths.update(paths)
        free_card()
        # phase 22's SD3 LoRA
        main_paths["sd3_lora"], adapters["sd3"] = run_sd3_lora_path(pipe, counters, report,
                                                                    results["sd3"])
        free_card()
        t1 = time.perf_counter()
        w8a8["sd3"], w8 = run_w8a8_family(pipe, "sd3", counters)
        w8a8["sd3"].pop("latents")
        del w8
        free_card()
        phase_s["27 (sd3)"] = time.perf_counter() - t1

    for path, build, check, more in (
            ("sd21", build_sd21_pipeline, check_unet_flash_vs_plain, sd21_more),
            ("sd3", build_sd3_pipeline, check_mmdit_flash_vs_plain, sd3_more)):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tokdir:
            pipe = build(Path(tokdir))
        main_paths[path] = run_main_path(pipe, path, counters, results=results[path])
        report(path, main_paths[path])
        more(pipe)
        del pipe
        free_card()
        counter = counters["flash_attention" if path == "sd21" else "flash_attention_multi_q"]
        model_checks[path] = check(counter)
        free_card()
        log(f"phases of {path}: {time.perf_counter() - t0:.1f} s")

    # phase 7: SDXL base, then base + refiner over the same modules
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tokdir:
        pipe = build_sdxl_pipeline(Path(tokdir))
    main_paths["sdxl"] = run_main_path(pipe, "sdxl", counters, results=results["sdxl"])
    report("sdxl", main_paths["sdxl"])
    # phase 27: W8A8 on the base, in turns with it; then 29.2, staged
    t1 = time.perf_counter()
    w8a8["sdxl"], sdxl_w8 = run_w8a8_family(pipe, "sdxl", counters)
    del sdxl_w8
    free_card()
    phase_s["27 (sdxl)"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    staged["sdxl_w8a8"] = run_w8a8_staged(pipe, w8a8["sdxl"].pop("latents"), counters)
    free_card()
    phase_s["29.2"] = time.perf_counter() - t1
    # phase 14's SDXL-base img2img, before the refiner joins
    main_paths["sdxl_img2img"] = run_main_path(
        with_encoder(pipe, 17), "sdxl_img2img", counters, timed=1, plain=False, warmup=False,
        extra=dict(starting_image=starting_image((1024, 1024), 17), strength=STRENGTH))
    report("sdxl_img2img", main_paths["sdxl_img2img"])
    free_card()
    # phase 17: one SDXL ControlNet beside the base, before the refiner joins
    main_paths["sdxl_controlnet"] = run_sdxl_controlnet_path(pipe, counters, report)
    free_card()
    # phase 22: the adapters on the base, before the refiner joins
    paths, adapters["sdxl"] = run_sdxl_adapter_paths(pipe, counters, report, results["sdxl"])
    main_paths.update(paths)
    free_card()
    pipe = sdxl_with_refiner(pipe)
    main_paths["sdxl_refiner"] = run_main_path(pipe, "sdxl_refiner", counters, timed=1,
                                               plain=False)
    report("sdxl_refiner", main_paths["sdxl_refiner"])
    graphs["sdxl_refiner"] = run_graphs_vs_eager(pipe, "sdxl_refiner", counters)
    reduce_memory = run_reduce_memory(pipe, counters)
    del pipe
    free_card()
    # phase 8
    model_checks["sdxl"] = check_sdxl_unet(counters)
    free_card()
    log(f"phases of sdxl: {time.perf_counter() - t0:.1f} s")

    # phase 11: SD-1.5 with the default configuration, then its UNet check
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tokdir:
        pipe = build_sd15_pipeline(Path(tokdir))
    sd15_results = []
    main_paths["sd15"] = run_main_path(pipe, "sd15", counters, results=sd15_results)
    report("sd15", main_paths["sd15"])
    graphs["sd15"] = run_graphs_vs_eager(pipe, "sd15", counters)
    # phases 15 and 16: ControlNet and the other features on its modules
    paths, controlnet = run_controlnet_paths(pipe, counters, report, sd15_results)
    main_paths.update(paths)
    free_card()
    paths, features = run_feature_paths(pipe, counters, report, sd15_results)
    main_paths.update(paths)
    free_card()
    # phase 21: the adapters on its modules
    paths, adapters["sd15"] = run_sd15_adapter_paths(pipe, counters, report, sd15_results)
    main_paths.update(paths)
    del pipe
    free_card()
    model_checks["sd15"] = check_sd15_flash_vs_plain(counters["flash_attention"])
    free_card()
    log(f"phases of sd15 (11, 15, 16, 21): {time.perf_counter() - t0:.1f} s")

    # phases 9 and 10: the palettized path and the fused op's witness
    t0 = time.perf_counter()
    palettized = run_palettized_path(counters)
    for mode in ("install", "program"):
        main_paths[f"sd21_pal_{mode}"] = palettized.pop(mode)
        report(f"sd21_pal_{mode}", main_paths[f"sd21_pal_{mode}"])
    staged["palettized_program_mode"] = palettized.pop("staged_program_mode")
    model_checks["palettized"] = check_palettized_witness(counters, pal_calls)
    log(f"phases of the palettized path (9, 29.1, 10): {time.perf_counter() - t0:.1f} s")
    free_card()
    t1 = time.perf_counter()
    parallel.update(run_parallel_ranks(counters))
    phase_s["33.2-34.2"] = time.perf_counter() - t1

    launches = {p: r["launches"] for p, r in main_paths.items()}
    kernels = [
        kernel_entry("flash_attention", "ml_stable_diffusion_torch/csrc/flash_attention.cu",
                     "ml_stable_diffusion_tpu/ops/flash_attention.py:151",
                     rows["flash_attention"], launches),
        kernel_entry("flash_attention_multi_q",
                     "ml_stable_diffusion_torch/csrc/flash_attention.cu",
                     "ml_stable_diffusion_tpu/ops/flash_attention.py:281",
                     rows["flash_attention_multi_q"], launches),
        kernel_entry("flash_attention_wide_f32",
                     "ml_stable_diffusion_torch/csrc/flash_attention.cu",
                     "ml_stable_diffusion_tpu/ops/flash_attention.py:166",
                     rows["flash_attention_wide_f32"], launches),
        kernel_entry("flash_split_tf32", "ml_stable_diffusion_torch/csrc/flash_attention.cu",
                     "ml_stable_diffusion_tpu/ops/flash_attention.py:166",
                     rows["flash_split_tf32"], launches),
        kernel_entry("group_norm_silu", "ml_stable_diffusion_torch/csrc/groupnorm_silu.cu",
                     "ml_stable_diffusion_tpu/ops/groupnorm.py:64",
                     rows["group_norm_silu"], launches),
        pal_kernel_entry(rows["palettized_dense_fused"], model_checks["palettized"], launches),
        dict(name="geglu", route="cuda", source="ml_stable_diffusion_torch/csrc/geglu.cu",
             replaces="the eager gelu_erf chain (XLA's fusion in ml_stable_diffusion_tpu)",
             launches=sum(n["geglu"] for n in launches.values()),
             launches_by_path={p: n["geglu"] for p, n in launches.items() if n["geglu"]},
             max_abs_err=0.0, shapes=rows["geglu"]),
    ]
    log(json.dumps({"main_paths": main_paths, "in_model_checks": model_checks,
                    "palettized_path": palettized, "schedulers": schedulers,
                    "inpainting": inpainting, "controlnet": controlnet, "features": features,
                    "sd3_t5_controlnet_loader": sd3_checks, "adapters": adapters,
                    "graphs_vs_eager": graphs, "reduce_memory": reduce_memory,
                    "serving": serving, "w8a8": w8a8, "fuse_qkv": fuse_qkv, "staged": staged,
                    "training": training, "command_line": command_line,
                    "native_libraries": native_libs, "parallel": parallel,
                    "numerics": numerics_settings(),
                    "hgmma_instructions": hgmma}))
    log(f"seconds of phases 26 to 34: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}"
        f"; the whole run {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
