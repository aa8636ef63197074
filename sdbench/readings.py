"""The readings that the check's limits are set from, on the card, many seeds
in one process (set-up is long; the benchmark's own runs never run this).

    python3 sdbench/readings.py --workload <name> --seeds 1,2,3 --seconds 10 \\
        --mode sound|control [--out file.jsonl]

- ``sound``: the cell as the benchmark runs it, a short window a seed: the
  lower readings.
- ``control``: the same with the program's own lower-precision path on:
  ``enable_w8a8(include_convs=True)``, the denoiser's large Linear and
  Conv2d layers as int8 products (the configuration states bfloat16),
  its activation scales calibrated with the port's
  ``capture_activation_scales`` on one generation of the cell's traffic,
  and TF32 for its float32 modules (the configuration states float32 with
  TF32 off).  The upper readings.  ``--linear-only`` leaves the
  convolutions in bfloat16, as ``enable_w8a8`` does by default.

Each seed prints one JSON line: the numbers compared, each beside its
limit, and ``correct``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sdbench import run as bench_run  # noqa: E402


def program_control(cfg: dict, mix: dict, seed: int, include_convs: bool = True,
                    min_size: int | None = None):
    """-> ``after_build``: the pipeline switched to W8A8 (calibrated;
    ``min_size``: the least layer size, for a tiny configuration) and
    TF32."""
    import torch

    from sdbench.harness.traffic import Traffic

    def lower(pipe):
        from ml_stable_diffusion_torch.compress.w8a8 import capture_activation_scales
        from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

        req = Traffic(mix, seed ^ 0x5A5A).request(0)
        calib = PipelineConfiguration(
            prompt=req.prompt, seed=req.seed, image_count=req.image_count,
            step_count=cfg["step_count"], scheduler=cfg["scheduler"],
            guidance_scale=cfg["guidance_scale"], disable_safety=True)
        execution, pipe.execution = pipe.execution, "eager"  # the hooks see every call
        scales = capture_activation_scales(
            pipe.unet, lambda c: pipe.generate_images(c, image_hw=tuple(cfg["image_hw"])),
            [calib], module_types=(torch.nn.Linear, torch.nn.Conv2d) if include_convs
            else (torch.nn.Linear,))
        pipe.execution = execution
        pipe.enable_w8a8(act_scales=scales, include_convs=include_convs,
                         **({} if min_size is None else {"min_size": min_size}))
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    return lower


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--mode", choices=("sound", "control"), default="sound")
    p.add_argument("--linear-only", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from sdbench.harness import check

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    _bench, cell, cfg, mix = bench_run.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        after = (program_control(cfg, mix, seed, include_convs=not args.linear_only)
                 if args.mode == "control" else None)
        result, lines = bench_run.run_cell(args.workload, seed, args.seconds, False,
                                           after_build=after)
        line = {"seed": seed, "correct": result["correct"], "check": result["check"],
                "metrics": result["metrics"]}
        for text in lines:
            bench_run.log(text)
        line.update(workload=args.workload, mode=args.mode, linear_only=args.linear_only)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        check.free_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
