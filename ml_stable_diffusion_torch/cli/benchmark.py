"""Benchmark command: warm-up, then the median latency of N generations, and
a ``benchmark.json`` (port of ml_stable_diffusion_tpu/cli/benchmark.py).

    python -m ml_stable_diffusion_torch.cli.benchmark -i CHECKPOINT_DIR

The JAX command's flags, report keys and gates: one warm-up generation (on
the card it captures the generation's program), then ``--repeats``
generations, each with its own seed (``--seed + r``), and ``SystemExit``
when the median latency passes ``--max-latency`` or, with
``--clip-score``, when the first image's CLIP score (``utils/clip_score.py``)
is below ``--min-clip-score``.  ``--device`` (default ``cuda``) is the
port's own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import statistics
import time
from pathlib import Path

logger = logging.getLogger(__name__)


def parser_spec():
    p = argparse.ArgumentParser("sdtorch-benchmark")
    p.add_argument("-i", "--checkpoint-path", required=True)
    p.add_argument("--prompt", default="a photo of an astronaut riding a horse on mars")
    p.add_argument("--step-count", type=int, default=20)
    p.add_argument("--size", default="512x512")
    p.add_argument("--scheduler", default="DPMSolverMultistep")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--seed", type=int, default=93)
    p.add_argument("--max-latency", type=float, default=90.0,
                   help="fail if the median end-to-end latency exceeds this (s)")
    p.add_argument("--clip-score", action="store_true",
                   help="opt-in image-quality gate: CLIP cosine(image, prompt) on the "
                        "generated image")
    p.add_argument("--clip-checkpoint", default=None,
                   help="dir with tokenizer/ text_encoder/ safety_checker/ providing the "
                        "CLIP towers (default: the main checkpoint)")
    p.add_argument("--min-clip-score", type=float, default=0.3,
                   help="fail below this score")
    p.add_argument("-o", "--output-json", default="benchmark.json")
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:1, cpu")
    return p


def run(args) -> dict:
    from ..convert.load import load_pipeline
    from ..pipelines.config import PipelineConfiguration

    h, w = (int(x) for x in args.size.split("x"))
    pipe = load_pipeline(args.checkpoint_path, device=args.device)
    cfg = PipelineConfiguration(prompt=args.prompt, step_count=args.step_count,
                                seed=args.seed, scheduler=args.scheduler, disable_safety=True)

    pipe.generate_images(cfg, image_hw=(h, w))  # warm-up (captures the program)

    e2e, per_step = [], []
    res = None
    for r in range(args.repeats):
        # a distinct seed per repeat: an identical request could be served
        # from a cache and give a false latency
        rcfg = dataclasses.replace(cfg, seed=args.seed + r)
        t0 = time.perf_counter()
        res = pipe.generate_images(rcfg, image_hw=(h, w))
        e2e.append(time.perf_counter() - t0)
        per_step.append(res.seconds_per_step)

    report = {
        "checkpoint": str(args.checkpoint_path),
        "size": args.size,
        "scheduler": args.scheduler,
        "step_count": args.step_count,
        "repeats": args.repeats,
        "e2e_latency_median_s": round(statistics.median(e2e), 4),
        "seconds_per_step_median": round(statistics.median(per_step), 5),
        "diffusion_iters_per_s": round(1.0 / statistics.median(per_step), 3),
    }
    if args.clip_score:
        from ..convert.load import load_safety_checker, load_text_encoder
        from ..tokenizer import CLIPTokenizer
        from ..utils.clip_score import clip_score

        cdir = Path(args.clip_checkpoint or args.checkpoint_path)
        tok = CLIPTokenizer.from_pretrained_dir(cdir / "tokenizer")
        te = load_text_encoder(cdir / "text_encoder", device=args.device)
        vm = load_safety_checker(cdir / "safety_checker", device=args.device)
        report["clip_score"] = round(clip_score(te, vm, tok, args.prompt, res.images[0]), 4)
        report["min_clip_score"] = args.min_clip_score
    Path(args.output_json).write_text(json.dumps(report, indent=1))
    logger.info("%s", json.dumps(report))
    if report["e2e_latency_median_s"] > args.max_latency:
        raise SystemExit(f"median latency {report['e2e_latency_median_s']:.1f}s exceeds the "
                         f"{args.max_latency:.0f}s gate")
    if args.clip_score and report["clip_score"] < args.min_clip_score:
        raise SystemExit(f"CLIP score {report['clip_score']:.3f} below the "
                         f"{args.min_clip_score:.2f} quality gate")
    return report


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    run(parser_spec().parse_args(argv))


if __name__ == "__main__":
    main()
