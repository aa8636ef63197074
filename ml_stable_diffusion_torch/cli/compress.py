"""Compression command: palettization, mixed-bit palettization (MBP) and
W8A8 calibration (port of ml_stable_diffusion_tpu/cli/compress.py).

    python -m ml_stable_diffusion_torch.cli.compress palettize -i CHECKPOINT_DIR -o OUT --nbits 6

The JAX command's seven subcommands and flags, on the port's
``compress/mixed_bit.py`` and ``compress/w8a8.py``, with ``--device``
(default ``cuda``) added:

- ``palettize``, ``mbp-apply``: a ``Unet`` artifact of the port's state dict
  with palettized weights (the JAX package's LUTs bit for bit);
- ``mbp-analyze``, ``mbp-build-recipe``, ``mbp-report``: layers named by the
  port's state-dict keys (``down_blocks.0.attentions.0.proj_in.weight``),
  where the JAX command writes Flax paths;
- ``w8a8-calibrate``: activation scales written under the JAX package's
  module paths (``compress/w8a8.py:jax_keys``), so a scales file from either
  package serves either ``generate --w8a8-scales``; ``w8a8-analyze`` reads
  scales named either way and writes its recipe under JAX paths too.

The probe batch is the JAX command's eight prompts through the checkpoint's
text encoder (or, without one, contexts from ``np.random.RandomState(1)``)
and latents from ``np.random.RandomState(0)``, where the JAX command draws
with ``jax.random``; t = 500 for every row.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

#: the fixed probe prompts over subjects and styles: sensitivity is measured
#: end to end over 8 prompts (one random context mis-ranks layers whose
#: sensitivity is text-conditioned)
PROBE_PROMPTS = (
    "a photograph of an astronaut riding a horse",
    "a watercolor painting of a lighthouse at dusk",
    "macro photo of a honeybee on a sunflower, sharp focus",
    "isometric pixel art of a cozy coffee shop interior",
    "portrait of an elderly fisherman, dramatic lighting",
    "a red vintage car parked on a rainy neon street at night",
    "an intricate pencil sketch of a gothic cathedral",
    "aerial view of terraced rice fields at sunrise",
)


def parser_spec():
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda", help="torch device: cuda, cuda:1, cpu")
    p = argparse.ArgumentParser("sdtorch-compress")
    sub = p.add_subparsers(dest="cmd", required=True)

    pal = sub.add_parser("palettize", parents=[common])
    pal.add_argument("-i", "--checkpoint", required=True)
    pal.add_argument("-o", "--output-dir", required=True)
    pal.add_argument("--nbits", type=int, required=True, choices=[1, 2, 4, 6, 8])

    ana = sub.add_parser("mbp-analyze", parents=[common])
    ana.add_argument("-i", "--checkpoint", required=True)
    ana.add_argument("-o", "--output-json", required=True)
    ana.add_argument("--prompt", default="a photo of an astronaut riding a horse on mars")
    ana.add_argument("--nbits", type=int, nargs="*", default=[1, 2, 4, 6, 8])
    ana.add_argument("--cumulative", action="store_true")
    ana.add_argument("--size", default="512x512")
    ana.add_argument("--probe-prompts", type=int, default=8,
                     help="number of fixed probe prompts")

    build = sub.add_parser("mbp-build-recipe", parents=[common])
    build.add_argument("-i", "--analysis-json", required=True)
    build.add_argument("-o", "--output-json", required=True)
    build.add_argument("--psnr-threshold", type=float, default=40.0)

    rep = sub.add_parser("mbp-report", parents=[common],
                         help="size/quality tradeoff table from an analysis, as markdown")
    rep.add_argument("-i", "--analysis-json", required=True)
    rep.add_argument("--checkpoint", required=True)
    rep.add_argument("-o", "--output-md", required=True)
    rep.add_argument("--output-json", default=None,
                     help="also emit the (avg_bits, size_MB, est_psnr) series as JSON")
    rep.add_argument("--psnr-thresholds", type=float, nargs="*", default=[35.0, 40.0, 45.0])

    app = sub.add_parser("mbp-apply", parents=[common])
    app.add_argument("-i", "--checkpoint", required=True)
    app.add_argument("--recipe", required=True)
    app.add_argument("-o", "--output-dir", required=True)

    cal = sub.add_parser("w8a8-calibrate", parents=[common])
    cal.add_argument("-i", "--checkpoint", required=True)
    cal.add_argument("-o", "--output-json", required=True)
    cal.add_argument("--size", default="512x512")
    cal.add_argument("--probe-prompts", type=int, default=8)

    w8a = sub.add_parser("w8a8-analyze", parents=[common])
    w8a.add_argument("-i", "--checkpoint", required=True)
    w8a.add_argument("--scales", required=True,
                     help="calibrated {module_path: absmax} JSON from w8a8-calibrate")
    w8a.add_argument("-o", "--output-json", required=True)
    w8a.add_argument("--conv-psnr", type=float, default=40.0,
                     help="PSNR gate for non-attention layers")
    w8a.add_argument("--attn-psnr", type=float, default=30.0,
                     help="PSNR gate for attention projections")
    w8a.add_argument("--size", default="512x512")
    w8a.add_argument("--probe-prompts", type=int, default=8)
    return p


def _load_unet(args):
    import torch

    from ..convert import load

    return load.load_unet(Path(args.checkpoint) / "unet", dtype=torch.float32,
                          device=args.device)


def probe_batch(checkpoint, size: str, probe_prompts: int, cfg, device="cuda"):
    """-> (latents (P, h, w, C) NHWC, t (P,), contexts (P, 77, C_ctx)), float32
    numpy: the fixed probe prompts through the checkpoint's text encoder (or
    contexts from ``RandomState(1)``), latents from ``RandomState(0)``, t =
    500; ``cfg`` the UNet's config."""
    import torch

    from ..convert import load
    from ..tokenizer import CLIPTokenizer

    h, w = (int(x) // 8 for x in size.split("x"))
    root = Path(checkpoint)
    prompts = PROBE_PROMPTS[: max(1, probe_prompts)]
    P = len(prompts)
    te_dir, tok_dir = root / "text_encoder", root / "tokenizer"
    if te_dir.exists() and tok_dir.exists():
        te = load.load_text_encoder(te_dir, device=device)
        tok = CLIPTokenizer.from_pretrained_dir(tok_dir)
        ids = np.stack([tok.tokenize(p, max_length=77)[0] for p in prompts]).astype(np.int64)
        with torch.no_grad():
            ctx = te(torch.from_numpy(ids).to(device))["last_hidden_state"].cpu().numpy()
        if ctx.shape[-1] != cfg.cross_attention_dim:
            raise ValueError(f"text encoder width {ctx.shape[-1]} != UNet "
                             f"cross_attention_dim {cfg.cross_attention_dim}")
    else:  # no text encoder in the checkpoint: fixed contexts
        logger.warning("no text_encoder/tokenizer; probing with fixed random contexts "
                       "(weaker than a text-conditioned probe)")
        ctx = np.random.RandomState(1).standard_normal(
            (P, 77, cfg.cross_attention_dim)).astype(np.float32)
    latents = np.random.RandomState(0).standard_normal(
        (P, h, w, cfg.in_channels)).astype(np.float32)
    return latents, np.full((P,), 500.0, np.float32), ctx


def _probe_inputs(model, args):
    """The probe batch as the UNet's inputs on its device (latents NCHW)."""
    import torch

    latents, t, ctx = probe_batch(args.checkpoint, args.size, args.probe_prompts, model.config,
                                  args.device)
    dev = next(model.parameters()).device
    return (torch.from_numpy(latents.transpose(0, 3, 1, 2).copy()).to(dev),
            torch.from_numpy(t).to(dev), torch.from_numpy(ctx).to(dev))


def _one_step_runner(model, args):
    """state dict -> the UNet's output over the probe batch (MBP sweeps)."""
    import torch
    from torch.func import functional_call

    inputs = _probe_inputs(model, args)

    def run(state_dict):
        with torch.no_grad():
            return functional_call(model, state_dict, inputs).cpu()

    return run


def run(args):
    import torch

    from ..compress import benchmark_signal_integrity, build_recipe, palettize_tree
    from ..compress.mixed_bit import apply_recipe_palettized
    from ..convert import artifacts

    if args.cmd == "palettize":
        model = _load_unet(args)
        params, stats = palettize_tree(model, args.nbits)
        artifacts.save_module(Path(args.output_dir), params, config=model.config, name="Unet")
        logger.info("palettized (stored compressed): %s", stats)

    elif args.cmd == "mbp-analyze":
        from ..compress.mixed_bit import benchmark_baselines

        model = _load_unet(args)
        run_fn = _one_step_runner(model, args)
        results = benchmark_signal_integrity(run_fn, model, nbits_list=tuple(args.nbits),
                                             cumulative=args.cumulative,
                                             out_json=args.output_json)
        # the baselines beside the sweeps: serving dtype and linear 8-bit
        results["baselines"] = benchmark_baselines(run_fn, model)
        Path(args.output_json).write_text(json.dumps(results, indent=1))
        logger.info("analysis + baselines written to %s", args.output_json)

    elif args.cmd == "mbp-build-recipe":
        analysis = json.loads(Path(args.analysis_json).read_text())
        recipe = build_recipe(analysis["single_layer"], args.psnr_threshold)
        Path(args.output_json).write_text(json.dumps(recipe, indent=1))
        logger.info("recipe written to %s", args.output_json)

    elif args.cmd == "mbp-report":
        from ..compress.mixed_bit import mbp_report, mbp_report_rows

        analysis = json.loads(Path(args.analysis_json).read_text())
        params = _load_unet(args).state_dict()
        recipes = {f"recipe_{t:g}dB": build_recipe(analysis["single_layer"], t)
                   for t in args.psnr_thresholds}
        md = mbp_report(analysis["single_layer"], recipes, params,
                        baselines=analysis.get("baselines"))
        Path(args.output_md).write_text(md)
        logger.info("report written to %s", args.output_md)
        if args.output_json:
            rows = mbp_report_rows(analysis["single_layer"], recipes, params,
                                   baselines=analysis.get("baselines"))
            Path(args.output_json).write_text(json.dumps(rows, indent=1))
            logger.info("tradeoff series written to %s", args.output_json)

    elif args.cmd == "mbp-apply":
        model = _load_unet(args)
        recipe = json.loads(Path(args.recipe).read_text())
        params = apply_recipe_palettized(model.state_dict(), recipe)
        artifacts.save_module(Path(args.output_dir), params, config=model.config, name="Unet")
        logger.info("recipe applied (stored compressed) -> %s", args.output_dir)

    elif args.cmd == "w8a8-calibrate":
        from ..compress.w8a8 import capture_activation_scales, jax_keys

        model = _load_unet(args)
        inputs = _probe_inputs(model, args)
        scales = capture_activation_scales(model, lambda inp: model(*inp), [inputs])
        scales = jax_keys(scales, model)
        Path(args.output_json).write_text(json.dumps(
            {k: round(v, 6) for k, v in sorted(scales.items())}, indent=1))
        logger.info("calibrated %d module scales -> %s", len(scales), args.output_json)

    elif args.cmd == "w8a8-analyze":
        from ..compress.w8a8 import (
            benchmark_w8a8,
            build_w8a8_recipe,
            jax_keys,
            jax_path,
            port_keys,
            quantizable_dense_paths,
        )

        model = _load_unet(args)
        scales = port_keys(json.loads(Path(args.scales).read_text()), model)
        inputs = _probe_inputs(model, args)

        def run_fn(interceptor):
            with torch.no_grad():
                if interceptor is None:
                    return model(*inputs).cpu()
                with interceptor:
                    return model(*inputs).cpu()

        single = benchmark_w8a8(model, run_fn, scales, cumulative=False)
        recipe = build_w8a8_recipe(single, scales, conv_psnr=args.conv_psnr,
                                   attn_psnr=args.attn_psnr, module=model)
        # the cumulative pass over the kept layers in ascending impact (the
        # highest single-layer PSNR first; ties in the JAX paths' order)
        kept = [p for p in sorted(quantizable_dense_paths(scales),
                                  key=lambda k: jax_path(model, k))
                if p not in set(recipe["skip"])]
        kept.sort(key=lambda k: -single.get(k, 0.0))
        cumulative = (benchmark_w8a8(model, run_fn, scales, paths=kept, cumulative=True)
                      if kept else {})
        final = min(cumulative.values()) if cumulative else None
        Path(args.output_json).write_text(json.dumps({
            "act_scales": jax_keys(recipe["act_scales"], model),
            "skip": sorted(jax_path(model, k) for k in recipe["skip"]),
            "thresholds": recipe["thresholds"],
            "single_layer": jax_keys(single, model),
            "cumulative": jax_keys(cumulative, model),
            "final_cumulative_psnr": final}, indent=1))
        logger.info("w8a8 analysis: %d kept / %d skipped, cumulative PSNR %s -> %s",
                    len(kept), len(recipe["skip"]), final, args.output_json)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    run(parser_spec().parse_args(argv))


if __name__ == "__main__":
    main()
