"""Mixed-bit palettization (MBP): per-layer sensitivity sweeps and recipes
(port of ml_stable_diffusion_tpu/compress/mixed_bit.py).

The same machinery over the port's state dicts ``{key: tensor}``: a layer is
its state-dict key (``down_blocks.0.attentions.0.proj_in.weight``) where the
JAX package uses the '/'-joined Flax path, and recipes are JSON keyed by it.

- single-layer sweep: palettize each layer alone at each bit width and
  measure the end-to-end PSNR against the uncompressed model;
- cumulative sweep in a given order;
- ``build_recipe``: per layer the smallest bit width whose PSNR clears a
  threshold (16 keeps it uncompressed);
- ``apply_recipe`` fake-quantizes each layer at its width,
  ``apply_recipe_palettized`` keeps ``PalettizedTensor`` entries.

Layers are fitted as ``compress/palettize.py`` fits them, in the JAX layout's
order, so a recipe applied here gives the JAX package's LUTs.  The model
runner is injected (``run_fn(state_dict) -> output``), and ``params`` may be
an ``nn.Module`` (its state dict, with its palettizable weights as the
default layers) or a state dict with explicit ``paths``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Callable, Sequence

import torch
from torch import nn

from ..convert.report import compute_psnr
from .palettize import NBITS, PALETTIZE_MIN_SIZE, eligible_weights, palettize_weight

logger = logging.getLogger(__name__)


def palettizable_paths(module: nn.Module, min_size: int = PALETTIZE_MIN_SIZE) -> list[str]:
    """The ``nn.Linear``/``nn.Conv2d`` weights of at least ``min_size``
    elements (compress/palettize.py's eligibility rule)."""
    return eligible_weights(module, min_size)


def _state_and_paths(params, paths):
    if isinstance(params, nn.Module):
        return dict(params.state_dict()), paths if paths is not None else palettizable_paths(params)
    if paths is None:
        raise ValueError("a state dict needs explicit paths (palettizable_paths(module))")
    return params, paths


def _fake_palettize(params: dict, key: str, nbits: int) -> dict:
    w = params[key]
    out = dict(params)
    out[key] = palettize_weight(w, nbits).dequantize().to(w.dtype)
    return out


def benchmark_signal_integrity(run_fn: Callable, params, nbits_list: Sequence[int] = NBITS,
                               paths=None, cumulative: bool = False,
                               out_json: str | Path | None = None) -> dict:
    """-> {"single_layer": {key: {nbits: psnr}}, "cumulative": {}} or
    {"single_layer": {}, "cumulative": {nbits: {key: psnr}}}; checkpointed
    to ``out_json`` after each layer (or bit width)."""
    params, paths = _state_and_paths(params, paths)
    ref_out = run_fn(params)
    results: dict = {"single_layer": {}, "cumulative": {}}

    def flush():
        if out_json is not None:
            Path(out_json).write_text(json.dumps(results, indent=1))

    if not cumulative:
        for key in paths:
            results["single_layer"][key] = {}
            for nbits in nbits_list:
                psnr = compute_psnr(run_fn(_fake_palettize(params, key, nbits)), ref_out)
                results["single_layer"][key][str(nbits)] = round(psnr, 2)
                logger.info("single %s @%db: %.1f dB", key, nbits, psnr)
            flush()
    else:
        for nbits in nbits_list:
            results["cumulative"][str(nbits)] = {}
            mutated = params
            for key in paths:
                mutated = _fake_palettize(mutated, key, nbits)
                psnr = compute_psnr(run_fn(mutated), ref_out)
                results["cumulative"][str(nbits)][key] = round(psnr, 2)
                logger.info("cumulative %s @%db: %.1f dB", key, nbits, psnr)
            flush()
    flush()  # always leave a (possibly empty) checkpoint on disk
    return results


def _linear_quantize_int8(w: torch.Tensor) -> torch.Tensor:
    """Uniform symmetric per-tensor int8 fake quantization."""
    scale = max(float(w.abs().max()), 1e-8) / 127.0
    return (torch.clamp(torch.round(w / scale), -127, 127) * scale).to(w.dtype)


def benchmark_baselines(run_fn: Callable, params, paths=None) -> dict:
    """The PSNR anchors beside the sweeps: every float tensor rounded to
    bf16 ("serving_bf16") and a uniform linear 8-bit quantization of the
    palettizable layers ("linear_8bit")."""
    params, paths = _state_and_paths(params, paths)
    ref = run_fn(params)
    bf16 = {k: v.to(torch.bfloat16).float() if v.is_floating_point() else v
            for k, v in params.items()}
    out = {"serving_bf16": round(compute_psnr(run_fn(bf16), ref), 2)}
    q = dict(params)
    for key in paths:
        q[key] = _linear_quantize_int8(q[key])
    out["linear_8bit"] = round(compute_psnr(run_fn(q), ref), 2)
    return out


def recipe_estimated_psnr(recipe: dict, single_layer: dict) -> float:
    """The worst single-layer PSNR among the chosen bit widths."""
    worst = float("inf")
    for key, nbits in recipe.items():
        if nbits >= 16:
            continue
        worst = min(worst, single_layer[key][str(nbits)])
    return worst if worst != float("inf") else 999.0


def mbp_report_rows(single_layer: dict, recipes: dict, params: dict,
                    baselines: dict | None = None) -> dict:
    """(size, PSNR) rows of each recipe, JSON-ready."""
    total = sum(params[k].numel() for k in single_layer)
    rows = []
    for name, recipe in sorted(recipes.items()):
        bits = recipe_average_bits(recipe, params)
        rows.append({
            "recipe": name,
            "avg_bits": round(bits, 3),
            "size_mb": round(total * bits / 8 / 2**20, 2),
            "estimated_psnr_db": round(recipe_estimated_psnr(recipe, single_layer), 2),
        })
    return {"rows": rows, "baselines": dict(baselines or {}),
            "analyzed_layers": len(single_layer), "total_weights": total}


def mbp_report(single_layer: dict, recipes: dict, params: dict,
               baselines: dict | None = None) -> str:
    """The rows of ``mbp_report_rows`` as a markdown table."""
    data = mbp_report_rows(single_layer, recipes, params, baselines)
    lines = ["# Mixed-bit palettization report", ""]
    if baselines:
        lines += ["Baselines: " + ", ".join(f"{k} = {v} dB" for k, v in baselines.items()), ""]
    lines += ["| recipe | avg bits | est. payload (MB) | worst single-layer PSNR (dB) |",
              "|---|---|---|---|"]
    for row in data["rows"]:
        lines.append(f"| {row['recipe']} | {row['avg_bits']:.2f} | {row['size_mb']:.1f} | "
                     f"{row['estimated_psnr_db']:.1f} |")
    lines.append("")
    lines.append(f"(analyzed layers: {data['analyzed_layers']}, "
                 f"{data['total_weights'] / 1e6:.1f}M weights; payload at "
                 "fp16-equivalent storage for unpalettized layers)")
    return "\n".join(lines)


def descending_psnr_order(single_layer: dict, nbits: int = 1) -> list[str]:
    """Layer keys in ascending impact order (highest PSNR at ``nbits`` first)."""
    return sorted(single_layer, key=lambda k: -single_layer[k][str(nbits)])


def build_recipe(single_layer: dict, psnr_threshold: float, default_nbits: int = 16) -> dict:
    """Per layer: the smallest nbits whose single-layer PSNR clears the
    threshold; ``default_nbits`` (16 = uncompressed) when none does."""
    recipe = {}
    for key, by_bits in single_layer.items():
        chosen = default_nbits
        for nbits in sorted(int(b) for b in by_bits):
            if by_bits[str(nbits)] >= psnr_threshold:
                chosen = nbits
                break
        recipe[key] = chosen
    return recipe


def recipe_average_bits(recipe: dict, params: dict) -> float:
    total = weighted = 0
    for key, nbits in recipe.items():
        n = params[key].numel()
        total += n
        weighted += n * min(nbits, 16)
    return weighted / max(total, 1)


def apply_recipe(params: dict, recipe: dict) -> dict:
    """Fake-quantize every layer at its recipe bit width; 16 leaves it."""
    out = params
    for key, nbits in recipe.items():
        if nbits < 16:
            out = _fake_palettize(out, key, nbits)
    return out


def apply_recipe_palettized(params: dict, recipe: dict) -> dict:
    """Like ``apply_recipe`` but keeps ``PalettizedTensor`` entries, so an
    artifact stores packed indices and LUTs."""
    out = dict(params)
    for key, nbits in recipe.items():
        if nbits < 16:
            out[key] = palettize_weight(out[key], nbits)
    return out
