"""W8A8 post-training activation quantization (port of
ml_stable_diffusion_tpu/compress/w8a8.py).

- calibration: ``capture_activation_scales`` records the input absmax
  (float32) of every module of the given types, by forward pre-hooks where
  the JAX package uses a flax method interceptor;
- simulation: ``w8a8_interceptor``, a context manager whose forward hooks
  fake-quantize selected Linear layers (symmetric per-tensor int8
  activations, per-channel int8 weights), for PSNR measurement
  (``benchmark_w8a8``, ``build_w8a8_recipe``);
- serving: ``quantize_tree_dense_int8`` quantizes the weights of a module's
  Linear (and, with ``include_convs``, Conv2d) layers, and
  ``w8a8_serving_swap`` replaces those layers by ``ops/int8.py``'s
  ``Int8Linear`` / ``Int8Conv2d``, the counterpart of the JAX
  ``w8a8_serving_interceptor``.

**Names.**  The JAX package keys scales, int8 weights and recipes by flax
module path (``down_blocks_0_attentions_0/transformer_blocks_0/attn1/to_q``,
``blocks_3/to_q`` on the MMDiT); the port keys them by its own module names
(``down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q``,
``transformer_blocks.3.attn.to_q``).  ``port_keys`` and ``jax_keys``
translate a dict either way with ``convert/from_jax.py``'s maps (the
UNet's, or the MMDiT's for an ``MMDiT``), so a dict written by either
package is read by the other.  The default skip pattern ``to_out.0`` (and
the ``upsamplers.0`` that ``enable_w8a8`` adds) means on the port's names
what ``to_out_0`` (``upsamplers_0``) means on the JAX paths, and
``build_w8a8_recipe`` decides a layer's class on its JAX path, so both
packages quantize and skip the same layers.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from ..convert.report import compute_psnr
from ..ops.int8 import Int8Conv2d, Int8Linear, quantize_weight_int8

logger = logging.getLogger(__name__)

#: modules whose inputs are never quantized (the JAX ``("to_out_0",)``: the
#: attention output projection, after the heads' concat)
DEFAULT_SKIP_PATTERNS = ("to_out.0",)


class ConstantScales(dict):
    """Uniform activation absmax for every module: quick-start serving
    without a calibration pass."""

    def __init__(self, value: float = 8.0):
        super().__init__()
        self.value = float(value)

    def __contains__(self, k):
        return True

    def __getitem__(self, k):
        return self.value


def _names(module: nn.Module):
    """(module name -> JAX path, JAX path -> module name) for ``module``'s
    family: the MMDiT's map for an ``MMDiT``, else the UNet's."""
    from ..convert.from_jax import (
        mmdit_flax_path,
        mmdit_module_name,
        unet_flax_path,
        unet_module_name,
    )
    from ..models.mmdit import MMDiT

    if isinstance(module, MMDiT):
        return mmdit_flax_path, mmdit_module_name
    return unet_flax_path, unet_module_name


def jax_path(module: nn.Module, name: str) -> str:
    """The JAX package's key of ``module``'s submodule ``name``."""
    return _names(module)[0](name)


def jax_keys(d: dict, module: nn.Module) -> dict:
    """A dict keyed by ``module``'s submodule names -> keyed by JAX paths."""
    to_jax = _names(module)[0]
    return {to_jax(k): v for k, v in d.items()}


def port_keys(d, module: nn.Module):
    """A dict keyed by JAX paths or by the port's names -> keyed by the
    port's names (a key that is one of ``module``'s submodules stays);
    ``ConstantScales`` passes through."""
    if isinstance(d, ConstantScales):
        return d
    own = dict(module.named_modules())
    to_port = _names(module)[1]
    return {k if k in own else to_port(k): v for k, v in d.items()}


def capture_activation_scales(module: nn.Module, apply_fn: Callable, calibration_inputs,
                              module_types=(nn.Linear,)) -> dict[str, float]:
    """Run ``apply_fn(inputs)`` for each calibration batch, recording the
    input absmax (float32) of each submodule of ``module`` of
    ``module_types`` -> {module name: absmax over the batches}."""
    scales: dict[str, float] = {}

    def hook_for(key):
        def hook(mod, args):
            if args and isinstance(args[0], torch.Tensor):
                amax = float(args[0].float().abs().max())
                scales[key] = max(scales.get(key, 0.0), amax)
        return hook

    handles = [m.register_forward_pre_hook(hook_for(k)) for k, m in module.named_modules()
               if isinstance(m, module_types)]
    try:
        with torch.no_grad():
            for inputs in calibration_inputs:
                apply_fn(inputs)
    finally:
        for h in handles:
            h.remove()
    return scales


def fake_quantize_int8(x: torch.Tensor, amax: float) -> torch.Tensor:
    """Symmetric per-tensor int8 fake quantization, in x's dtype."""
    scale = max(amax, 1e-8) / 127.0
    s = torch.full((), scale, dtype=x.dtype, device=x.device)
    return torch.clamp(torch.round(x / s), -127, 127) * s


def fake_quantize_weight_int8(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric int8 (dim 0 = output features, the
    port's layouts), in w's dtype."""
    wq, scale = quantize_weight_int8(w)
    return wq.to(w.dtype) * scale.to(w.dtype)


def _selected(key, act_scales, quantize_paths, skip_patterns) -> bool:
    return ((quantize_paths is None or key in quantize_paths)
            and not any(p in key for p in skip_patterns) and key in act_scales)


@contextlib.contextmanager
def w8a8_interceptor(module: nn.Module, act_scales: dict[str, float],
                     quantize_paths: set[str] | None = None,
                     skip_patterns: Sequence[str] = DEFAULT_SKIP_PATTERNS):
    """Within the block, the selected ``nn.Linear`` submodules of ``module``
    compute ``fake_quant(x) @ fake_quant(W)ᵀ + b`` in x's dtype (the JAX
    simulation interceptor)."""

    def hook_for(key):
        def hook(mod, args, out):
            x = fake_quantize_int8(args[0], act_scales[key])
            y = x @ fake_quantize_weight_int8(mod.weight).to(x.dtype).t()
            return y if mod.bias is None else y + mod.bias.to(x.dtype)
        return hook

    handles = [m.register_forward_hook(hook_for(k)) for k, m in module.named_modules()
               if isinstance(m, nn.Linear)
               and _selected(k, act_scales, quantize_paths, skip_patterns)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def quantizable_dense_paths(act_scales: dict[str, float],
                            skip_patterns=DEFAULT_SKIP_PATTERNS) -> list[str]:
    return [k for k in sorted(act_scales) if not any(p in k for p in skip_patterns)]


def benchmark_w8a8(module: nn.Module, run_fn: Callable, act_scales: dict[str, float],
                   paths: list[str] | None = None, cumulative: bool = True) -> dict[str, float]:
    """PSNR of quantizing ``module``'s layers singly or cumulatively.
    ``run_fn(interceptor or None) -> latents`` runs the model inside the
    given context manager (None: the float reference)."""
    if paths is None:
        paths = quantizable_dense_paths(act_scales)
    ref = np.asarray(run_fn(None))
    results = {}
    active: set[str] = set()
    for key in paths:
        probe = set(active) | {key} if cumulative else {key}
        out = np.asarray(run_fn(w8a8_interceptor(module, act_scales, probe)))
        psnr = compute_psnr(out, ref)
        results[key] = round(psnr, 2)
        if cumulative:
            active.add(key)
        logger.info("w8a8 %s: %.1f dB", key, psnr)
    return results


def build_w8a8_recipe(single_psnr: dict[str, float], act_scales: dict[str, float],
                      conv_psnr: float = 40.0, attn_psnr: float = 30.0,
                      module: nn.Module | None = None) -> dict:
    """A layer stays quantized while its single-layer PSNR holds its class
    threshold (attention projections ``attn_psnr``, the rest ``conv_psnr``);
    the rest go on the skip list.  The class is read off the layer's JAX path
    (``"attn"`` in it), translated with ``module``'s map when it is given, so
    that both packages skip the same layers (an MMDiT's ``blocks_3/to_q``
    has no ``attn``, where the port's ``transformer_blocks.3.attn.to_q``
    has).  Keys stay as given."""
    skip = []
    for key, psnr in single_psnr.items():
        path = key if module is None else jax_path(module, key)
        thr = attn_psnr if "attn" in path else conv_psnr
        if psnr < thr:
            skip.append(key)
    return {"act_scales": dict(act_scales), "skip": sorted(skip),
            "thresholds": {"conv_psnr": conv_psnr, "attn_psnr": attn_psnr}}


def quantize_dense_weights_int8(weight_fn: Callable, paths: list[str]) -> dict:
    """``weight_fn(path) -> float weight`` -> {path: (w_q int8, w_scale)}."""
    return {path: quantize_weight_int8(weight_fn(path)) for path in paths}


def _conv_geometry(m: nn.Conv2d):
    """An ``nn.Conv2d``'s stride and symmetric padding."""
    if (isinstance(m.padding, str) or m.padding_mode != "zeros" or tuple(m.dilation) != (1, 1)
            or m.groups != 1):
        raise ValueError(f"int8 convolution: unsupported padding {m.padding!r} "
                         f"({m.padding_mode}), dilation {m.dilation} or groups {m.groups}")
    return tuple(m.stride), tuple(m.padding)


def quantize_tree_dense_int8(module: nn.Module, min_size: int = 1 << 14,
                             skip_patterns: Sequence[str] = (),
                             include_convs: bool = False) -> dict:
    """Every ``nn.Linear`` of ``module`` (and with ``include_convs`` every
    ``nn.Conv2d``) whose weight has at least ``min_size`` elements and whose
    name holds no skip pattern, quantized -> {module name: (w_q, w_scale)}."""
    types = (nn.Linear, nn.Conv2d) if include_convs else (nn.Linear,)
    out = {}
    for key, m in module.named_modules():
        if not isinstance(m, types) or m.weight.numel() < min_size:
            continue
        if any(s in key for s in skip_patterns):
            continue
        with torch.no_grad():
            out[key] = quantize_weight_int8(m.weight.detach())
    return out


def w8a8_serving_swap(module: nn.Module, act_scales: dict[str, float], int8_weights: dict,
                      skip_patterns: Sequence[str] = DEFAULT_SKIP_PATTERNS) -> list[str]:
    """Replace each submodule of ``module`` that has int8 weights and a
    scale, and no skip pattern in its name, by the ``Int8Linear`` or
    ``Int8Conv2d`` serving them (in place: hand it a module tree of your
    own).  A weight whose shape is not the layer's raises ``ValueError``.
    -> the names replaced."""
    done = []
    for key, m in list(module.named_modules()):
        if not (key in int8_weights and key in act_scales
                and not any(p in key for p in skip_patterns)):
            continue
        wq, wscale = int8_weights[key]
        if not isinstance(m, (nn.Linear, nn.Conv2d)) or tuple(wq.shape) != tuple(m.weight.shape):
            raise ValueError(f"{key}: int8 weight {tuple(wq.shape)} does not serve "
                             f"{type(m).__name__} {tuple(getattr(m, 'weight', wq).shape)}")
        if isinstance(m, nn.Linear):
            new = Int8Linear(wq, wscale, m.bias, act_scales[key])
        else:
            new = Int8Conv2d(wq, wscale, m.bias, act_scales[key], *_conv_geometry(m))
        parent, _, leaf = key.rpartition(".")
        setattr(module.get_submodule(parent) if parent else module, leaf, new)
        done.append(key)
    return done
