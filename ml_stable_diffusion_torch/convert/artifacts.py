"""Artifact store: converted weights on disk (port of
ml_stable_diffusion_tpu/convert/artifacts.py, the same file format).

An artifact is ``<name>.safetensors`` plus a ``<name>.json`` manifest: the
tensors' shapes and dtypes, the model config (``dataclasses.asdict``) and
its class name.  Keys are opaque '/'-joined strings: a nested dict (a Flax
tree as the JAX package writes it) is flattened by '/', a port state dict
keeps its own keys.  ``PalettizedTensor`` entries are stored as
``<key>::idx`` (bit-packed indices, ``ops/palettized.pack_bits``) and
``<key>::lut`` (float32), listed under ``manifest["palettized"]`` with their
bit width, shape and count.  An artifact written by either package loads in
the other.
"""

from __future__ import annotations

import dataclasses
import json
import math
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from ..compress.palettize import PalettizedTensor
from ..ops.palettized import pack_bits, unpack_bits
from .native_io import load_file, save_file


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name of the dtype, as the JAX package's manifest has it."""
    return str(t.dtype).removeprefix("torch.")


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), value


def _flatten(params) -> tuple[dict[str, torch.Tensor], dict[str, dict]]:
    """-> (tensors on the host, palettized manifest entries)."""
    out, palettized = {}, {}
    for key, leaf in _leaves(params):
        if isinstance(leaf, PalettizedTensor):
            out[key + "::idx"] = pack_bits(leaf.indices, leaf.nbits).cpu()
            out[key + "::lut"] = leaf.lut.float().cpu()
            palettized[key] = {"nbits": leaf.nbits, "shape": list(leaf.shape),
                               "count": math.prod(leaf.shape)}
            continue
        t = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(leaf))
        out[key] = t.cpu().contiguous()
    return out, palettized


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def save_module(path: str | Path, params, config=None, name: str = "module"):
    """Write ``<path>/<name>.safetensors`` and ``<path>/<name>.json``;
    ``PalettizedTensor`` entries are stored compressed."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat, palettized = _flatten(params)
    save_file(flat, path / f"{name}.safetensors")
    manifest = {
        "name": name,
        "tensors": {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                    for k, v in flat.items()},
    }
    if palettized:
        manifest["palettized"] = palettized
    if config is not None:
        manifest["config"] = dataclasses.asdict(config)
        manifest["config_class"] = type(config).__name__
    (path / f"{name}.json").write_text(json.dumps(manifest, indent=1))


def load_module(path: str | Path, name: str = "module", dequantize: bool = True,
                device: str | torch.device = "cuda"):
    """-> (tree of tensors on ``device``, split on '/' as it was saved,
    manifest).  Palettized entries come back dense float32
    (``dequantize=True``) or as ``PalettizedTensor``s (``dequantize=False``);
    their indices are unpacked on ``device``."""
    path = Path(path)
    flat = {k: v.to(device) for k, v in load_file(path / f"{name}.safetensors").items()}
    manifest = json.loads((path / f"{name}.json").read_text())
    for key, info in manifest.get("palettized", {}).items():
        idx = unpack_bits(flat.pop(key + "::idx"), info["nbits"], info["count"])
        pt = PalettizedTensor(idx, flat.pop(key + "::lut"), tuple(info["shape"]),
                              info["nbits"])
        flat[key] = pt.dequantize() if dequantize else pt
    return _unflatten(flat), manifest
