"""The system under test, built from a configuration file: the port's
modules at the preset the file names, in the dtypes its loader gives them,
with the benchmark's weights from the seed, inside the port's pipeline.

A configuration names its ``family``; ``sdbench/families/<family>.py``
builds that family's pipeline and says what the benchmark counts of it:
``pipeline(cfg, seed, device)``, ``reference(cfg, seed, device)`` (the
plain reference the check runs), ``model_flops(cfg)`` and
``flash_calls(cfg, images)`` (``sdbench/harness/work.py``).  A new family
is a new file there.

Modules are built on the ``meta`` device, cast there, and only then
allocated on the card, so that no float32 copy of a bfloat16 denoiser ever
takes card memory.  Each preset is held against the numbers the file
states (the reference builds from those numbers), and each module's
parameter names and shapes against the reference's: the weights are made
for that list.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import torch

from ..reference import models as ref_models
from ..reference import weights
from ..reference.pipeline import letters_vocab

ROOT = Path(__file__).resolve().parents[2]

#: the port's configuration class and module of each kind
KINDS = {
    "clip": ("ml_stable_diffusion_torch.models.clip", "CLIPTextConfig", "CLIPTextEncoder"),
    "unet": ("ml_stable_diffusion_torch.models.unet", "UNetConfig", "UNet2DConditionModel"),
    "vae_decoder": ("ml_stable_diffusion_torch.models.vae", "VAEConfig", "VAEDecoder"),
}


def _plain(v):
    return list(v) if isinstance(v, tuple) else v


def family(name: str, root: Path = ROOT):
    """The family module ``sdbench/families/<name>.py`` of ``root``."""
    path = root / "sdbench" / "families" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"unknown family {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(
        "sdbench_family_" + name.replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_config(kind: str, spec: dict, kinds: dict = KINDS):
    """The port's configuration object: its preset (``spec["preset"]``, a
    classmethod of the configuration class) or, without one, the class built
    from ``spec["config"]``.  Every number the file states must equal the
    preset's."""
    import importlib

    mod_name, cfg_cls, _ = kinds[kind]
    cls = getattr(importlib.import_module(mod_name), cfg_cls)
    if spec.get("preset"):
        cfg = getattr(cls, spec["preset"])()
    else:
        fields = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in spec["config"].items() if k in fields})
    wrong = {k: (v, _plain(getattr(cfg, k, None))) for k, v in spec["config"].items()
             if _plain(getattr(cfg, k, None)) != v}
    if wrong:
        raise ValueError(f"{kind} preset {spec.get('preset')!r} differs from the file: "
                         f"{wrong} (file, preset)")
    return cfg


def port_module(kind: str, spec: dict, seed: int, device, kinds: dict = KINDS,
                reference=ref_models.build) -> torch.nn.Module:
    """The port's module of ``kind`` (``kinds``: kind -> the port's module,
    configuration class and module class) on ``device`` in
    ``spec["dtype"]``, weights from (seed, role); ``reference(kind,
    config)`` builds the reference's module, whose parameters it must
    match."""
    import importlib

    mod_name, _, mod_cls = kinds[kind]
    cls = getattr(importlib.import_module(mod_name), mod_cls)
    with torch.device("meta"):
        module = cls(port_config(kind, spec, kinds)).to(getattr(torch, spec["dtype"]))
        ref = reference(kind, spec["config"])
    if weights.spec(module) != weights.spec(ref):
        mine, theirs = set(weights.spec(module)), set(weights.spec(ref))
        raise ValueError(f"{kind}: the port's parameters differ from the reference's: "
                         f"{sorted(mine - theirs)[:5]} / {sorted(theirs - mine)[:5]}")
    module = module.to_empty(device=device)
    return weights.fill_(module, seed, spec["role"]).eval()


def tokenizer(tok: dict):
    from ml_stable_diffusion_torch.tokenizer import CLIPTokenizer

    return CLIPTokenizer(letters_vocab(tok["bos"], tok["eos"]), [],
                         pad_token="<|endoftext|>")


def check_stated(pipe, cfg: dict):
    """The pipeline's scheduler and latent scale against the file's."""
    sc = {k: getattr(v, "value", v)
          for k, v in dataclasses.asdict(pipe.scheduler_config).items()}
    stated = {"scheduler_config": (cfg["scheduler_config"], sc),
              "latent_scale": (cfg["latent_scale"], pipe.default_latent_scale)}
    wrong = {k: v for k, v in stated.items() if v[0] != v[1]}
    if wrong:
        raise ValueError(f"the pipeline differs from the file: {wrong} (file, pipeline)")
    return pipe
