"""LoRA adapters: parsing and merging into the port's modules (port of
ml_stable_diffusion_tpu/convert/lora.py).

Two on-disk formats:

- **kohya / sd-scripts**: flat safetensors with keys
  ``lora_unet_<module path, dots mangled to underscores>.lora_down.weight``
  / ``.lora_up.weight`` / ``.alpha``; text-encoder modules under
  ``lora_te_`` (SD) or ``lora_te1_`` / ``lora_te2_`` (SDXL), the SD3 MMDiT
  under ``lora_transformer_``.  kohya's SDXL trainer names the UNet's
  modules after the original sgm UNet (``input_blocks_4_1_...``), demangled
  here with diffusers' block arithmetic;
- **diffusers PEFT**: ``unet.<module>.lora_A.weight`` / ``.lora_B.weight``
  (prefixes ``text_encoder.``, ``text_encoder_2.``, ``transformer.``), and
  the older attn-processor spelling
  ``<block>.attn1.processor.to_q_lora.down.weight``.

A merge adds ``scale * (alpha / rank) * up @ down`` to the module's weight:
the delta is computed on the host in numpy float32, as the JAX package
computes it, added to the weight in float32 and cast back to the weight's
dtype, so a float32 merge gives the JAX package's weights bit for bit.
``merge_lora`` keeps a pristine copy of each weight it touches, from which
``restore_loras`` puts the weights back exactly (a float add is not
invertible).

The port's parameters carry diffusers names, so a module path would name a
parameter as it stands.  The translators below accept exactly the module
paths the JAX package's ``unet_flax_path``, ``clip_flax_path`` and
``mmdit_flax_path`` accept, and only where the JAX parameter tree holds a
``kernel`` there (a ``Linear`` or a ``Conv2d`` here): they raise
``KeyError`` (or ``IndexError``) where the JAX functions do, so a LoRA the
JAX package refuses (one on a text encoder's embeddings, on a norm) is
refused here too.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .native_io import load_file

#: adapter targets -> pipeline component
TARGET_UNET = "unet"
TARGET_TE = "text_encoder"
TARGET_TE2 = "text_encoder_2"
TARGET_TRANSFORMER = "transformer"  # SD3 MMDiT


def _np(value) -> np.ndarray:
    """A tensor or array as numpy, without changing its values."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:  # numpy has no bfloat16: exact in f32
            value = value.float()
        return value.numpy()
    return np.asarray(value)


@dataclasses.dataclass
class LoRAModule:
    """One adapted layer: ``delta_W = (alpha/rank) * up @ down``."""

    down: np.ndarray  # (r, in) or (r, in, kh, kw)
    up: np.ndarray    # (out, r) or (out, r, 1, 1)
    alpha: float | None = None  # None -> rank (factor 1.0)

    @property
    def rank(self) -> int:
        return self.down.shape[0]

    def delta(self, scale: float = 1.0) -> np.ndarray:
        """torch-layout float32 weight delta: (out, in) or (out, in, kh, kw)."""
        alpha = self.rank if self.alpha is None else self.alpha
        s = scale * alpha / self.rank
        up, down = np.float32(self.up), np.float32(self.down)
        if down.ndim == 2 and up.ndim == 2:
            return s * (up @ down)
        if down.ndim == 4 and up.ndim == 4:
            # conv LoRA (LoCon): up is (out, r, 1, 1), down (r, in, kh, kw)
            r, cin, kh, kw = down.shape
            d = up[:, :, 0, 0] @ down.reshape(r, cin * kh * kw)
            return s * d.reshape(up.shape[0], cin, kh, kw)
        raise ValueError(
            f"unsupported LoRA factor ranks: down{down.shape} up{up.shape} "
            "(LoHa/LoKr decompositions are not supported)")


@dataclasses.dataclass
class LoRAAdapter:
    """Parsed adapter: {(target, diffusers module path) -> LoRAModule}."""

    modules: dict[tuple[str, str], LoRAModule]
    name: str = "lora"

    def targets(self) -> set[str]:
        return {t for t, _ in self.modules}


# ---------------------------------------------------------------------------
# parsing

_KOHYA_PREFIXES = (
    ("lora_unet_", TARGET_UNET),
    ("lora_te1_", TARGET_TE),
    ("lora_te2_", TARGET_TE2),
    ("lora_te_", TARGET_TE),
    ("lora_transformer_", TARGET_TRANSFORMER),
)

#: ordered rewrites turning kohya's underscore-mangled UNet module path back
#: into the dotted diffusers path.  Index-bearing containers first; leaf
#: names that contain underscores (to_q, proj_in, conv_shortcut,
#: time_emb_proj, ...) are left alone.
_KOHYA_UNET_RULES = [
    (re.compile(r"^(down|up)_blocks_(\d+)_"), r"\1_blocks.\2."),
    (re.compile(r"^mid_block_"), "mid_block."),
    (re.compile(r"(attentions|resnets|downsamplers|upsamplers)_(\d+)_"), r"\1.\2."),
    (re.compile(r"transformer_blocks_(\d+)_"), r"transformer_blocks.\1."),
    (re.compile(r"(attn\d)_"), r"\1."),
    (re.compile(r"ff_net_0_proj$"), "ff.net.0.proj"),
    (re.compile(r"ff_net_2$"), "ff.net.2"),
    (re.compile(r"to_out_0$"), "to_out.0"),
    (re.compile(r"^time_embedding_linear_(\d)$"), r"time_embedding.linear.\1"),
    (re.compile(r"^add_embedding_linear_(\d)$"), r"add_embedding.linear.\1"),
]

_KOHYA_TE_RULES = [
    (re.compile(r"^text_model_encoder_layers_(\d+)_(self_attn|mlp)_"),
     r"text_model.encoder.layers.\1.\2."),
]

#: SD3 MMDiT (diffusers SD3Transformer2DModel module paths)
_KOHYA_TRANSFORMER_RULES = [
    (re.compile(r"^transformer_blocks_(\d+)_"), r"transformer_blocks.\1."),
    (re.compile(r"(attn|ff_context|ff)_"), r"\1."),
    (re.compile(r"net_0_proj$"), "net.0.proj"),
    (re.compile(r"net_2$"), "net.2"),
    (re.compile(r"to_out_0$"), "to_out.0"),
    (re.compile(r"norm1(_context)?_linear$"), r"norm1\1.linear"),
    (re.compile(r"^norm_out_linear$"), "norm_out.linear"),
]

#: kohya's SDXL trainer addresses the sgm UNet (input_blocks / middle_block
#: / output_blocks).  With layers_per_block=2 every diffusers block spans 3
#: sgm indices: down block = (i-1)//3 at layer (i-1)%3, up block = i//3 at
#: layer i%3, the arithmetic of diffusers' non-diffusers-LoRA loader
_SGM_IO_RE = re.compile(r"^(input|output)_blocks_(\d+)_(\d+)_(.+)$")
_SGM_MID_RE = re.compile(r"^middle_block_(\d)_(.+)$")
_SGM_RES_LEAF = {"in_layers_2": "conv1", "out_layers_3": "conv2",
                 "emb_layers_1": "time_emb_proj", "skip_connection": "conv_shortcut"}


def _demangle_rest(rest: str, rules) -> str:
    for pat, repl in rules:
        rest = pat.sub(repl, rest)
    return rest


def _sgm_demangle(mangled: str) -> str | None:
    """kohya-SDXL sgm module path -> diffusers module path (None if the key
    is not sgm-named)."""
    m = _SGM_MID_RE.match(mangled)
    if m:
        idx, rest = int(m.group(1)), m.group(2)
        if idx == 1:
            return "mid_block.attentions.0." + _demangle_rest(rest, _KOHYA_UNET_RULES)
        return f"mid_block.resnets.{idx // 2}." + _SGM_RES_LEAF[rest]
    m = _SGM_IO_RE.match(mangled)
    if not m:
        return None
    kind, i, sub, rest = m.group(1), int(m.group(2)), int(m.group(3)), m.group(4)
    if kind == "input":
        side, block, layer = "down_blocks", (i - 1) // 3, (i - 1) % 3
    else:
        side, block, layer = "up_blocks", i // 3, i % 3
    if sub == 0 and rest == "op":  # sgm downsample conv
        return f"down_blocks.{block}.downsamplers.0.conv"
    if rest == "conv":  # sgm upsample conv (its module index varies)
        return f"up_blocks.{block}.upsamplers.0.conv"
    if sub == 0:
        return f"{side}.{block}.resnets.{layer}." + _SGM_RES_LEAF[rest]
    return f"{side}.{block}.attentions.{layer}." + _demangle_rest(rest, _KOHYA_UNET_RULES)


def _kohya_demangle(target: str, mangled: str) -> str:
    if target == TARGET_UNET:
        sgm = _sgm_demangle(mangled)
        if sgm is not None:
            return sgm
    rules = {TARGET_UNET: _KOHYA_UNET_RULES, TARGET_TE: _KOHYA_TE_RULES,
             TARGET_TE2: _KOHYA_TE_RULES, TARGET_TRANSFORMER: _KOHYA_TRANSFORMER_RULES}[target]
    return _demangle_rest(mangled, rules)


_PEFT_PREFIXES = (
    ("unet.", TARGET_UNET),
    ("text_encoder.", TARGET_TE),
    ("text_encoder_2.", TARGET_TE2),
    ("transformer.", TARGET_TRANSFORMER),
)

#: the old diffusers attn-processor spelling -> module path + up/down side
_PROCESSOR_RE = re.compile(
    r"^(?P<base>.+)\.processor\.(?P<mod>to_q|to_k|to_v|to_out)_lora\."
    r"(?P<side>up|down)\.weight$")


def parse_lora_state_dict(sd: dict, name: str = "lora") -> LoRAAdapter:
    """Flat {key: tensor or array} (either on-disk format) -> LoRAAdapter."""
    mods: dict[tuple[str, str], dict] = {}

    def slot(target, module):
        return mods.setdefault((target, module), {})

    for key, val in sd.items():
        if key.startswith("lora_"):  # kohya
            for prefix, target in _KOHYA_PREFIXES:
                if key.startswith(prefix):
                    rest = key[len(prefix):]
                    break
            else:
                raise ValueError(f"unrecognized kohya LoRA key: {key}")
            if rest.endswith(".lora_down.weight"):
                side, mangled = "down", rest[: -len(".lora_down.weight")]
            elif rest.endswith(".lora_up.weight"):
                side, mangled = "up", rest[: -len(".lora_up.weight")]
            elif rest.endswith(".alpha"):
                side, mangled = "alpha", rest[: -len(".alpha")]
            else:
                continue  # .lora_mid (LoHa parts) surface in delta()'s error
            slot(target, _kohya_demangle(target, mangled))[side] = val
            continue

        m = _PROCESSOR_RE.match(key)
        if m:  # the old diffusers attn-processor format (UNet only)
            mod = m.group("mod")
            module = f"{m.group('base')}.{'to_out.0' if mod == 'to_out' else mod}"
            slot(TARGET_UNET, module)[m.group("side")] = val
            continue

        for prefix, target in _PEFT_PREFIXES:  # diffusers PEFT
            if key.startswith(prefix):
                rest = key[len(prefix):]
                if rest.endswith(".lora_A.weight"):
                    side, module = "down", rest[: -len(".lora_A.weight")]
                elif rest.endswith(".lora_B.weight"):
                    side, module = "up", rest[: -len(".lora_B.weight")]
                elif rest.endswith(".alpha"):
                    side, module = "alpha", rest[: -len(".alpha")]
                else:
                    raise ValueError(f"unrecognized PEFT LoRA key: {key}")
                slot(target, module)[side] = val
                break
        else:
            raise ValueError(f"unrecognized LoRA key: {key}")

    out: dict[tuple[str, str], LoRAModule] = {}
    for (target, module), parts in mods.items():
        if "down" not in parts or "up" not in parts:
            raise ValueError(f"LoRA module {target}:{module} is missing a factor "
                             f"(got {sorted(parts)})")
        alpha = parts.get("alpha")
        out[(target, module)] = LoRAModule(
            down=_np(parts["down"]), up=_np(parts["up"]),
            alpha=None if alpha is None else float(_np(alpha).reshape(-1)[0]))
    return LoRAAdapter(modules=out, name=name)


def load_lora(path: str | Path) -> LoRAAdapter:
    """Read a LoRA adapter from a .safetensors file."""
    path = Path(path)
    return parse_lora_state_dict(load_file(path), name=path.stem)


# ---------------------------------------------------------------------------
# diffusers module path -> the port's module (the JAX translators' rules)

def unet_module_name(module: str) -> str:
    """diffusers UNet module path -> the port UNet's module name, by the
    token walk of the JAX ``unet_flax_path`` (which also takes ``to_out.<any
    index>`` as ``to_out.0``)."""
    parts = module.split(".")
    if parts[0] in ("down_blocks", "up_blocks", "mid_block"):
        n = 3 if parts[0] == "mid_block" else 4
        head, rest = ".".join(parts[:n]), parts[n:]
    elif parts[0] in ("conv_in", "conv_out"):
        return parts[0]
    elif parts[0] in ("time_embedding", "add_embedding"):
        return f"{parts[0]}.{'_'.join(parts[1:])}"
    else:
        raise KeyError(f"unsupported UNet LoRA module: {module}")
    out = [head]
    i = 0
    while i < len(rest):
        t = rest[i]
        if t == "transformer_blocks":
            out.append(f"transformer_blocks.{rest[i + 1]}")
            i += 2
        elif t == "to_out":
            out.append("to_out.0")
            i += 2
        elif t == "ff":
            sub = rest[i + 1:]
            if sub[:3] == ["net", "0", "proj"]:
                out.append("ff.net.0.proj")
                i += 4
            elif sub[:2] == ["net", "2"]:
                out.append("ff.net.2")
                i += 3
            else:
                raise KeyError(f"unsupported UNet LoRA module: {module}")
        else:
            out.append(t)
            i += 1
    return ".".join(out)


_CLIP_LEAVES = {"q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
                "out_proj": "self_attn", "fc1": "mlp", "fc2": "mlp"}


def clip_module_name(module: str) -> str:
    """transformers CLIPTextModel module path -> the port's module name: a
    layer's q/k/v/out projection or fc1/fc2 only, by the JAX
    ``clip_flax_path`` rule (the layer index and the leaf decide)."""
    p = module.split(".")
    if p and p[0] == "text_model":
        p = p[1:]
    if p and p[0] == "encoder":
        p = p[1:]
    if len(p) >= 3 and p[0] == "layers" and p[-1] in _CLIP_LEAVES:
        return f"text_model.encoder.layers.{p[1]}.{_CLIP_LEAVES[p[-1]]}.{p[-1]}"
    raise KeyError(f"unsupported text-encoder LoRA module: {module}")


_MMDIT_ATTN = {"to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
               "to_add_out"}
_MMDIT_BLOCK = {"ff.net.0.proj", "ff.net.2", "ff_context.net.0.proj", "ff_context.net.2",
                "norm1.linear", "norm1_context.linear"}


def mmdit_module_name(module: str) -> str:
    """diffusers SD3Transformer2DModel module path -> the port MMDiT's
    module name, by the JAX ``mmdit_flax_path`` rules."""
    p = module.split(".")
    if p[0] == "transformer_blocks":
        blk, rest = f"transformer_blocks.{p[1]}", p[2:]
        r = ".".join(rest)
        if rest[0] == "attn":
            if r == "attn.to_out.0":
                return f"{blk}.attn.to_out.0"
            if rest[1] in _MMDIT_ATTN:
                return f"{blk}.attn.{rest[1]}"
        if r in _MMDIT_BLOCK:
            return f"{blk}.{r}"
    elif module in ("context_embedder", "proj_out", "norm_out.linear"):
        return module
    raise KeyError(f"unsupported MMDiT LoRA module: {module}")


TRANSLATORS = {TARGET_UNET: unet_module_name, TARGET_TE: clip_module_name,
               TARGET_TE2: clip_module_name, TARGET_TRANSFORMER: mmdit_module_name}


def lora_weight(model: nn.Module, target: str, module: str) -> nn.Parameter:
    """The weight a LoRA on ``module`` of ``target`` merges into: the
    translated module must be a ``Linear`` or ``Conv2d`` of ``model`` (where
    the JAX tree holds a ``kernel``), else ``KeyError``."""
    name = TRANSLATORS[target](module)
    try:
        layer = model.get_submodule(name)
    except AttributeError:
        layer = None
    if not isinstance(layer, (nn.Linear, nn.Conv2d)):
        raise KeyError(f"param path {name} has no kernel in the model")
    return layer.weight


# ---------------------------------------------------------------------------
# merging

def oriented_delta(delta: np.ndarray, shape) -> np.ndarray:
    """A torch-layout delta onto a weight of ``shape``: a Linear's (out,
    in) delta onto a 1x1 conv's (out, in, 1, 1) weight and the other way."""
    if delta.ndim == 2:
        d = delta[:, :, None, None] if len(shape) == 4 else delta
    elif delta.ndim == 4:
        d = delta[:, :, 0, 0] if len(shape) == 2 else delta
    else:
        raise ValueError(f"bad LoRA delta rank: {delta.shape}")
    if tuple(d.shape) != tuple(shape):
        raise ValueError(f"LoRA delta shape {d.shape} does not match param {tuple(shape)}")
    return d


@torch.no_grad()
def merge_lora(model: nn.Module, adapter: LoRAAdapter, target: str, scale: float = 1.0,
               originals: dict | None = None):
    """Merge every ``target`` module of ``adapter`` into ``model``'s weights
    in place: ``W = (float32(W) + delta).to(W.dtype)``.  ``originals``
    (optional) collects a pristine copy of each touched weight keyed by its
    module name; pass the same dict across merges for ``restore_loras``."""
    # every module resolved and every delta shaped first: a refused adapter
    # leaves the weights as they were, as the JAX merge (copy on write) does
    todo = []
    for (t, module), mod in sorted(adapter.modules.items()):
        if t == target:
            w = lora_weight(model, target, module)
            todo.append((TRANSLATORS[target](module), w,
                         oriented_delta(mod.delta(scale), w.shape)))
    for name, w, d in todo:
        if originals is not None and name not in originals:
            originals[name] = w.detach().clone()
        merged = w.float() + torch.from_numpy(np.ascontiguousarray(d)).to(w.device)
        w.copy_(merged.to(w.dtype))


@torch.no_grad()
def restore_loras(model: nn.Module, originals: dict):
    """Put back the weights ``merge_lora`` recorded in ``originals``."""
    for name, orig in originals.items():
        model.get_submodule(name).weight.copy_(orig)
