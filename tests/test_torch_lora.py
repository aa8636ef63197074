"""The port's LoRA adapters against the JAX package's, on the CPU.

- kohya name demangling over tests/test_lora.py's UNet, sgm, text-encoder
  and MMDiT names, equal to the JAX function's;
- the three on-disk formats (kohya, PEFT, the attn-processor spelling)
  parse to the same modules with bit-equal float32 deltas;
- the module set each package accepts: every module of the tiny UNets, CLIP
  and MMDiT (and a few names the JAX walk takes in its own way) is accepted
  by both onto the same weight, or refused by both with the same exception;
- merged float32 weights bit-equal to ``flax_params_to_diffusers_sd`` of the
  JAX merge (a Linear, a GEGLU projection, a 3x3 conv, a conv LoRA onto a
  Linear, a Linear LoRA onto a 1x1 conv, the time embedding, the text
  encoder); in bfloat16 bit-equal to the JAX merge into bfloat16 leaves;
- tiny SD, SDXL (kohya sgm names, both text encoders) and SD3 (PEFT
  ``transformer.``) generations after ``apply_lora`` within the atol of
  their pipelines' parity tests (1e-3), and ``clear_loras`` bit-exact.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.convert import lora as JL
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig

from ml_stable_diffusion_torch.convert import lora as PL
from ml_stable_diffusion_torch.convert.from_jax import (
    clip_text_state_dict,
    mmdit_state_dict,
    unet_state_dict,
)
from ml_stable_diffusion_torch.convert.native_io import save_file
from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from ml_stable_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

import test_lora
import test_torch_sd3 as sd3t
import test_torch_sdxl as xlt
from helpers import flax_params_to_diffusers_sd, randomize_params
from torch_helpers import (
    _load,
    pipelines,
    sd3_pipelines,
    sdxl_pipelines,
    tiny_text_encoder,
    tiny_unet,
    traced,
)

HW = (64, 64)
GEN = dict(prompt="a cat", negative_prompt="blurry", step_count=2, guidance_scale=5.0,
           seed=7, disable_safety=True, rng="numpy")


def _demangle_cases():
    """(target, mangled, want) from tests/test_lora.py's demangling tests."""
    import inspect
    import re

    out = []
    for fn, target in ((test_lora.test_kohya_demangle_diffusers_names, JL.TARGET_UNET),
                       (test_lora.test_kohya_demangle_sgm_names, JL.TARGET_UNET),
                       (test_lora.test_kohya_demangle_te_and_transformer,
                        JL.TARGET_TRANSFORMER)):
        src = inspect.getsource(fn)
        out += [(target, m, w) for m, w in re.findall(r'"(\w+)":\s*"([\w.]+)"', src)]
    out += [(JL.TARGET_TE, "text_model_encoder_layers_11_self_attn_q_proj",
             "text_model.encoder.layers.11.self_attn.q_proj"),
            (JL.TARGET_TE2, "text_model_encoder_layers_3_mlp_fc1",
             "text_model.encoder.layers.3.mlp.fc1")]
    return out


@pytest.mark.parametrize("target,mangled,want", _demangle_cases())
def test_kohya_demangling_matches_jax(target, mangled, want):
    assert PL._kohya_demangle(target, mangled) == JL._kohya_demangle(target, mangled) == want


def test_formats_parse_to_the_same_deltas_as_jax():
    """kohya (alpha 1 at rank 2: factor 0.5), PEFT (no alpha: 1.0), the
    attn-processor spelling; a LoCon conv factor pair; each delta bit-equal
    to the JAX package's, kohya = 0.5 x PEFT."""
    rng = np.random.default_rng(1)
    down = rng.normal(size=(2, 16)).astype(np.float32)
    up = rng.normal(size=(16, 2)).astype(np.float32)
    base = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"
    kohya_key = "lora_unet_" + base.replace(".", "_")
    conv_key = "lora_unet_down_blocks_0_resnets_0_conv1"
    sds = {
        "kohya": {f"{kohya_key}.lora_down.weight": down, f"{kohya_key}.lora_up.weight": up,
                  f"{kohya_key}.alpha": np.float32(1.0),
                  f"{conv_key}.lora_down.weight": rng.normal(size=(2, 16, 3, 3)).astype(np.float32),
                  f"{conv_key}.lora_up.weight": rng.normal(size=(8, 2, 1, 1)).astype(np.float32)},
        "peft": {f"unet.{base}.lora_A.weight": down, f"unet.{base}.lora_B.weight": up},
        "processor": {base.replace("attn1.to_q", "attn1.processor.to_q_lora.down.weight"): down,
                      base.replace("attn1.to_q", "attn1.processor.to_q_lora.up.weight"): up},
    }
    deltas = {}
    for fmt, sd in sds.items():
        got = PL.parse_lora_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
        ref = JL.parse_lora_state_dict(sd)
        assert set(got.modules) == set(ref.modules)
        for key, mod in got.modules.items():
            assert mod.alpha == ref.modules[key].alpha
            np.testing.assert_array_equal(mod.delta(0.7), ref.modules[key].delta(0.7))
        deltas[fmt] = got.modules[("unet", base)].delta()
    np.testing.assert_array_equal(deltas["peft"], deltas["processor"])
    np.testing.assert_allclose(deltas["kohya"], 0.5 * deltas["peft"], rtol=1e-6)
    with pytest.raises(ValueError, match="missing a factor"):
        PL.parse_lora_state_dict({f"unet.{base}.lora_A.weight": torch.zeros(2, 8)})
    with pytest.raises(ValueError, match="LoHa/LoKr"):
        PL.LoRAModule(down=np.zeros((2, 8, 1)), up=np.zeros((8, 2))).delta()


# -- the accepted module set ------------------------------------------------------

@functools.cache
def _tiny(kind):
    """The tiny Flax models, initialised once for the module."""
    return {"te": tiny_text_encoder, "unet": tiny_unet}[kind]()


def _port(cls, cfg_cls, model):
    return cls(cfg_cls(**dataclasses.asdict(model.config)))


@functools.cache
def _families():
    """family -> (port module (its weights are not read), Flax params or their
    shapes, JAX translator, target, Flax-path -> port key, extra names the
    JAX walk reads its own way)."""
    (te, te_p), (unet, unet_p) = _tiny("te"), _tiny("unet")
    xl, xl_p = traced(tiny_unet, cross_dim=xlt.XL_CTX, xl=True)
    mm, mm_p = sd3t._tiny_mmdit()
    unet_extra = ["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_out.1",
                  "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.1",
                  "down_blocks.0.attentions", "conv_norm_out", "add_embedding.linear_1",
                  "time_embedding.linear_1", "up_blocks.1.upsamplers.0.conv"]
    return {
        "unet": (_port(UNet2DConditionModel, UNetConfig, unet), unet_p,
                 JL.unet_flax_path, "unet", unet_state_dict, unet_extra),
        "unet_xl": (_port(UNet2DConditionModel, UNetConfig, xl), xl_p,
                    JL.unet_flax_path, "unet", unet_state_dict, unet_extra),
        "clip": (_port(CLIPTextEncoder, CLIPTextConfig, te), te_p,
                 JL.clip_flax_path, "text_encoder", clip_text_state_dict,
                 ["text_model.encoder.layers.0.self_attn.fc1", "layers.1.mlp.q_proj",
                  "encoder.layers.0.self_attn.q_proj", "text_model.encoder.layers.7.mlp.fc1"]),
        "mmdit": (_port(MMDiT, MMDiTConfig, mm), mm_p,
                  JL.mmdit_flax_path, "transformer", mmdit_state_dict,
                  ["transformer_blocks.0.attn.to_q.extra", "transformer_blocks.1.attn.to_add_out",
                   "transformer_blocks.1.ff_context.net.2", "pos_embed.proj"]),
    }


def _outcome(fn):
    try:
        return "ok", fn()
    except (KeyError, IndexError) as e:
        return type(e).__name__, None


@pytest.mark.parametrize("family", ["unet", "unet_xl", "clip", "mmdit"])
def test_accepted_module_set_matches_jax(family):
    """Every module name of the tiny model (Linears, Conv2ds, norms,
    embeddings, containers) and the extra names: accepted by both onto the
    same weight, or refused by both with the same exception type."""
    module, params, jax_path, target, to_port, extra = _families()[family]

    def jax_key():
        path = jax_path(name) + ("kernel",)
        JL._get(params, path)
        tree = np.zeros((1, 1), np.float32)
        for k in reversed(path):
            tree = {k: tree}
        (key,) = to_port(tree)
        return key

    names = [n for n, _ in module.named_modules() if n] + extra
    accepted = 0
    for name in names:
        ref = _outcome(jax_key)
        got = _outcome(lambda: PL.TRANSLATORS[target](name) + ".weight"
                       if PL.lora_weight(module, target, name) is not None else None)
        assert got == ref, name
        accepted += ref[0] == "ok"
    assert accepted > 0


# -- merged weights ---------------------------------------------------------------

def _factors(rng, shape, rank=2, conv=False):
    """(down, up) for a weight of torch ``shape``; ``conv``: a LoCon pair
    (for a 2-D weight, a 1x1 one)."""
    out_ch, in_ch = shape[:2]
    k = shape[2:] if len(shape) == 4 else (1, 1)
    if conv:
        return (rng.normal(size=(rank, in_ch, *k)).astype(np.float32) * 0.1,
                rng.normal(size=(out_ch, rank, 1, 1)).astype(np.float32) * 0.1)
    return (rng.normal(size=(rank, in_ch)).astype(np.float32) * 0.1,
            rng.normal(size=(out_ch, rank)).astype(np.float32) * 0.1)


def _adapter(modules, seed, fmt="kohya"):
    """A LoRA state dict over ``modules``: [(key stem, port weight shape,
    conv)]; kohya stems carry an alpha (rank 2, alpha 3: factor 1.5)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for stem, shape, conv in modules:
        down, up = _factors(rng, shape, conv=conv)
        if fmt == "kohya":
            sd.update({f"{stem}.lora_down.weight": down, f"{stem}.lora_up.weight": up,
                       f"{stem}.alpha": np.float32(3.0)})
        else:
            sd.update({f"{stem}.lora_A.weight": down, f"{stem}.lora_B.weight": up})
    return sd


def _unet_modules(unet, prefix="lora_unet_"):
    """kohya stems over the tiny SD UNet: a Linear, the GEGLU projection, a
    3x3 conv, a conv LoRA onto the Linear proj_in, a Linear LoRA onto a 1x1
    conv_shortcut, the time embedding."""
    w = dict(unet.named_parameters())
    blk = "down_blocks.0.attentions.0"
    picks = [(f"{blk}.transformer_blocks.0.attn1.to_q", False),
             (f"{blk}.transformer_blocks.0.ff.net.0.proj", False),
             ("down_blocks.0.resnets.0.conv1", True), (f"{blk}.proj_in", True),
             ("up_blocks.1.resnets.0.conv_shortcut", False), ("time_embedding.linear_1", False)]
    out = []
    for name, conv in picks:
        shape = tuple(w[name + ".weight"].shape)
        if not conv and len(shape) == 4:
            shape = shape[:2]
        out.append((prefix + name.replace(".", "_"), shape, conv))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merged_weights_bit_equal_to_jax(dtype):
    """The UNet and text-encoder merges against the JAX merge into leaves of
    the same dtype, bit for bit (float32, and bfloat16 leaves as
    ``convert/load.load_unet`` holds them)."""
    (te, te_p), (unet, unet_p) = _tiny("te"), _tiny("unet")
    unet_p, te_p = randomize_params(unet_p, 5), randomize_params(te_p, 6)
    port_unet = _load(UNet2DConditionModel, UNetConfig, unet, unet_p, unet_state_dict)
    port_te = _load(CLIPTextEncoder, CLIPTextConfig, te, te_p, clip_text_state_dict)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    port_unet, port_te = port_unet.to(tdt), port_te.to(tdt)
    unet_p, te_p = (jax.tree.map(lambda a: a.astype(jdt), p) for p in (unet_p, te_p))
    te_mods = [(f"lora_te_text_model_encoder_layers_{i}_{leaf}", (48, 48) if "fc" not in leaf
                else ((64, 48) if leaf.endswith("fc1") else (48, 64)), False)
               for i in (0, 1) for leaf in ("self_attn_q_proj", "self_attn_out_proj", "mlp_fc1",
                                            "mlp_fc2")]
    sd = _adapter(_unet_modules(port_unet) + te_mods, seed=3)
    jax_adapter, port_adapter = JL.parse_lora_state_dict(sd), PL.parse_lora_state_dict(sd)
    ref_unet = JL.merge_lora_into_params(unet_p, jax_adapter, "unet", 0.8)
    ref_te = JL.merge_lora_into_params(te_p, jax_adapter, "text_encoder", 0.8)
    originals = {}
    PL.merge_lora(port_unet, port_adapter, "unet", 0.8, originals)
    PL.merge_lora(port_te, port_adapter, "text_encoder", 0.8)
    assert len(originals) == 6
    want = {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in flax_params_to_diffusers_sd(ref_unet, "unet").items()}
    got = port_unet.state_dict()
    assert set(want) == set(got)
    changed = [k for k in got if not torch.equal(got[k].float(), want[k].reshape(got[k].shape))]
    assert changed == [], changed
    ref_te_sd = clip_text_state_dict(jax.tree.map(lambda a: np.asarray(a, np.float32), ref_te))
    for key, value in port_te.state_dict().items():
        assert torch.equal(value.float(), ref_te_sd[key]), key
    PL.restore_loras(port_unet, originals)
    base = unet_state_dict(jax.tree.map(lambda a: np.asarray(a, np.float32), unet_p))
    for key, value in port_unet.state_dict().items():
        assert torch.equal(value.float(), base[key]), key


def test_bf16_merge_against_float32_leaves_within_one_ulp():
    """A JAX pipeline holding float32 leaves merges in float32 and casts at
    compute; the port's bfloat16 weight was rounded before the merge and is
    rounded again after it.  The gap is at most one bfloat16 step of the
    larger of the weight and the merged weight."""
    unet, unet_p = _tiny("unet")
    unet_p = randomize_params(unet_p, 5)
    port = _load(UNet2DConditionModel, UNetConfig, unet, unet_p, unet_state_dict)
    port = port.to(torch.bfloat16)
    sd = _adapter(_unet_modules(port), seed=4)
    ref = JL.merge_lora_into_params(unet_p, JL.parse_lora_state_dict(sd), "unet")
    PL.merge_lora(port, PL.parse_lora_state_dict(sd), "unet")
    base, want = (unet_state_dict(jax.tree.map(np.asarray, p)) for p in (unet_p, ref))
    worst, differ = 0.0, 0
    for key, value in port.state_dict().items():
        r = want[key].to(torch.bfloat16).float()
        big = torch.maximum(base[key].abs(), want[key].abs()).to(torch.bfloat16)
        ulp = (torch.nextafter(big, torch.tensor(np.inf, dtype=torch.bfloat16)) - big).float()
        gap = (value.float() - r).abs()
        worst = max(worst, float((gap / ulp).max()))
        differ += int((gap > 0).sum())
    assert 0 < differ and worst <= 1.0


def test_refused_adapter_leaves_the_weights():
    """An adapter with one module neither package takes (a GroupNorm) is
    refused whole: no weight changes."""
    unet, unet_p = _tiny("unet")
    port = _load(UNet2DConditionModel, UNetConfig, unet, unet_p, unet_state_dict)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    sd = _adapter([("unet.down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q", (16, 16),
                    False), ("unet.conv_norm_out", (16, 16), False)], seed=8, fmt="peft")
    with pytest.raises(KeyError):
        JL.merge_lora_into_params(unet_p, JL.parse_lora_state_dict(sd), "unet")
    with pytest.raises(KeyError):
        PL.merge_lora(port, PL.parse_lora_state_dict(sd), "unet")
    assert all(torch.equal(before[k], v) for k, v in port.state_dict().items())


# -- the pipelines ----------------------------------------------------------------

def _generate(jax_pipe, port_pipe, **kw):
    args = dict(GEN, **kw)
    ref = jax_pipe.generate_images(JaxConfig(**args), image_hw=HW).latents
    got = port_pipe.generate_images(PipelineConfiguration(**args), image_hw=HW).latents
    return ref, got


def _apply_and_clear(jax_pipe, port_pipe, sd, tmp_path, **kw):
    """Both pipelines before, with the adapter (a .safetensors file, applied
    at scale 0.9, then stacked once more at 0.5 through a parsed adapter),
    and the port after clear_loras: generations and weights."""
    modules = {name: module for name, module in vars(port_pipe).items()
               if isinstance(module, torch.nn.Module)}
    before = {name: {k: v.clone() for k, v in m.state_dict().items()}
              for name, m in modules.items()}
    _, base = _generate(jax_pipe, port_pipe, **kw)
    path = tmp_path / "adapter.safetensors"
    save_file(sd, path)
    jax_pipe.apply_lora(path, 0.9)
    port_pipe.apply_lora(path, 0.9)
    jax_pipe.apply_lora(JL.parse_lora_state_dict(sd), 0.5)
    port_pipe.apply_lora(PL.parse_lora_state_dict(sd), 0.5)
    assert port_pipe.applied_loras == jax_pipe.applied_loras == [("adapter", 0.9), ("lora", 0.5)]
    ref, got = _generate(jax_pipe, port_pipe, **kw)
    jax_pipe.clear_loras()
    np.testing.assert_allclose(got, ref, atol=1e-3)
    assert np.abs(got - base).max() > 1e-4  # the adapter moved the latents
    port_pipe.clear_loras()
    assert port_pipe.applied_loras == []
    for name, m in modules.items():
        for k, v in m.state_dict().items():
            assert torch.equal(before[name][k], v), (name, k)
    _, again = _generate(jax_pipe, port_pipe, **kw)
    np.testing.assert_array_equal(again, base)


def test_sd_generation_with_lora_matches_jax(tmp_path):
    jax_pipe, port_pipe = pipelines(tmp_path, weight_seed=11)
    te = [(f"lora_te_text_model_encoder_layers_0_self_attn_{p}", (48, 48), False)
          for p in ("q_proj", "v_proj")]
    sd = _adapter(_unet_modules(port_pipe.unet) + te, seed=12)
    _apply_and_clear(jax_pipe, port_pipe, sd, tmp_path, scheduler="DPMSolverMultistep")
    # a target the pipeline has no component for
    sd2 = {"text_encoder_2.text_model.encoder.layers.0.self_attn.q_proj.lora_A.weight":
           np.zeros((2, 48), np.float32),
           "text_encoder_2.text_model.encoder.layers.0.self_attn.q_proj.lora_B.weight":
           np.zeros((48, 2), np.float32)}
    for pipe, L in ((jax_pipe, JL), (port_pipe, PL)):
        with pytest.raises(ValueError, match="no component"):
            pipe.apply_lora(L.parse_lora_state_dict(sd2))


def test_sdxl_generation_with_kohya_sgm_lora_matches_jax(tmp_path):
    """kohya SDXL: sgm UNet names, ``lora_te1_`` (CLIP-L) and ``lora_te2_``
    (the projected CLIP-G)."""
    jax_pipe, port_pipe = sdxl_pipelines(tmp_path)
    w = dict(port_pipe.unet.named_parameters())
    sgm = {"input_blocks_4_1_transformer_blocks_0_attn1_to_q":
           "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q",
           "output_blocks_1_1_transformer_blocks_0_ff_net_0_proj":
           "up_blocks.0.attentions.1.transformer_blocks.0.ff.net.0.proj",
           "middle_block_1_transformer_blocks_0_attn2_to_v":
           "mid_block.attentions.0.transformer_blocks.0.attn2.to_v",
           "input_blocks_1_0_in_layers_2": "down_blocks.0.resnets.0.conv1"}
    mods = [(f"lora_unet_{m}", tuple(w[f"{n}.weight"].shape), n.endswith("conv1"))
            for m, n in sgm.items()]
    mods += [(f"lora_te{i}_text_model_encoder_layers_1_mlp_fc2", (48, 64), False)
             for i in (1, 2)]
    _apply_and_clear(jax_pipe, port_pipe, _adapter(mods, seed=46), tmp_path,
                     scheduler="DPMSolverMultistep")


def test_sd3_generation_with_peft_lora_matches_jax(tmp_path):
    """PEFT ``transformer.`` modules (joint attention, the context stream's
    FF, the AdaLN, the context embedder) and both CLIP encoders; a UNet
    adapter has no component on SD3."""
    jax_pipe, port_pipe = sd3_pipelines(tmp_path)
    w = dict(port_pipe.unet.named_parameters())
    names = ["transformer_blocks.0.attn.to_q", "transformer_blocks.1.attn.add_k_proj",
             "transformer_blocks.0.ff_context.net.2", "transformer_blocks.1.norm1.linear",
             "context_embedder"]
    mods = [(f"transformer.{n}", tuple(w[f"{n}.weight"].shape), False) for n in names]
    mods += [(f"text_encoder{s}.text_model.encoder.layers.0.self_attn.k_proj", (48, 48), False)
             for s in ("", "_2")]
    _apply_and_clear(jax_pipe, port_pipe, _adapter(mods, seed=35, fmt="peft"), tmp_path,
                     guidance_scale=4.5)
    unet_sd = _adapter([("unet.conv_in", (4, 4), False)], seed=36, fmt="peft")
    for pipe, L in ((jax_pipe, JL), (port_pipe, PL)):
        with pytest.raises(ValueError, match="no component"):
            pipe.apply_lora(L.parse_lora_state_dict(unet_sd))
