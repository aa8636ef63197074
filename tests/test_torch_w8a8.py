"""W8A8 int8 serving of the port (``ops/int8.py``, ``compress/w8a8.py``,
``enable_w8a8``) against the JAX package's, on the CPU.

- the ops: int8 weights, scales and outputs bit-equal to the JAX ops' (run
  op by op, as ``enable_w8a8`` quantizes) in float32 and bf16, dense, 3x3
  convolutions at strides 1 and 2 and the 1x1 shortcut served as dense;
  the zero padding ``torch._int_mm`` takes on the card is exact;
- calibration, the quantized layer set and the recipe against JAX on the
  tiny UNet and the tiny MMDiT, through the key translation both ways;
- what the JAX interceptor serves beyond the denoiser (a ControlNet, the
  SDXL refiner, the VAE), recorded as ROADMAP Queue 3 states it.

The pipelines (generations against JAX, staged, serving):
tests/test_torch_w8a8_pipelines.py.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch import nn as nn_torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.compress import w8a8 as jw8a8
from ml_stable_diffusion_tpu.ops import int8 as jint8

from ml_stable_diffusion_torch.compress import w8a8
from ml_stable_diffusion_torch.convert.from_jax import mmdit_state_dict, unet_state_dict
from ml_stable_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_torch.ops import int8

from helpers import CTX_DIM, randomize_params
from torch_helpers import _load, tiny_unet, traced

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
#: the JAX defaults with the upsampler skip enable_w8a8 adds for convolutions
JAX_SKIP = ("to_out_0", "upsamplers_0")
PORT_SKIP = ("to_out.0", "upsamplers.0")


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_int8_ops_bit_equal_to_jax(dt):
    tdt, jdt = DTYPES[dt]
    rng = np.random.RandomState(0)
    w = rng.randn(64, 48).astype(np.float32) * 0.1  # JAX (K, N)
    x = rng.randn(5, 7, 64).astype(np.float32) * 3
    b = rng.randn(48).astype(np.float32)
    wq, ws = jint8.quantize_weight_int8(jnp.asarray(w, jdt))
    twq, tws = int8.quantize_weight_int8(torch.from_numpy(w.T.copy()).to(tdt))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(wq).T)
    np.testing.assert_array_equal(tws.numpy().reshape(-1), np.asarray(ws).reshape(-1))
    assert tws.dtype == torch.float32
    ref = jint8.int8_dense(jnp.asarray(x, jdt), wq, ws, 2.7, bias=jnp.asarray(b, jdt))
    got = int8.int8_dense(torch.from_numpy(x).to(tdt), twq, tws, 2.7,
                          bias=torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(_f32(got), _f32(ref))
    layer = int8.Int8Linear(twq, tws, torch.from_numpy(b).to(tdt), 2.7)
    assert torch.equal(layer(torch.from_numpy(x).to(tdt)), got)
    # the activation's int8 values themselves
    xs = int8.activation_scale(2.7)
    np.testing.assert_array_equal(
        int8.quantize_activation(torch.from_numpy(x).to(tdt), xs).numpy(),
        np.asarray(jnp.clip(jnp.round(jnp.asarray(x, jdt) / xs), -127, 127).astype(jnp.int8)))

    wc = rng.randn(3, 3, 16, 32).astype(np.float32) * 0.1
    xc = rng.randn(2, 9, 10, 16).astype(np.float32) * 2
    bc = rng.randn(32).astype(np.float32)
    jwq, jws = jint8.quantize_weight_int8(jnp.asarray(wc, jdt))
    twq, tws = int8.quantize_weight_int8(torch.from_numpy(wc.transpose(3, 2, 0, 1).copy()).to(tdt))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq).transpose(3, 2, 0, 1))
    for stride in (1, 2):
        ref = jint8.int8_conv(jnp.asarray(xc, jdt), jwq, jws, 3.1, bias=jnp.asarray(bc, jdt),
                              strides=(stride, stride), padding=[(1, 1), (1, 1)])
        got = int8.int8_conv(torch.from_numpy(xc.transpose(0, 3, 1, 2).copy()).to(tdt), twq, tws,
                             3.1, bias=torch.from_numpy(bc).to(tdt), stride=stride, padding=1)
        assert got.is_contiguous()
        np.testing.assert_array_equal(_f32(got).transpose(0, 2, 3, 1), _f32(ref))
    # a 1x1 kernel: the JAX _Conv1x1 on the dense op
    w1 = rng.randn(1, 1, 16, 32).astype(np.float32)
    jwq, jws = jint8.quantize_weight_int8(jnp.asarray(w1, jdt))
    ref = jint8.int8_dense(jnp.asarray(xc, jdt), jwq[0, 0], jws, 3.0)
    twq, tws = int8.quantize_weight_int8(torch.from_numpy(w1.transpose(3, 2, 0, 1).copy()).to(tdt))
    conv = int8.Int8Conv2d(twq, tws, None, 3.0)
    got = conv(torch.from_numpy(xc.transpose(0, 3, 1, 2).copy()).to(tdt))
    np.testing.assert_array_equal(_f32(got).transpose(0, 2, 3, 1), _f32(ref))


def test_int_mm_padding_is_exact():
    """The card's ``torch._int_mm`` wants more than 16 rows and K, N
    multiples of 8: the zero-padded product, sliced, is the product (the
    padding runs on every device, so this is the card's code path)."""
    g = torch.Generator().manual_seed(0)
    for M, K, N in ((2, 64, 48), (1, 36, 20), (40, 13, 8)):
        a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
        want = a.int() @ w.int().t()
        assert torch.equal(int8.int_mm(a, w), want)


@pytest.mark.parametrize("conv_kw", [dict(groups=2), dict(dilation=2), dict(padding="same")])
def test_serving_swap_refuses_unsupported_convs(conv_kw):
    """A grouped, dilated or string-padded convolution has no int8 serving
    form: the swap raises rather than serving it wrongly."""
    m = nn_torch.Sequential(nn_torch.Conv2d(8, 8, 3, **{"padding": 1, **conv_kw}))
    q = w8a8.quantize_tree_dense_int8(m, min_size=1, include_convs=True)
    with pytest.raises(ValueError, match="unsupported"):
        w8a8.w8a8_serving_swap(m, {"0": 1.0}, q)


@functools.lru_cache(maxsize=None)
def _unet_pair():
    model, params = traced(tiny_unet)
    params = randomize_params(params, 5)
    return model, params, _load(UNet2DConditionModel, UNetConfig, model, params, unet_state_dict)


@functools.lru_cache(maxsize=None)
def _mmdit_pair():
    import test_torch_sd3 as sd3t

    model, params = sd3t._tiny_mmdit()
    params = randomize_params(params, 6)
    return model, params, _load(MMDiT, MMDiTConfig, model, params, mmdit_state_dict)


def _unet_inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 8, 8, 4).astype(np.float32), np.array([10.0, 500.0], np.float32),
            rng.randn(2, 77, CTX_DIM).astype(np.float32) * 0.5)


def _mmdit_inputs(seed):
    import test_torch_sd3 as sd3t

    rng = np.random.RandomState(seed)
    return (rng.randn(2, 8, 8, 16).astype(np.float32), np.array([10.0, 500.0], np.float32),
            rng.randn(2, 10, sd3t.MM_CTX).astype(np.float32), rng.randn(2, sd3t.POOLED)
            .astype(np.float32))


FAMILIES = {"unet": (_unet_pair, _unet_inputs), "mmdit": (_mmdit_pair, _mmdit_inputs)}


def _port_call(module, inputs):
    x, *rest = inputs
    args = [torch.from_numpy(x.transpose(0, 3, 1, 2).copy())] + [torch.from_numpy(a) for a in rest]
    with torch.no_grad():
        return module(*args)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_names_translate_both_ways(family):
    """Every Linear and Conv2d of the tiny model and of the full-width ones
    (on the meta device): the JAX path and back, and the tiny model's JAX
    kernels are exactly the translated set."""
    pair, _ = FAMILIES[family]
    model, params, port = pair()
    jax_kernels = {"/".join(k.key for k in p[:-1])
                   for p, _ in jax.tree_util.tree_leaves_with_path(params) if p[-1].key == "kernel"}
    own = {k for k, m in port.named_modules() if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))}
    assert {w8a8.jax_path(port, k) for k in own} == jax_kernels
    assert set(w8a8.port_keys({k: 1 for k in jax_kernels}, port)) == own
    with torch.device("meta"):
        full = ([UNet2DConditionModel(c) for c in (UNetConfig.sd21(), UNetConfig.sdxl(),
                                                   UNetConfig.sdxl_refiner())]
                if family == "unet" else [MMDiT(MMDiTConfig.sd3_medium())])
    for m in full:
        names = [k for k, sub in m.named_modules()
                 if isinstance(sub, (torch.nn.Linear, torch.nn.Conv2d))]
        back = w8a8.port_keys(w8a8.jax_keys({k: 0 for k in names}, m), m)
        assert sorted(back) == sorted(names)


@pytest.mark.parametrize("include_convs", [False, True], ids=["dense", "convs"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_quantized_set_matches_jax(family, include_convs):
    """``quantize_tree_dense_int8`` with the default skips: the same layers,
    the same int8 weights (float32 weights) as the JAX function's."""
    pair, _ = FAMILIES[family]
    _, params, port = pair()
    min_size = 300
    ref = jw8a8.quantize_tree_dense_int8(params, min_size=min_size, skip_patterns=JAX_SKIP,
                                         include_convs=include_convs)
    got = w8a8.quantize_tree_dense_int8(port, min_size=min_size, skip_patterns=PORT_SKIP,
                                        include_convs=include_convs)
    assert set(w8a8.jax_keys(got, port)) == set(ref)
    assert any(np.ndim(v[0]) == 4 for v in ref.values()) == include_convs
    for key, (wq, ws) in got.items():
        jwq, jws = ref[w8a8.jax_path(port, key)]
        jwq = np.asarray(jwq)
        jwq = jwq.transpose(3, 2, 0, 1) if jwq.ndim == 4 else jwq.T
        np.testing.assert_array_equal(wq.numpy(), jwq)
        np.testing.assert_array_equal(ws.numpy().reshape(-1), np.asarray(jws).reshape(-1))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_calibration_and_recipe_match_jax(family):
    """``capture_activation_scales`` over two batches: the keys (translated)
    and absmax values of the JAX capture (rel 1e-5: the forward passes agree
    to f32 rounding); ``build_w8a8_recipe`` on the same single-layer PSNRs
    skips the same layers (the class read off the JAX path: an MMDiT
    projection is held to 40 dB in both)."""
    pair, inputs = FAMILIES[family]
    model, params, port = pair()
    # two batches on the MMDiT; one on the UNet, whose eager Flax call is slow
    batches = [inputs(1), inputs(2)] if family == "mmdit" else [inputs(1)]

    def jax_apply(b):
        x, t, *rest = b
        return model.apply({"params": params}, *[jnp.asarray(a) for a in (x, t, *rest)])

    ref = jw8a8.capture_activation_scales(jax_apply, batches)
    got = w8a8.capture_activation_scales(port, lambda b: _port_call(port, b), batches)
    assert set(w8a8.jax_keys(got, port)) == set(ref)
    for key, v in got.items():
        assert v == pytest.approx(ref[w8a8.jax_path(port, key)], rel=1e-5)
    psnr = {k: 25.0 + 2.0 * (i % 10) for i, k in enumerate(sorted(got))}
    rec = w8a8.build_w8a8_recipe(psnr, got, module=port)
    jrec = jw8a8.build_w8a8_recipe({w8a8.jax_path(port, k): v for k, v in psnr.items()}, ref)
    assert sorted(w8a8.jax_path(port, k) for k in rec["skip"]) == jrec["skip"]
    assert rec["skip"] and rec["thresholds"] == jrec["thresholds"]
    # the JAX recipe's scales serve the port as they are
    assert w8a8.port_keys(jrec["act_scales"], port).keys() == got.keys()
    if family == "mmdit":  # the single-layer sweep on the port's simulation
        paths = w8a8.quantizable_dense_paths(got)[:4]
        single = w8a8.benchmark_w8a8(port, lambda ctx: _sim_call(port, ctx, batches[0]), got,
                                     paths=paths, cumulative=False)
        assert list(single) == paths and all(np.isfinite(v) for v in single.values())
        pre = w8a8.quantize_dense_weights_int8(
            lambda k: port.get_submodule(k).weight.detach(), paths)
        tree = w8a8.quantize_tree_dense_int8(port, min_size=1)
        for k in paths:
            assert all(torch.equal(a, b) for a, b in zip(pre[k], tree[k]))


def _sim_call(module, ctx, batch):
    import contextlib

    with ctx or contextlib.nullcontext():
        return _port_call(module, batch).numpy()


def _recording(inner, served):
    """``inner`` (a JAX serving interceptor) recording the module path of
    every Dense or Conv it runs as int8 (it did not call ``next_fun``)."""

    def recording(next_fun, args, kwargs, context):
        passed = []

        def nf(*a, **k):
            passed.append(True)
            return next_fun(*a, **k)

        out = inner(nf, args, kwargs, context)
        if isinstance(context.module, (nn.Dense, nn.Conv)) and not passed:
            served.add("/".join(context.module.path))
        return out
    return recording


def _other_models():
    """(base UNet kind, Flax model, its inputs, apply keywords) of the models
    the JAX pipeline runs inside its program beside the base UNet: a
    ControlNet of the UNet's config, the VAE encoder, the tiny SDXL test
    refiner (the base's widths) and one of other widths (as at full width,
    384 against 320)."""
    import test_torch_sdxl as xlt
    from ml_stable_diffusion_tpu.models.controlnet import ControlNetModel as JaxNet
    from ml_stable_diffusion_tpu.models.unet import UNet2DConditionModel as JaxUNet
    from ml_stable_diffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
    from ml_stable_diffusion_tpu.models.vae import VAEEncoder as JaxVAEEncoder

    x, t = jnp.zeros((1, 8, 8, 4)), jnp.full((1,), 10.0)
    ctx = jnp.ones((1, 77, CTX_DIM)) * 0.1
    sd_cfg, xl_cfg = _jax_unet_configs()
    added = {"text_embeds": jnp.zeros((1, xlt.POOLED)), "time_ids": jnp.zeros((1, 5))}
    ref_cfg = dataclasses.replace(xl_cfg, cross_attention_dim=CTX_DIM,
                                  projection_class_embeddings_input_dim=xlt.POOLED + 5 * 8)
    enc_cfg = JaxVAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                           norm_num_groups=4)
    return {
        "controlnet": ("sd", JaxNet(sd_cfg), (x, t, ctx, jnp.zeros((1, 64, 64, 3))), {}),
        "vae_encoder": ("sd", JaxVAEEncoder(enc_cfg), (jnp.zeros((1, 64, 64, 3)),), {}),
        "refiner_base_widths": ("sdxl", JaxUNet(ref_cfg), (x, t, ctx),
                                dict(added_cond=added)),
        "refiner_other_widths": ("sdxl", JaxUNet(dataclasses.replace(
            ref_cfg, block_out_channels=(24, 48))), (x, t, ctx), dict(added_cond=added)),
    }


def _jax_unet_configs():
    """tests/helpers.py's tiny SD and SDXL UNet configs (built abstractly)."""
    import test_torch_sdxl as xlt
    from ml_stable_diffusion_tpu.models.unet import UNetConfig as JaxUNetConfig

    base = dict(block_out_channels=(16, 32), layers_per_block=1,
                transformer_layers_per_block=(1, 1), num_attention_heads=(2, 2),
                norm_num_groups=8)
    sd = JaxUNetConfig(down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                       up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                       cross_attention_dim=CTX_DIM, **base)
    xl = JaxUNetConfig(down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                       up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
                       cross_attention_dim=xlt.XL_CTX, addition_embed_type="text_time",
                       addition_time_embed_dim=8,
                       projection_class_embeddings_input_dim=32 + 6 * 8, **base)
    return sd, xl


#: what the JAX interceptor serves of each model with the base UNet's int8
#: weights: every ControlNet layer named and shaped as the UNet's; nothing of
#: the VAE encoder; the test refiner's layers of the base's shapes; nothing of
#: a refiner of other widths
SERVED = {"controlnet": "some", "vae_encoder": "none", "refiner_base_widths": "some",
          "refiner_other_widths": "none"}


@pytest.mark.parametrize("model", list(SERVED))
def test_what_the_jax_interceptor_serves_beyond_the_denoiser(model):
    """The JAX pipeline runs its serving interceptor over its whole program
    (``_intercepted(full_run)``: the text encoders, the VAE encoder, the
    ControlNets and both UNets; the decode is a program of its own, not
    intercepted), matching layers by path and shape.  Applied here to each
    other model with the base UNet's int8 weights (``enable_w8a8(min_size=
    1)``'s): a ControlNet is served the UNet's weights, the SDXL refiner is
    kept out by its widths alone.  The port quantizes the denoiser's own
    layers only (ROADMAP Queue 3)."""
    from ml_stable_diffusion_tpu.models.unet import UNet2DConditionModel as JaxUNet

    # traced, not run (jax.eval_shape): the interceptor decides by path and
    # shape alone
    family, m, inputs, kw = _other_models()[model]
    sd_cfg, xl_cfg = _jax_unet_configs()
    base = JaxUNet(sd_cfg if family == "sd" else xl_cfg)
    base_kw = ({} if family == "sd" else dict(added_cond={
        "text_embeds": jnp.zeros((1, 32)), "time_ids": jnp.zeros((1, 6))}))
    ctx = jnp.zeros((1, 77, base.config.cross_attention_dim))
    base_p = jax.eval_shape(lambda: base.init(jax.random.key(1), jnp.zeros((1, 8, 8, 4)),
                                              jnp.zeros((1,)), ctx, **base_kw))["params"]
    params = jax.eval_shape(lambda: m.init(jax.random.key(2), *inputs, **kw))["params"]
    served = set()

    def run(base_p, params):
        int8_w = jw8a8.quantize_tree_dense_int8(base_p, min_size=1,
                                                skip_patterns=jw8a8.DEFAULT_SKIP_PATTERNS)
        with nn.intercept_methods(_recording(jw8a8.w8a8_serving_interceptor(
                jw8a8.ConstantScales(), int8_w), served)):
            m.apply({"params": params}, *inputs, **kw)
        return {k: v[0] for k, v in int8_w.items()}

    int8_w = jax.eval_shape(run, base_p, params)
    assert served <= set(int8_w)
    assert bool(served) == (SERVED[model] == "some"), sorted(served)[:5]
    if model == "controlnet":  # every shared down/mid layer of the net
        assert {p for p in int8_w if p.startswith(("down_blocks", "mid_block", "time_emb"))} \
            <= served
