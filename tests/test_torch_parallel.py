"""The port's tensor and spatial parallelism against the JAX package's, on
the CPU in float32.

Four gloo processes (tests/torch_parallel_worker.py, one spawn) run every
mode on the meshes (dp, tp) = (1, 4) and (2, 2); the JAX side runs in this
process on the conftest's 8 virtual CPU devices.

- ``make_mesh``: the shapes and errors of the same calls as JAX's.
- The rules: ``param_sharding_rules`` of the tiny UNet (SD and XL), CLIP,
  VAE decoder and encoder, ControlNet, safety ViT, MMDiT and T5 at tp = 4
  equal JAX's leaf for leaf, with the layouts translated (a Dense kernel
  transposed, HWIO to OIHW, the (M, M, D) positional table to (1, M·M, D)).
  Port keys are paired with Flax leaves by converting a tree whose leaves
  hold distinct values.
- The tensor-sharded UNet forward (tp = 4, and dp = tp = 2, where the
  attentions and feed-forwards run the megatron pair) against JAX's
  ``make_tensor_sharded_forward`` on ``make_mesh(4)``; the spatial forward
  (dp = tp = 2 and tp = 4, H = 16) with each GroupNorm+SiLU mode against
  JAX's unsharded forward; the T5 encoder at tp = 4 against JAX's.
- ``pipe.shard(mesh)`` on the SD (with a ControlNet and the safety
  checker), SDXL and SD3 pipelines (2 steps) against the port's
  unsharded generation and JAX's.

Tolerance: rtol = atol = 2e-4 in float32, as JAX's own sharded tests hold
their sharded outputs to the unsharded ones (tests/test_parallel.py).  The
pipelines are held to the port's unsharded latents at that tolerance and to
JAX's at atol 1e-3, the tolerance of the unsharded pipeline tests (the
recorded sin/cos divergence of the timestep embedding).  Every rank's result
equals rank 0's bit for bit.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch.distributed.tensor import Replicate, Shard

from ml_stable_diffusion_tpu.models.mmdit import MMDiT as JaxMMDiT
from ml_stable_diffusion_tpu.models.mmdit import MMDiTConfig as JaxMMDiTConfig
from ml_stable_diffusion_tpu.models.safety import SafetyChecker as JaxSafetyChecker
from ml_stable_diffusion_tpu.models.t5 import T5Config as JaxT5Config
from ml_stable_diffusion_tpu.models.t5 import T5Encoder as JaxT5Encoder
from ml_stable_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from ml_stable_diffusion_tpu.parallel import make_tensor_sharded_forward as jax_tensor_forward
from ml_stable_diffusion_tpu.parallel import param_sharding_rules as jax_rules
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig

from ml_stable_diffusion_torch.convert.from_jax import (
    clip_text_state_dict,
    controlnet_state_dict,
    mmdit_state_dict,
    safety_checker_state_dict,
    t5_state_dict,
    unet_state_dict,
    vae_decoder_state_dict,
    vae_encoder_state_dict,
)
from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from ml_stable_diffusion_torch.models.controlnet import ControlNetModel
from ml_stable_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
from ml_stable_diffusion_torch.models.safety import SafetyChecker, SafetyCheckerConfig
from ml_stable_diffusion_torch.models.t5 import T5Config, T5Encoder
from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEDecoder, VAEEncoder
from ml_stable_diffusion_torch.parallel import make_mesh
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

from helpers import randomize_params
from test_torch_controlnet import _cond, _controlnet
from test_torch_safety import TINY_SAFETY, _checker
from torch_helpers import (
    _load,
    pipelines,
    sd3_pipelines,
    sdxl_pipelines,
    tiny_text_encoder,
    tiny_unet,
    tiny_vae,
    traced,
)

TESTS = Path(__file__).resolve().parent
WORLD = 4
TOL = dict(rtol=2e-4, atol=2e-4)
HW = (64, 64)
#: the make_mesh calls of JAX's test_make_mesh_shapes, on four ranks
MESH_CALLS = ((None, None, None), (4, 2, None), (4, None, 1), (4, 3, None))
MMDIT = dict(patch_size=2, in_channels=4, out_channels=4, depth=2, hidden_size=32,
             num_heads=4, context_dim=64, pooled_dim=32, pos_embed_max_size=8)
T5 = dict(vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)


def _rule_models():
    """name -> (Flax module, abstract params, port class, port config class,
    state-dict converter) of every tiny model the rules are held on."""
    (dec, dp), (enc, ep) = traced(tiny_vae)
    mm = JaxMMDiT(JaxMMDiTConfig(**MMDIT))
    t5 = JaxT5Encoder(JaxT5Config(**T5))
    safety = JaxSafetyChecker(TINY_SAFETY)
    net, net_p = _controlnet(61)
    return {
        "unet": (*traced(tiny_unet), UNet2DConditionModel, UNetConfig, unet_state_dict),
        "unet_xl": (*traced(tiny_unet, cross_dim=96, xl=True), UNet2DConditionModel,
                    UNetConfig, unet_state_dict),
        "clip": (*traced(tiny_text_encoder, use_projection=True), CLIPTextEncoder,
                 CLIPTextConfig, clip_text_state_dict),
        "vae_decoder": (dec, dp, VAEDecoder, VAEConfig, vae_decoder_state_dict),
        "vae_encoder": (enc, ep, VAEEncoder, VAEConfig, vae_encoder_state_dict),
        "controlnet": (net, net_p, ControlNetModel, UNetConfig, controlnet_state_dict),
        "safety": (safety, jax.eval_shape(safety.init, jax.random.key(0),
                                          jnp.zeros((1, 32, 32, 3)))["params"],
                   SafetyChecker, SafetyCheckerConfig, safety_checker_state_dict),
        "mmdit": (mm, jax.eval_shape(mm.init, jax.random.key(0), jnp.zeros((1, 8, 8, 4)),
                                     jnp.zeros((1,)), jnp.zeros((1, 6, 64)),
                                     jnp.zeros((1, 32)))["params"],
                  MMDiT, MMDiTConfig, mmdit_state_dict),
        "t5": (t5, jax.eval_shape(t5.init, jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
               ["params"], T5Encoder, T5Config, t5_state_dict),
    }


def _port_placement(spec, leaf_name: str, ndim: int) -> str:
    """A JAX PartitionSpec of a Flax leaf -> the port placement of the same
    tensor in torch layout."""
    axes = [i for i, a in enumerate(spec) if a == "tp"]
    if not axes:
        return repr(Replicate())
    a = axes[0]
    if leaf_name == "kernel":
        a = 1 - a if ndim == 2 else {3: 0, 2: 1, 0: 2, 1: 3}[a]
    return repr(Shard(a))


def _tagged_rules(model, params, cls, cfg_cls, convert):
    """-> (the port module on a tree whose leaf i holds i + 1, {port key:
    the JAX rule translated to the port's layout})."""
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    tagged = jax.tree_util.tree_unflatten(
        tree, [np.full(leaf.shape, i + 1, np.float32) for i, (_, leaf) in enumerate(leaves)])
    specs = jax.tree_util.tree_leaves(jax_rules(tagged, jax_make_mesh(WORLD, dp=1)))
    module = _load(cls, cfg_cls, model, tagged, convert)
    want = {}
    for key, tensor in module.state_dict().items():
        i = int(tensor.flatten()[0].item()) - 1
        path, leaf = leaves[i]
        want[key] = _port_placement(specs[i].spec, path[-1].key, leaf.ndim)
    return module, want


def _jax_tensor_forward(model, params, sample, t, ctx):
    placed, fwd = jax_tensor_forward(model, jax_make_mesh(WORLD, dp=1), params)
    return np.asarray(fwd(placed, sample, t, ctx))


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()


def _gen(**kw):
    out = dict(prompt="a cat", negative_prompt="blurry", step_count=2, seed=7,
               disable_safety=True, rng="numpy")
    out.update(kw)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX references, the port's unsharded pipelines, and the results
    of the four ranks."""
    d = tmp_path_factory.mktemp("parallel")
    ref = {"mesh_calls": []}
    inputs = {"hw": HW, "rules": {}, "pipes": {},
              "mesh_calls": MESH_CALLS + ((2 * WORLD, None, None),)}
    for n, dp, tp in MESH_CALLS + ((2 * len(jax.devices()), None, None),):
        try:
            ref["mesh_calls"].append(dict(jax_make_mesh(n or WORLD, dp=dp, tp=tp).shape))
        except ValueError:
            ref["mesh_calls"].append("ValueError")
    ref["want_rules"] = {}
    for name, args in _rule_models().items():
        inputs["rules"][name], ref["want_rules"][name] = _tagged_rules(*args)

    model, params = traced(tiny_unet)
    params = randomize_params(params, 21)
    rs = np.random.RandomState(0)
    sample = jnp.asarray(rs.randn(2, 16, 8, 4), jnp.float32)
    t = jnp.asarray([10.0, 500.0])
    ctx = jnp.asarray(rs.randn(2, 77, 48), jnp.float32)
    ref["tensor"] = _jax_tensor_forward(model, params, sample, t, ctx)
    ref["unsharded"] = np.asarray(jax.jit(lambda p, *a: model.apply({"params": p}, *a))(
        params, sample, t, ctx))
    inputs["unet"] = _load(UNet2DConditionModel, UNetConfig, model, params, unet_state_dict)
    inputs.update(x=_nchw(sample), t=torch.from_numpy(np.array(t)),
                  ctx=torch.from_numpy(np.array(ctx)))

    t5 = JaxT5Encoder(JaxT5Config(**T5))
    ids = rs.randint(3, 90, (2, 8)).astype(np.int32)
    mask = np.asarray([[1] * 8, [1] * 5 + [0] * 3], np.int32)
    t5_params = randomize_params(
        jax.eval_shape(t5.init, jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask))
        ["params"], 22)
    ref["t5"] = np.asarray(t5.apply({"params": t5_params}, ids, mask)["encoder_hidden_states"])
    inputs.update(t5=_load(T5Encoder, T5Config, t5, t5_params, t5_state_dict),
                  t5_ids=torch.from_numpy(ids).long(), t5_mask=torch.from_numpy(mask))

    cond = _cond(3)
    cases = {
        "sd": (pipelines(d, weight_seed=11, controlnets=[_controlnet(62)],
                         safety_checker=_checker()), "tp4",
               _gen(controlnet_inputs=[cond], disable_safety=False)),
        "sdxl": (sdxl_pipelines(d), "dp2tp2", _gen(scheduler="DDIM", guidance_scale=5.0)),
        "sd3": (sd3_pipelines(d), "tp4", _gen(guidance_scale=4.5)),
    }
    for name, ((jax_pipe, port_pipe), mesh_name, kw) in cases.items():
        inputs["pipes"][name] = (port_pipe, mesh_name, kw)
    torch.save(inputs, d / "inputs.pt")  # the pipelines before they generate
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(TESTS.parent), str(TESTS)])}
    logs = [open(d / f"rank{rank}.log", "w") for rank in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(TESTS / "torch_parallel_worker.py"), str(d),
                               str(rank), str(WORLD)], env=env, cwd=TESTS.parent,
                              stdout=log, stderr=subprocess.STDOUT)
             for rank, log in enumerate(logs)]
    try:
        # the references while the ranks run
        for name, ((jax_pipe, port_pipe), _, kw) in cases.items():
            ref[f"jax_{name}"] = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW).latents
            ref[f"port_{name}"] = port_pipe.generate_images(PipelineConfiguration(**kw),
                                                            image_hw=HW).latents
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p, log in zip(procs, logs):
            p.kill()
            p.wait()
            log.close()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (d / f"rank{rank}.log").read_text()
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ref, ranks


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(np.asarray(r[key]), np.asarray(ranks[0][key]), err_msg=key)
    return np.asarray(ranks[0][key])


def test_make_mesh_shapes_and_errors_match_jax(run):
    ref, ranks = run
    assert ranks[0]["mesh_calls"] == ref["mesh_calls"]
    assert ref["mesh_calls"][:3] == [{"dp": 1, "tp": 4}, {"dp": 2, "tp": 2}, {"dp": 4, "tp": 1}]
    with pytest.raises(RuntimeError, match="torch.distributed initialised"):
        make_mesh(device_type="cpu")  # this process has no process group


@pytest.mark.parametrize("name", ["unet", "unet_xl", "clip", "vae_decoder", "vae_encoder",
                                  "controlnet", "safety", "mmdit", "t5"])
def test_rules_equal_jax_leaf_for_leaf(run, name):
    ref, ranks = run
    got, want = ranks[0]["rules"][name], ref["want_rules"][name]
    assert got == want
    assert any(p != repr(Replicate()) for p in got.values()), name


def test_sharded_layers_report_their_rules(run):
    """A sharded module's rules are the unsharded one's, read off the
    installed layers (the paired GEGLU keeps both halves' rows: Shard(0))."""
    ref, ranks = run
    want = ref["want_rules"]["unet"]
    for mesh_name in ("tp4", "dp2tp2"):
        got = ranks[0][f"sharded_rules_{mesh_name}"]
        assert got.keys() == want.keys()
        if mesh_name == "tp4":
            assert got == want


@pytest.mark.parametrize("mesh", ["tp4", "dp2tp2"])
def test_tensor_sharded_forward_matches_jax(run, mesh):
    ref, ranks = run
    got = _same_on_every_rank(ranks, f"tensor_{mesh}")
    np.testing.assert_allclose(got, np.transpose(ref["tensor"], (0, 3, 1, 2)), **TOL)


@pytest.mark.parametrize("gn", ["plain", "lowmem", "fused"])
@pytest.mark.parametrize("mesh", ["tp4", "dp2tp2"])
def test_spatial_sharded_forward_matches_jax(run, mesh, gn):
    ref, ranks = run
    got = _same_on_every_rank(ranks, f"spatial_{gn}_{mesh}")
    np.testing.assert_allclose(got, np.transpose(ref["unsharded"], (0, 3, 1, 2)), **TOL)


def test_spatial_forward_refuses_uneven_rows(run):
    _, ranks = run
    assert "must be a multiple of 8" in ranks[0]["uneven_rows"]


def test_sharded_t5_matches_jax(run):
    ref, ranks = run
    np.testing.assert_allclose(_same_on_every_rank(ranks, "t5"), ref["t5"], **TOL)


@pytest.mark.parametrize("name", ["sd", "sdxl", "sd3"])
def test_sharded_pipeline_matches_unsharded_and_jax(run, name):
    ref, ranks = run
    got = _same_on_every_rank(ranks, f"pipe_{name}")
    np.testing.assert_allclose(got, ref[f"port_{name}"], **TOL)
    np.testing.assert_allclose(got, ref[f"jax_{name}"], atol=1e-3)


def test_shard_refuses_what_it_cannot_split(tmp_path):
    """An offloaded pipeline is not sharded, and a sharded one takes no
    weight-changing adapter."""
    _, pipe = pipelines(tmp_path, weight_seed=11)
    pipe.offload_params_to_host()
    with pytest.raises(RuntimeError, match="offloaded"):
        pipe.shard(None)
    pipe._host_weights = {}
    pipe.mesh = object()  # as shard leaves it
    for call in (lambda: pipe.apply_lora(None), pipe.clear_loras,
                 lambda: pipe.enable_w8a8(), lambda: pipe.install_palettized("unet", {}),
                 lambda: pipe.load_ip_adapter(None, None)):
        with pytest.raises(RuntimeError, match="before shard"):
            call()
    with pytest.raises(RuntimeError, match="sharded already"):
        pipe.shard(None)
