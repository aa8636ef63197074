"""The port's training step, its checkpoint and its data-parallel gradients
against the JAX package, on the CPU in float32.

The tiny JAX UNet of tests/helpers.py gets seeded weights, which
``flax_params_to_diffusers_sd`` carries into the port's UNet (and maps the
JAX gradients onto the port's parameter names).  The draws are JAX's own:
``jax.random.split`` of the batch key, ``randint`` and ``normal``, as
``ml_stable_diffusion_tpu/parallel/train.py:62-64`` makes them inside its
step; the port's step takes them as ``t`` and ``noise``.  Tolerances: the
loss rtol 1e-5, each gradient a relative RMS of 1e-4, parameters after one
optimizer step 1e-5 abs.  The data-parallel step runs in two processes on
gloo (tests/torch_dp_worker.py).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ml_stable_diffusion_tpu.parallel import batch_sharding, make_mesh
from ml_stable_diffusion_tpu.parallel import make_train_step as jax_make_train_step
from ml_stable_diffusion_tpu.schedulers.base import SchedulerConfig as JaxSchedulerConfig

from ml_stable_diffusion_torch.models.unet import UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_torch.ops import attention
from ml_stable_diffusion_torch.ops.flash_attention import (
    flash_attention_cuda,
    flash_attention_multi_q_cuda,
    flash_attention_wide_f32_cuda,
)
from ml_stable_diffusion_torch.ops.groupnorm import group_norm_silu_cuda
from ml_stable_diffusion_torch.ops.palettized import palettized_dense_fused_cuda
from ml_stable_diffusion_torch.parallel import (
    adamw,
    epsilon_mse,
    make_train_step,
    restore_train_state,
    save_train_state,
    sgd,
)
from ml_stable_diffusion_torch.schedulers.base import SchedulerConfig

from helpers import CTX_DIM, flax_params_to_diffusers_sd, randomize_params
from torch_helpers import tiny_unet, traced

LR = 1e-3
B = 4
TESTS = Path(__file__).resolve().parent


def _rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def _to_torch(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _jax_loss(model):
    """The loss of JAX ``parallel/train.py:60-75`` on given draws."""
    acp = jnp.asarray(JaxSchedulerConfig().alphas_cumprod(), jnp.float32)

    def loss_fn(params, latents, context, t, noise):
        a = acp[t][:, None, None, None]
        noisy = jnp.sqrt(a) * latents + jnp.sqrt(1 - a) * noise
        pred = model.apply({"params": params}, noisy, t.astype(jnp.float32), context)
        return jnp.mean((pred - noise) ** 2)

    return loss_fn


def _optax_step(opt, params, grads):
    @jax.jit
    def step(params, grads):
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates)

    return flax_params_to_diffusers_sd(step(params, grads), "unet")


@pytest.fixture(scope="module")
def ref():
    """The tiny UNet, its weights, one batch of 4 with JAX's draws, the JAX
    loss and gradients on them, one optax SGD and AdamW update from those
    gradients, and the JAX package's own SGD step over ``make_mesh(8,
    dp=2)``, which draws the same ``t`` and noise from the batch key."""
    model, params = traced(tiny_unet)
    params = randomize_params(params, seed=11, scale=0.1)
    rng = np.random.RandomState(0)
    latents = rng.randn(B, 8, 8, 4).astype(np.float32)
    context = rng.randn(B, 77, CTX_DIM).astype(np.float32)
    key = jax.random.key(7)
    k1, k2 = jax.random.split(key)
    t = jax.random.randint(k1, (B,), 0, JaxSchedulerConfig().num_train_timesteps)
    noise = jax.random.normal(k2, latents.shape, jnp.float32)
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss(model)))(params, latents, context, t,
                                                                noise)
    mesh = make_mesh(8, dp=2)
    init_fn, step_fn = jax_make_train_step(model, optax.sgd(LR), mesh)
    state, mesh_loss = step_fn(init_fn(params), {
        "latents": jax.device_put(jnp.asarray(latents), batch_sharding(mesh, 4)),
        "context": jax.device_put(jnp.asarray(context), batch_sharding(mesh, 3)),
        "rng": key})
    port = UNet2DConditionModel(UNetConfig(**dataclasses.asdict(model.config)))
    sd = flax_params_to_diffusers_sd(params, "unet")
    port.load_state_dict(_to_torch(sd), strict=True)
    return dict(port=port, sd=sd, latents=latents, context=context, t=np.asarray(t),
                noise=np.asarray(noise), loss=float(loss),
                grads=flax_params_to_diffusers_sd(grads, "unet"),
                optax={"sgd": _optax_step(optax.sgd(LR), params, grads),
                       "adamw": _optax_step(optax.adamw(LR), params, grads)},
                mesh_step=(float(mesh_loss), flax_params_to_diffusers_sd(state.params, "unet")))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _port_batch(ref, rows=slice(None)):
    return {"latents": _nchw(ref["latents"][rows]),
            "context": torch.from_numpy(ref["context"][rows]),
            "t": torch.from_numpy(ref["t"][rows]).long(),
            "noise": _nchw(ref["noise"][rows])}


def _port_loss_and_grads(ref, remat=False):
    port = ref["port"]
    port.zero_grad(set_to_none=True)
    b = _port_batch(ref)
    acp = torch.as_tensor(SchedulerConfig().alphas_cumprod(), dtype=torch.float32)
    loss = epsilon_mse(port, b["latents"], b["context"], b["t"], b["noise"], acp, remat=remat)
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in port.named_parameters()}


def test_loss_and_gradients_match_jax(ref):
    # the loss restated in _jax_loss is the JAX step's own, on the same draws
    np.testing.assert_allclose(ref["loss"], ref["mesh_step"][0], rtol=1e-5)
    loss, grads = _port_loss_and_grads(ref)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    want = ref["grads"]
    assert set(grads) == set(want)
    worst = max((_rel_rms(grads[k], want[k]), k) for k in want)
    assert worst[0] <= 1e-4, worst


def test_remat_matches_no_remat(ref):
    loss, grads = _port_loss_and_grads(ref)
    loss_r, grads_r = _port_loss_and_grads(ref, remat=True)
    assert torch.equal(loss, loss_r)
    for k in grads:
        assert torch.equal(grads[k], grads_r[k]), k


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_one_step_matches_optax(ref, name):
    init_fn, step_fn = make_train_step(ref["port"], {"sgd": sgd, "adamw": adamw}[name](LR),
                                       device="cpu")
    state, loss = step_fn(init_fn(), _port_batch(ref))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    assert state.step == 1
    want = ref["optax"][name]
    for k, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0, atol=1e-5, err_msg=k)


def test_adamw_takes_optax_defaults():
    opt = adamw(LR)([torch.nn.Parameter(torch.zeros(1))])
    group = opt.param_groups[0]
    assert (group["weight_decay"], group["eps"], group["betas"]) == (1e-4, 1e-8, (0.9, 0.999))


@pytest.fixture(scope="module")
def dp_run(ref, tmp_path_factory):
    """Two gloo processes, each on half of the batch: one SGD step on JAX's
    draws and one on draws from a seeded generator."""
    d = tmp_path_factory.mktemp("dp")
    torch.save({k: torch.from_numpy(v) for k, v in ref["sd"].items()}, d / "weights.pt")
    torch.save({k: v for k, v in _port_batch(ref).items()}, d / "batch.pt")
    (d / "config.json").write_text(json.dumps(dataclasses.asdict(ref["port"].config)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(TESTS.parent), str(TESTS)])}
    logs = [open(d / f"rank{rank}.log", "w") for rank in range(2)]
    procs = [subprocess.Popen([sys.executable, str(TESTS / "torch_dp_worker.py"), str(d),
                               str(rank), "2", str(LR)], env=env, cwd=TESTS.parent,
                              stdout=log, stderr=subprocess.STDOUT)
             for rank, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p, log in zip(procs, logs):
            p.kill()
            p.wait()
            log.close()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (d / f"rank{rank}.log").read_text()
    return {mode: torch.load(d / f"{mode}_rank0.pt", weights_only=True)
            for mode in ("draws", "generator")}


def test_data_parallel_step_matches_full_batch_and_jax(ref, dp_run):
    init_fn, step_fn = make_train_step(ref["port"], sgd(LR), device="cpu")
    full, loss = step_fn(init_fn(), _port_batch(ref))
    got = dp_run["draws"]
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-6)
    np.testing.assert_allclose(float(got["loss"]), ref["mesh_step"][0], rtol=1e-5)
    jax_params = ref["mesh_step"][1]
    for k, p in full.params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), p.detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["params"][k].numpy(), jax_params[k], rtol=0,
                                   atol=1e-5, err_msg=k)


def test_data_parallel_generator_draws_match_full_batch(ref, dp_run):
    """Each rank draws the global batch's t and noise from a generator seeded
    alike and takes its share, as JAX draws on the batch key and shards."""
    init_fn, step_fn = make_train_step(ref["port"], sgd(LR), device="cpu")
    b = _port_batch(ref)
    batch = {"latents": b["latents"], "context": b["context"],
             "generator": torch.Generator().manual_seed(3)}
    full, loss = step_fn(init_fn(), batch)
    got = dp_run["generator"]
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-6)
    for k, p in full.params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), p.detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_checkpoint_round_trip_is_bit_equal(ref, tmp_path):
    init_fn, step_fn = make_train_step(ref["port"], adamw(LR), device="cpu")
    state, _ = step_fn(init_fn(), _port_batch(ref))
    save_train_state(tmp_path / "ckpt", state)
    restored = restore_train_state(tmp_path / "ckpt", init_fn())
    assert restored.step == 1
    for k, p in state.params.items():
        assert torch.equal(restored.params[k], p), k
    live, back = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert live["param_groups"] == back["param_groups"]
    for i, s in live["state"].items():
        for name, x in s.items():
            assert torch.equal(back["state"][i][name], x), (i, name)
    # the restored state serves further steps as the live one does
    _, loss = step_fn(state, _port_batch(ref))
    _, loss_back = step_fn(restored, _port_batch(ref))
    assert torch.equal(loss, loss_back) and np.isfinite(float(loss))
    for k, p in state.params.items():
        assert torch.equal(restored.params[k], p), k


def test_step_takes_added_conditioning_and_restores_attention(ref):
    calls = []

    def added(batch_size):
        calls.append(batch_size)
        return None

    init_fn, step_fn = make_train_step(ref["port"], sgd(LR), added_cond_fn=added, device="cpu")
    before = attention.ATTENTION_IMPLEMENTATION_IN_EFFECT
    attention.set_attention_implementation("flash")
    try:
        _, loss = step_fn(init_fn(), _port_batch(ref))
        assert attention.ATTENTION_IMPLEMENTATION_IN_EFFECT == attention.AttentionImpl.FLASH
    finally:
        attention.set_attention_implementation(before)
    assert calls == [B]
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)


def test_step_refuses_the_fused_groupnorm_model(ref):
    cfg = dataclasses.replace(ref["port"].config, fused_groupnorm=True)
    with pytest.raises(ValueError, match="fused_groupnorm=False"):
        make_train_step(UNet2DConditionModel(cfg), sgd(LR), device="cpu")


def _wrapper_calls():
    q = torch.randn(1, 256, 2, 64)
    qs = [torch.randn(1, 32, 2, 512)]
    k = torch.randn(1, 256, 2, 64)
    x = torch.randn(1, 32, 4, 4)
    gamma, beta = torch.ones(32), torch.zeros(32)
    xp, idx, lut = torch.randn(4, 16), torch.zeros(8, 8, dtype=torch.uint8), torch.randn(4)
    return {
        "flash_attention_cuda": (flash_attention_cuda, (q, k, k)),
        "flash_attention_multi_q_cuda": (flash_attention_multi_q_cuda, ([q], k, k)),
        "flash_attention_wide_f32_cuda": (flash_attention_wide_f32_cuda,
                                          (qs, torch.randn(1, 32, 2, 512),
                                           torch.randn(1, 32, 2, 512))),
        "group_norm_silu_cuda": (group_norm_silu_cuda, (x, gamma, beta)),
        "palettized_dense_fused_cuda": (palettized_dense_fused_cuda, (xp, idx, lut, (16, 4))),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_kernel_wrappers_refuse_grad(name):
    """A wrapper fills ``torch.empty`` through ctypes: with grad mode on and
    an input that requires grad it raises, naming the plain path; the same
    call without grad goes on to its usual checks (here: CUDA only)."""
    fn, args = _wrapper_calls()[name]
    first = args[0][0] if isinstance(args[0], list) else args[0]
    first.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward.*plain|no backward.*palettized_dense"):
        fn(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(*args)
    assert fn.launches == 0
