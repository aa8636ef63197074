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

The tensor-parallel step (``make_train_step(..., mesh)``) runs in four gloo
processes (tests/torch_tp_worker.py, one spawn) on the meshes (dp, tp) =
(1, 4) and (2, 2), as tests/test_torch_parallel.py names them: the tiny
UNet's 2 heads take the generic column/row form at tp = 4 and the paired
attention at tp = 2.  Its gathered gradients are held to JAX's at a
relative RMS of 1e-4 (a gradient scaled by tp fails it), its SGD step to
JAX's on ``make_mesh(8, dp=2)`` as the data-parallel one is and to the
port's unsharded step at 1e-6 abs; remat, the replicated parameters across
tp ranks and the checkpoint round trips bit for bit; each sharded layer's
gradients to unsharded autograd at rtol 1e-5 and an atol of 1e-6 of the
tensor's largest magnitude (float32 sums in another order).
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
    full_state_dict,
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


def _spawn(worker: str, d: Path, world: int, timeout: int):
    """``world`` ranks of ``worker`` on ``d``; each rank's log in the failure."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(TESTS.parent), str(TESTS)])}
    logs = [open(d / f"rank{rank}.log", "w") for rank in range(world)]
    procs = [subprocess.Popen([sys.executable, str(TESTS / worker), str(d), str(rank),
                               str(world), str(LR)], env=env, cwd=TESTS.parent,
                              stdout=log, stderr=subprocess.STDOUT)
             for rank, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in zip(procs, logs):
            p.kill()
            p.wait()
            log.close()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (d / f"rank{rank}.log").read_text()


@pytest.fixture(scope="module")
def dp_run(ref, tmp_path_factory):
    """Two gloo processes, each on half of the batch: one SGD step on JAX's
    draws and one on draws from a seeded generator."""
    d = tmp_path_factory.mktemp("dp")
    torch.save({k: torch.from_numpy(v) for k, v in ref["sd"].items()}, d / "weights.pt")
    torch.save({k: v for k, v in _port_batch(ref).items()}, d / "batch.pt")
    (d / "config.json").write_text(json.dumps(dataclasses.asdict(ref["port"].config)))
    _spawn("torch_dp_worker.py", d, 2, timeout=120)
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


def _moments(state) -> dict:
    return {kind: {k: state.optimizer.state[p][kind] for k, p in state.params.items()}
            for kind in ("exp_avg", "exp_avg_sq")}


TP_MESHES = ["tp4", "dp2tp2"]


@pytest.fixture(scope="module")
def tp_run(ref, tmp_path_factory):
    """Four gloo ranks on each mesh (tests/torch_tp_worker.py), and the
    port's unsharded steps they are held to: SGD on JAX's draws and on a
    generator seeded 3, and one AdamW step saved as a checkpoint."""
    d = tmp_path_factory.mktemp("tp")
    torch.save({k: torch.from_numpy(v) for k, v in ref["sd"].items()}, d / "weights.pt")
    torch.save(_port_batch(ref), d / "batch.pt")
    (d / "config.json").write_text(json.dumps(dataclasses.asdict(ref["port"].config)))
    init_fn, step_fn = make_train_step(ref["port"], adamw(LR), device="cpu")
    adamw_state, _ = step_fn(init_fn(), _port_batch(ref))
    save_train_state(d / "unsharded_ckpt", adamw_state)
    init_fn, step_fn = make_train_step(ref["port"], sgd(LR), device="cpu")
    b = _port_batch(ref)
    sgd_state, sgd_loss = step_fn(init_fn(), b)
    gen_state, gen_loss = step_fn(init_fn(), {"latents": b["latents"], "context": b["context"],
                                              "generator": torch.Generator().manual_seed(3)})
    _spawn("torch_tp_worker.py", d, 4, timeout=240)
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=True) for r in range(4)]
    return dict(dir=d, ranks=ranks, adamw=adamw_state,
                sgd=(sgd_loss, {k: p.detach() for k, p in sgd_state.params.items()}),
                generator=(gen_loss, {k: p.detach() for k, p in gen_state.params.items()}))


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tp_gradients_match_jax(ref, tp_run, mesh):
    """The gradients gathered over tp (and averaged over dp) are the full
    batch's, not tp times them."""
    got, want = tp_run["ranks"][0][mesh]["grads"], ref["grads"]
    assert set(got) == set(want)
    worst = max((_rel_rms(got[k], want[k]), k) for k in want)
    assert worst[0] <= 1e-4, worst


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tp_sgd_step_matches_jax_mesh_step_and_unsharded(ref, tp_run, mesh):
    res = tp_run["ranks"][0][mesh]
    np.testing.assert_allclose(float(res["loss"]), ref["mesh_step"][0], rtol=1e-5)
    for r in tp_run["ranks"][1:]:
        assert torch.equal(r[mesh]["loss"], res["loss"])
    full_loss, full = tp_run["sgd"]
    np.testing.assert_allclose(float(res["loss"]), float(full_loss), rtol=1e-6)
    jax_params = ref["mesh_step"][1]
    for k, p in full.items():
        got = res["params"][k].numpy()
        np.testing.assert_allclose(got, jax_params[k], rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got, p.numpy(), rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tp_generator_draws_match_full_batch(tp_run, mesh):
    """Each dp row draws the global batch's t and noise and takes its share;
    the tp ranks of a row take the same one."""
    res = tp_run["ranks"][0][mesh]
    full_loss, full = tp_run["generator"]
    np.testing.assert_allclose(float(res["generator_loss"]), float(full_loss), rtol=1e-6)
    for k, p in full.items():
        np.testing.assert_allclose(res["generator_params"][k].numpy(), p.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tp_remat_is_bit_equal(tp_run, mesh):
    """remat runs the forward's collectives again inside the backward, in one
    order on every rank: the step's loss and parameters bit-equal."""
    res = tp_run["ranks"][0][mesh]
    assert torch.equal(res["remat_loss"], res["loss"])
    assert res["remat_equal"]


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tp_adamw_keeps_replicated_parameters_equal(tp_run, mesh):
    """Two AdamW steps on one batch: the loss falls, and every parameter the
    rules replicate (norms, row layers' and convs' biases, small convs) is
    bit-equal on all four ranks."""
    ranks = [r[mesh] for r in tp_run["ranks"]]
    losses = ranks[0]["adamw_losses"]
    assert losses[1] < losses[0], losses
    rep = ranks[0]["replicated"]
    assert any(k.endswith("bias") and "conv" in k for k in rep), sorted(rep)
    for r, res in enumerate(ranks[1:], 1):
        assert res["adamw_losses"] == losses
        assert res["replicated"].keys() == rep.keys()
        for k, p in rep.items():
            assert torch.equal(res["replicated"][k], p), (r, k)


#: each sharded layer and the differentiable collectives its backward runs
LAYER_COLLECTIVES = {"column": ("copy", "gather"), "row": ("scatter", "reduce"),
                     "pair": ("copy", "reduce"), "conv": ("copy", "gather"),
                     "embedding": ("gather",)}


@pytest.mark.parametrize("layer", sorted(LAYER_COLLECTIVES))
@pytest.mark.parametrize("mesh", TP_MESHES)
def test_sharded_layer_gradients_match_unsharded(tp_run, mesh, layer):
    """Output, input gradient and whole parameter gradients of each sharded
    layer against unsharded autograd on the same module and upstream
    gradient (the pair is a GEGLU FeedForward: its rows in both halves)."""
    assert {c for cs in LAYER_COLLECTIVES.values() for c in cs} == {
        "copy", "reduce", "gather", "scatter"}
    runs = tp_run["ranks"][0][mesh]["layers"][layer]
    got, want = runs["sharded"], runs["unsharded"]

    def close(a, b, what):
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6 * np.abs(b).max(),
                                   err_msg=what)

    close(got["y"], want["y"], "y")
    if layer == "embedding":
        assert got["x_grad"] is None and want["x_grad"] is None
    else:
        close(got["x_grad"], want["x_grad"], "x_grad")
    assert got["grads"].keys() == want["grads"].keys()
    for k, g in want["grads"].items():
        close(got["grads"][k], g, k)


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_tp_checkpoint_round_trips(ref, tp_run, mesh):
    """The sharded state puts the unsharded weights back in their rows (the
    GEGLU's too); a checkpoint saved at the mesh restores unsharded, and an
    unsharded one at the mesh, parameters and AdamW moments bit-equal; the
    state restored at the mesh takes the next step as the live one."""
    res = tp_run["ranks"][0][mesh]
    for k, v in ref["sd"].items():
        assert torch.equal(res["init"][k], torch.from_numpy(v)), k
    assert res["restored_equal"] and res["next_step_equal"]

    init_fn, _ = make_train_step(ref["port"], adamw(LR), device="cpu")
    back = restore_train_state(tp_run["dir"] / f"ckpt_{mesh}", init_fn())
    assert back.step == 2
    saved = full_state_dict(back)
    assert saved.keys() == res["saved_params"].keys()
    for k, p in res["saved_params"].items():
        assert torch.equal(saved[k], p), k
    for kind, ts in _moments(back).items():
        for k, x in ts.items():
            assert torch.equal(x, res["saved_moments"][kind][k]), (kind, k)

    step, params, moments = res["from_unsharded"]
    live = tp_run["adamw"]
    assert step == live.step == 1
    for k, p in live.params.items():
        assert torch.equal(params[k], p.detach()), k
    for kind, ts in _moments(live).items():
        for k, x in ts.items():
            assert torch.equal(moments[kind][k], x), (kind, k)


def test_step_takes_a_mesh_or_a_process_group():
    with pytest.raises(ValueError, match="not both"):
        make_train_step(torch.nn.Linear(2, 2), sgd(LR), mesh=object(), process_group=object(),
                        device="cpu")


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
