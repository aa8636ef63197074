"""Every scheduler of the port against the JAX scheduler of the same name.

The plans' tables are host float64 math stored as float32 in both packages:
they must be equal.  Over a whole plan, on the same random model outputs
(and, for the stochastic schedulers, the same per-step noise), every step
agrees within atol 1e-5 plus rtol 1e-5 in float32 (the tolerance of
tests/test_torch_scheduler.py: on random model outputs the latents reach
|x| ~ 20, where a few float32 ulps of a reordered sum are 1e-5), at strength
1.0 and 0.5 (PNDM, whose warm-up replays at the img2img resume point, also
at 0.75), as do ``add_noise`` at every step index and ``pred_x0``.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ml_stable_diffusion_tpu import schedulers as jax_schedulers
from ml_stable_diffusion_tpu.schedulers.base import PredictionType as JaxPrediction

from ml_stable_diffusion_torch import schedulers as port_schedulers
from ml_stable_diffusion_torch.schedulers.base import PredictionType

ATOL = RTOL = 1e-5
STEPS = 10
NAMES = sorted(port_schedulers.SCHEDULER_MAP)
CASES = [(name, strength) for name in NAMES for strength in (1.0, 0.5)] + [("PNDM", 0.75)]


def test_the_map_holds_every_jax_scheduler():
    assert set(port_schedulers.SCHEDULER_MAP) == set(jax_schedulers.SCHEDULER_MAP)
    assert port_schedulers.get_available_schedulers() == port_schedulers.SCHEDULER_MAP
    for name, cls in port_schedulers.SCHEDULER_MAP.items():
        assert cls.needs_noise == jax_schedulers.SCHEDULER_MAP[name].needs_noise, name


def _pair(name, prediction="epsilon"):
    return (jax_schedulers.SCHEDULER_MAP[name](prediction_type=JaxPrediction(prediction)),
            port_schedulers.SCHEDULER_MAP[name](prediction_type=PredictionType(prediction)))


@pytest.mark.parametrize("name,strength", CASES)
def test_plans_match_jax(name, strength):
    jsched, psched = _pair(name)
    ref, got = jsched.set_timesteps(STEPS, strength=strength), \
        psched.set_timesteps(STEPS, strength=strength)
    assert got.num_steps == ref.num_steps
    assert got.init_noise_sigma == ref.init_noise_sigma
    np.testing.assert_array_equal(got.timesteps, np.asarray(ref.timesteps))
    assert set(got.tables) == set(ref.tables)
    for key in ref.tables:
        np.testing.assert_array_equal(got.table(key), np.asarray(ref.table(key)), err_msg=key)


def _trajectory(name, strength, prediction="epsilon", seed=0):
    jsched, psched = _pair(name, prediction)
    jplan = jsched.set_timesteps(STEPS, strength=strength)
    pplan = psched.set_timesteps(STEPS, strength=strength)
    n = pplan.num_steps
    rng = np.random.RandomState(seed)
    x = rng.randn(1, 4, 8, 8).astype(np.float32)
    outs = rng.randn(n, 1, 4, 8, 8).astype(np.float32)
    noises = rng.randn(n, 1, 4, 8, 8).astype(np.float32)
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    jstate, pstate = jsched.initial_state(jplan, x.shape), psched.initial_state(pplan, px)
    for i in range(n):
        jin = jsched.scale_model_input(jplan, jstate, jx, i)
        pin = psched.scale_model_input(pplan, pstate, px, i)
        np.testing.assert_allclose(pin.numpy(), np.asarray(jin), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} input scale, step {i}")
        jo, po = jnp.asarray(outs[i]), torch.from_numpy(outs[i])
        np.testing.assert_allclose(
            psched.pred_x0(pplan, pstate, po, i, px).numpy(),
            np.asarray(jsched.pred_x0(jplan, jstate, jo, i, jx)), rtol=RTOL, atol=ATOL,
            err_msg=f"{name} pred_x0, step {i}")
        noise = {}
        if jsched.needs_noise:
            noise = dict(j=jnp.asarray(noises[i]), p=torch.from_numpy(noises[i]))
        jstate, jx = jsched.step(jplan, jstate, jo, i, jx, noise=noise.get("j"))
        pstate, px = psched.step(pplan, pstate, po, i, px, noise=noise.get("p"))
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} step {i} of {n}")
    assert np.isfinite(px.numpy()).all()


@pytest.mark.parametrize("name,strength", CASES)
def test_trajectory_matches_jax(name, strength):
    _trajectory(name, strength)


@pytest.mark.parametrize("name", ["PNDM", "DDIM", "Euler", "DPMSolverMultistep"])
def test_v_prediction_trajectory_matches_jax(name):
    _trajectory(name, 1.0, prediction="v_prediction", seed=1)


@pytest.mark.parametrize("name", [n for n in NAMES])
def test_add_noise_matches_jax(name):
    jsched, psched = _pair(name)
    jplan, pplan = jsched.set_timesteps(STEPS, strength=0.6), \
        psched.set_timesteps(STEPS, strength=0.6)
    rng = np.random.RandomState(2)
    z0 = rng.randn(2, 4, 8, 8).astype(np.float32)
    noise = rng.randn(2, 4, 8, 8).astype(np.float32)
    for i in range(pplan.num_steps):
        np.testing.assert_allclose(
            psched.add_noise(pplan, torch.from_numpy(z0), torch.from_numpy(noise), i).numpy(),
            np.asarray(jsched.add_noise(jplan, jnp.asarray(z0), jnp.asarray(noise), i)),
            rtol=RTOL, atol=ATOL, err_msg=f"{name} add_noise at step {i}")


def test_pndm_plan_has_the_warm_up_step():
    """S + 1 evaluations: the second-to-last ascending timestep twice, at
    steps 1 and 2; img2img resumes at step ``strength_slice``."""
    plan = port_schedulers.PNDMScheduler().set_timesteps(20)
    assert plan.num_steps == 21
    ts = plan.timesteps.tolist()
    assert ts[1] == ts[2] and len(set(ts)) == 20
    resumed = port_schedulers.PNDMScheduler().set_timesteps(20, strength=0.5)
    assert resumed.num_steps == 11 and resumed.timesteps[0] == plan.timesteps[10]


def test_stochastic_schedulers_need_noise():
    for name in ("EulerAncestral", "LCM"):
        sched = port_schedulers.SCHEDULER_MAP[name]()
        plan = sched.set_timesteps(4)
        x = torch.zeros(1, 4, 2, 2)
        with pytest.raises(ValueError, match="noise"):
            sched.step(plan, sched.initial_state(plan, x), x, 0, x)
