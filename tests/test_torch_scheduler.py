"""Port DPM-Solver++(2M) against the JAX scheduler and its golden trajectory.

Tables are host float64 math stored as float32 in both packages: they must
be equal.  A 20-step trajectory on the same random model outputs agrees to
1e-5.  The 2-step golden of tests/goldens/dpm2.npz (the tiny JAX pipeline,
"golden cat", seed 93, JAX-drawn noise) is reproduced by the port's
text encoder, UNet and scheduler from the same initial noise, within the
golden's own tolerance (rtol = atol = 2e-4).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.schedulers import DPMSolverMultistepScheduler as JaxDPM
from ml_stable_diffusion_tpu.schedulers.base import TimestepSpacing as JaxSpacing

from ml_stable_diffusion_torch.pipelines import PipelineConfiguration
from ml_stable_diffusion_torch.schedulers import DPMSolverMultistepScheduler
from ml_stable_diffusion_torch.schedulers.base import TimestepSpacing

from torch_helpers import pipelines

GOLDEN = Path(__file__).parent / "goldens" / "dpm2.npz"


@pytest.mark.parametrize("spacing", ["leading", "linspace", "trailing", "karras"])
@pytest.mark.parametrize("steps", [2, 10, 20, 25])
def test_tables_match_jax(steps, spacing):
    ref = JaxDPM(timestep_spacing=JaxSpacing(spacing)).set_timesteps(steps)
    got = DPMSolverMultistepScheduler(
        timestep_spacing=TimestepSpacing(spacing)).set_timesteps(steps)
    assert got.num_steps == ref.num_steps
    assert got.init_noise_sigma == ref.init_noise_sigma
    np.testing.assert_array_equal(got.timesteps, np.asarray(ref.timesteps))
    for name in ("alpha", "sigma", "lambda", "first_order"):
        np.testing.assert_array_equal(got.table(name), np.asarray(ref.table(name)),
                                      err_msg=name)


@pytest.mark.parametrize("steps", [20, 6])
def test_trajectory_matches_jax(steps):
    """Same arithmetic step by step: 20 steps (second order to the end) and
    6 (first-order final step)."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 4, 8, 8).astype(np.float32)
    outs = rng.randn(steps, 1, 4, 8, 8).astype(np.float32)
    jsched, psched = JaxDPM(), DPMSolverMultistepScheduler()
    jplan, pplan = jsched.set_timesteps(steps), psched.set_timesteps(steps)
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    jstate, pstate = jsched.initial_state(jplan, x.shape), psched.initial_state(pplan, px)
    for i in range(steps):
        jstate, jx = jsched.step(jplan, jstate, jnp.asarray(outs[i]), i, jx)
        pstate, px = psched.step(pplan, pstate, torch.from_numpy(outs[i]), i, px)
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {i}")


def test_dpm2_golden(tmp_path):
    _, pipe = pipelines(tmp_path)
    cfg = PipelineConfiguration(prompt="golden cat", seed=93, step_count=2,
                                scheduler="DPMSolverMultistep", disable_safety=True)
    # the JAX pipeline's rng="jax" initial draw (pipelines/sd.py encode_stage)
    noise = jax.random.normal(jax.random.fold_in(jax.random.key(93), 0),
                              (1, 8, 8, 4), jnp.float32)
    sched = pipe._make_scheduler(cfg)
    plan = sched.set_timesteps(cfg.step_count)
    with torch.no_grad():
        context = pipe._encode_text(pipe._tokenize(cfg))
        lat = torch.from_numpy(np.array(noise)).permute(0, 3, 1, 2).contiguous()
        lat = lat * plan.init_noise_sigma
        lat = pipe._denoise_loop(cfg, lat, context, 1, plan, sched, True, cfg.guidance_scale,
                                 torch.from_numpy(plan.timesteps),
                                 pipe._denoise_phases(cfg, plan.num_steps),
                                 sched.initial_state(plan, lat))[0]
    golden = np.load(GOLDEN)["latents"]
    np.testing.assert_allclose(lat.permute(0, 2, 3, 1).numpy(), golden,
                               rtol=2e-4, atol=2e-4)
