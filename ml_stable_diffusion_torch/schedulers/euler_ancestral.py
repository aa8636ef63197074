"""Euler ancestral scheduler (port of
ml_stable_diffusion_tpu/schedulers/euler_ancestral.py): stochastic, one
noise draw per step, which the pipeline supplies from its host stream."""

from __future__ import annotations

import numpy as np

from .base import SchedulerPlan
from .euler import EulerScheduler


class EulerAncestralScheduler(EulerScheduler):
    needs_noise = True

    def set_timesteps(self, num_inference_steps: int, strength: float = 1.0) -> SchedulerPlan:
        ts, sigmas, init_noise_sigma = self._plan_tables(num_inference_steps, strength)
        s_from, s_to = sigmas[:-1], sigmas[1:]
        with np.errstate(divide="ignore", invalid="ignore"):
            sigma_up = np.sqrt(np.clip(s_to**2 * (s_from**2 - s_to**2) / s_from**2, 0, None))
        sigma_down = np.sqrt(np.clip(s_to**2 - sigma_up**2, 0, None))
        return SchedulerPlan(timesteps=ts.astype(np.float32), num_steps=len(ts),
                             init_noise_sigma=init_noise_sigma,
                             tables={"sigmas": sigmas.astype(np.float32),
                                     "sigma_up": sigma_up.astype(np.float32),
                                     "sigma_down": sigma_down.astype(np.float32)})

    def step(self, plan, state, model_output, i, sample, noise=None):
        if noise is None:
            raise ValueError("EulerAncestralScheduler.step requires noise")
        sigma = plan.table("sigmas")[i]
        d = self._derivative(plan, model_output, i, sample)
        prev = (sample + d * float(plan.table("sigma_down")[i] - sigma)
                + noise * float(plan.table("sigma_up")[i]))
        return state, prev
