"""Discrete flow (rectified-flow) scheduler for SD3 (port of
ml_stable_diffusion_tpu/schedulers/flow.py).

The shifted sigma grid sigma' = shift*sigma / (1 + (shift-1)*sigma) from 1
down to 1/S, then a terminal 0; float timesteps sigma*1000; an Euler
velocity step x_next = x + (sigma_next - sigma) * v.  img2img starts the
grid at ``strength_slice``.  The grid is built in
float64 and stored as float32, as the JAX package stores it, and the step
takes the sigma difference in float32 before it touches the latents.
"""

from __future__ import annotations

import numpy as np

from .base import Scheduler, SchedulerConfig, SchedulerPlan, strength_slice


class DiscreteFlowScheduler(Scheduler):
    def __init__(self, config: SchedulerConfig | None = None, shift: float = 3.0,
                 **overrides):
        super().__init__(config, **overrides)
        self.shift = float(shift)

    def set_timesteps(self, num_inference_steps: int, strength: float = 1.0) -> SchedulerPlan:
        S = num_inference_steps
        t = np.linspace(1.0, 1.0 / S, S)
        sigmas = self.shift * t / (1.0 + (self.shift - 1.0) * t)
        sigmas = np.concatenate([sigmas, [0.0]])
        ts = sigmas[:-1] * self.config.num_train_timesteps
        start = strength_slice(S, strength)
        ts, sigmas = ts[start:], sigmas[start:]
        return SchedulerPlan(timesteps=ts.astype(np.float32), num_steps=len(ts),
                             init_noise_sigma=1.0,
                             tables={"sigmas": sigmas.astype(np.float32)})

    def step(self, plan, state, model_output, i, sample, noise=None):
        sigmas = plan.table("sigmas")
        return state, sample + float(sigmas[i + 1] - sigmas[i]) * model_output

    def add_noise(self, plan, original, noise, i=0):
        sigma = plan.table("sigmas")[i]
        return float(np.float32(1.0) - sigma) * original + float(sigma) * noise

    def pred_x0(self, plan, state, model_output, i, sample):
        """The denoised estimate x - sigma * v."""
        return sample - float(plan.table("sigmas")[i]) * model_output
