"""Discrete flow (rectified-flow) scheduler for SD3 (port of
ml_stable_diffusion_tpu/schedulers/flow.py).

The shifted sigma grid sigma' = shift*sigma / (1 + (shift-1)*sigma) from 1
down to 1/S, then a terminal 0; float timesteps sigma*1000; an Euler
velocity step x_next = x + (sigma_next - sigma) * v.  The grid is built in
float64 and stored as float32, as the JAX package stores it, and the step
takes the sigma difference in float32 before it touches the latents.
"""

from __future__ import annotations

import numpy as np

from .base import Scheduler, SchedulerConfig, SchedulerPlan


class DiscreteFlowScheduler(Scheduler):
    def __init__(self, config: SchedulerConfig | None = None, shift: float = 3.0,
                 **overrides):
        super().__init__(config, **overrides)
        self.shift = float(shift)

    def set_timesteps(self, num_inference_steps: int, strength: float = 1.0) -> SchedulerPlan:
        if strength < 1.0:
            raise NotImplementedError("img2img strength: ROADMAP Queue 1 item 11")
        S = num_inference_steps
        t = np.linspace(1.0, 1.0 / S, S)
        sigmas = self.shift * t / (1.0 + (self.shift - 1.0) * t)
        sigmas = np.concatenate([sigmas, [0.0]])
        ts = sigmas[:-1] * self.config.num_train_timesteps
        return SchedulerPlan(timesteps=ts.astype(np.float32), num_steps=S,
                             init_noise_sigma=1.0,
                             tables={"sigmas": sigmas.astype(np.float32)})

    def step(self, plan, state, model_output, i, sample):
        sigmas = plan.table("sigmas")
        return state, sample + float(sigmas[i + 1] - sigmas[i]) * model_output

    def pred_x0(self, plan, state, model_output, i, sample):
        """The denoised estimate x - sigma * v."""
        return sample - float(plan.table("sigmas")[i]) * model_output
