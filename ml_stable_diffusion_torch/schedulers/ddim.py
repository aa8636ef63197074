"""DDIM, eta = 0 (port of ml_stable_diffusion_tpu/schedulers/ddim.py).

Per-step alpha products are host tables; the update is two float32
multiply-adds over the latents."""

from __future__ import annotations

import numpy as np

from .base import (
    Scheduler,
    SchedulerPlan,
    pred_original_sample,
    spaced_timesteps,
    strength_slice,
    to_epsilon,
)


class DDIMScheduler(Scheduler):
    def set_timesteps(self, num_inference_steps: int, strength: float = 1.0) -> SchedulerPlan:
        cfg = self.config
        ts = spaced_timesteps(cfg.num_train_timesteps, num_inference_steps,
                              cfg.timestep_spacing, cfg.steps_offset)
        acp = cfg.alphas_cumprod()
        idx = ts.astype(np.int64)
        prev_idx = idx - cfg.num_train_timesteps // num_inference_steps
        alpha_t = acp[idx]
        alpha_prev = np.where(prev_idx >= 0, acp[np.clip(prev_idx, 0, None)], 1.0)

        start = strength_slice(num_inference_steps, strength)
        ts, alpha_t, alpha_prev = ts[start:], alpha_t[start:], alpha_prev[start:]
        tables = {
            "sqrt_alpha_t": np.sqrt(alpha_t).astype(np.float32),
            "sqrt_one_minus_alpha_t": np.sqrt(1 - alpha_t).astype(np.float32),
            "sqrt_alpha_prev": np.sqrt(alpha_prev).astype(np.float32),
            "sqrt_one_minus_alpha_prev": np.sqrt(1 - alpha_prev).astype(np.float32),
        }
        return SchedulerPlan(timesteps=ts.astype(np.float32), num_steps=len(ts),
                             init_noise_sigma=1.0, tables=tables)

    def step(self, plan, state, model_output, i, sample, noise=None):
        a_t = plan.table("sqrt_alpha_t")[i]
        s_t = plan.table("sqrt_one_minus_alpha_t")[i]
        pt = self.config.prediction_type
        x0 = pred_original_sample(sample, model_output, a_t, s_t, pt)
        eps = to_epsilon(sample, model_output, a_t, s_t, pt)
        return state, (float(plan.table("sqrt_alpha_prev")[i]) * x0
                       + float(plan.table("sqrt_one_minus_alpha_prev")[i]) * eps)

    def add_noise(self, plan, original, noise, i=0):
        return (float(plan.table("sqrt_alpha_t")[i]) * original
                + float(plan.table("sqrt_one_minus_alpha_t")[i]) * noise)
