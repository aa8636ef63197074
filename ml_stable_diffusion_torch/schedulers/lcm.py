"""Latent Consistency Model scheduler (port of
ml_stable_diffusion_tpu/schedulers/lcm.py).

Each step predicts the clean latent through the consistency
parameterization ``denoised = c_out * pred_x0 + c_skip * sample``
(sigma_data = 0.5, timestep scaling 10), then, except on the final step,
re-noises it to the next timestep with fresh noise from the pipeline.  The
timesteps subsample the distillation's 50-step DDIM grid.
"""

from __future__ import annotations

import numpy as np

from .base import Scheduler, SchedulerPlan, pred_original_sample, strength_slice

#: distillation constants (diffusers LCMScheduler defaults)
ORIGINAL_INFERENCE_STEPS = 50
SIGMA_DATA = 0.5
TIMESTEP_SCALING = 10.0


class LCMScheduler(Scheduler):
    needs_noise = True  # re-noise to the next timestep each non-final step

    def set_timesteps(self, num_inference_steps: int, strength: float = 1.0,
                      original_inference_steps: int = ORIGINAL_INFERENCE_STEPS
                      ) -> SchedulerPlan:
        T = self.config.num_train_timesteps
        if num_inference_steps > original_inference_steps:
            raise ValueError(
                f"LCM supports at most {original_inference_steps} steps "
                f"(the distillation grid); got {num_inference_steps}")
        k = T // original_inference_steps
        origin = np.arange(1, original_inference_steps + 1) * k - 1
        skip = len(origin) // num_inference_steps
        ts = origin[::-skip][:num_inference_steps].astype(np.float64)

        acp = self.config.alphas_cumprod()
        ti = ts.astype(int)
        prev_ti = np.concatenate([ti[1:], [0]])  # final step: full denoise
        scaled = ts * TIMESTEP_SCALING
        c_skip = SIGMA_DATA**2 / (scaled**2 + SIGMA_DATA**2)
        c_out = scaled / np.sqrt(scaled**2 + SIGMA_DATA**2)
        is_last = np.zeros(len(ts), bool)
        is_last[-1] = True

        sl = slice(strength_slice(num_inference_steps, strength), None)
        f32 = {
            "sqrt_alpha_t": np.sqrt(acp[ti]),
            "sqrt_one_minus_alpha_t": np.sqrt(1 - acp[ti]),
            "sqrt_alpha_prev": np.sqrt(acp[prev_ti]),
            "sqrt_one_minus_alpha_prev": np.sqrt(1 - acp[prev_ti]),
            "c_skip": c_skip,
            "c_out": c_out,
        }
        tables = {name: t.astype(np.float32)[sl] for name, t in f32.items()}
        tables["is_last"] = is_last[sl]
        ts = ts[sl]
        return SchedulerPlan(timesteps=ts.astype(np.float32), num_steps=len(ts),
                             init_noise_sigma=1.0, tables=tables)

    def _denoised(self, plan, model_output, i, sample):
        x0 = pred_original_sample(sample, model_output, plan.table("sqrt_alpha_t")[i],
                                  plan.table("sqrt_one_minus_alpha_t")[i],
                                  self.config.prediction_type)
        return float(plan.table("c_out")[i]) * x0 + float(plan.table("c_skip")[i]) * sample

    def step(self, plan, state, model_output, i, sample, noise=None):
        denoised = self._denoised(plan, model_output, i, sample)
        if plan.table("is_last")[i]:
            return state, denoised
        if noise is None:
            raise ValueError("LCMScheduler.step requires noise before the final step")
        return state, (float(plan.table("sqrt_alpha_prev")[i]) * denoised
                       + float(plan.table("sqrt_one_minus_alpha_prev")[i]) * noise)

    def add_noise(self, plan, original, noise, i=0):
        return (float(plan.table("sqrt_alpha_t")[i]) * original
                + float(plan.table("sqrt_one_minus_alpha_t")[i]) * noise)

    def pred_x0(self, plan, state, model_output, i, sample):
        return self._denoised(plan, model_output, i, sample)
