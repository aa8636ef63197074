"""DPM-Solver++(2M) multistep scheduler (port of
ml_stable_diffusion_tpu/schedulers/dpm_solver.py).

Second-order midpoint variant with data prediction, linspace/leading/karras
timestep spacing, and first order for the first step and, below 15 steps,
the final one.  The tables are the JAX package's, built the same way in
float64 and stored as float32; ``step`` does the same float32 arithmetic,
with the per-step scalars combined in float32 before they touch the latents.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import (
    PredictionType,
    Scheduler,
    SchedulerPlan,
    TimestepSpacing,
    karras_sigma_ramp,
    sigma_to_timestep,
    spaced_timesteps,
    strength_slice,
)

#: Below this step count the final step drops to first order for stability.
LOWER_ORDER_FINAL_MAX_STEPS = 15


class DPMSolverMultistepScheduler(Scheduler):
    def set_timesteps(self, num_inference_steps: int, strength: float = 1.0) -> SchedulerPlan:
        cfg = self.config
        acp = cfg.alphas_cumprod()
        all_ratio_sigmas = np.sqrt((1 - acp) / acp)

        if cfg.timestep_spacing == TimestepSpacing.KARRAS:
            sig = karras_sigma_ramp(float(all_ratio_sigmas.min()),
                                    float(all_ratio_sigmas.max()),
                                    num_inference_steps)
            ts = sigma_to_timestep(sig, all_ratio_sigmas)
            ratio_sigmas = sig
        else:
            ts = spaced_timesteps(cfg.num_train_timesteps, num_inference_steps,
                                  cfg.timestep_spacing, cfg.steps_offset)
            ratio_sigmas = np.interp(ts, np.arange(len(all_ratio_sigmas)), all_ratio_sigmas)

        # S+1 trajectory points: the S sampling sigmas plus the terminal point
        # at training timestep 0.
        ratio_sigmas = np.concatenate([ratio_sigmas, [all_ratio_sigmas[0]]])
        alpha_t = 1.0 / np.sqrt(1.0 + ratio_sigmas**2)
        sigma_t = ratio_sigmas * alpha_t
        lam = np.log(alpha_t / sigma_t)

        start = strength_slice(num_inference_steps, strength)
        ts = ts[start:]
        alpha_t, sigma_t, lam = alpha_t[start:], sigma_t[start:], lam[start:]
        S = len(ts)

        first_order = np.zeros(S, dtype=bool)
        first_order[0] = True
        if S < LOWER_ORDER_FINAL_MAX_STEPS:
            first_order[-1] = True

        tables = {
            "alpha": alpha_t.astype(np.float32),
            "sigma": sigma_t.astype(np.float32),
            "lambda": lam.astype(np.float32),
            "first_order": first_order,
        }
        return SchedulerPlan(timesteps=ts.astype(np.float32), num_steps=S,
                             init_noise_sigma=1.0, tables=tables)

    def initial_state(self, plan, sample):
        return {"prev_x0": torch.zeros_like(sample)}

    def pred_x0(self, plan, state, model_output, i, sample):
        return self._pred_x0(sample, model_output, plan.table("alpha")[i],
                             plan.table("sigma")[i])

    def _pred_x0(self, sample, model_output, alpha, sigma):
        pt = self.config.prediction_type
        if pt == PredictionType.EPSILON:
            return (sample - float(sigma) * model_output) / float(alpha)
        if pt == PredictionType.V_PREDICTION:
            return float(alpha) * sample - float(sigma) * model_output
        return model_output

    def step(self, plan, state, model_output, i, sample, noise=None):
        alpha = plan.table("alpha")
        sigma = plan.table("sigma")
        lam = plan.table("lambda")
        a_s, a_t = alpha[i], alpha[i + 1]
        s_s, s_t = sigma[i], sigma[i + 1]
        l_s, l_t = lam[i], lam[i + 1]

        x0 = self._pred_x0(sample, model_output, a_s, s_s)

        h = l_t - l_s
        ratio = s_t / s_s
        phi = np.expm1(-h)

        first = float(ratio) * sample - float(a_t * phi) * x0
        if plan.table("first_order")[i]:
            return {"prev_x0": x0}, first

        # 2M midpoint: D1 = (x0 - prev_x0)/r0, r0 = h_prev/h
        h_prev = l_s - lam[i - 1]
        r0 = h_prev / h
        d1 = (x0 - state["prev_x0"]) / float(r0)
        second = first - float(np.float32(0.5) * a_t * phi) * d1
        return {"prev_x0": x0}, second

    def add_noise(self, plan, original, noise, i=0):
        return (float(plan.table("alpha")[i]) * original
                + float(plan.table("sigma")[i]) * noise)
