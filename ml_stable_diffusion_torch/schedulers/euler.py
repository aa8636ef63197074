"""Euler discrete scheduler, k-diffusion style (port of
ml_stable_diffusion_tpu/schedulers/euler.py).

Sigmas sqrt((1 - acp) / acp) at the spaced (or Karras) timesteps, then a
terminal 0.  The per-step scalars are combined in float32, as the JAX
package combines its float32 table entries, before they touch the latents.
"""

from __future__ import annotations

import numpy as np

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


def _ratio_sigmas(config, timesteps: np.ndarray) -> np.ndarray:
    """sigma = sqrt((1 - acp) / acp) interpolated at (possibly fractional)
    training timesteps."""
    acp = config.alphas_cumprod()
    all_sigmas = np.sqrt((1 - acp) / acp)
    return np.interp(timesteps, np.arange(len(all_sigmas)), all_sigmas)


def _euler_pred_x0(sample, model_output, sigma, prediction_type):
    """x0 in the sigma-space convention x = x0 + sigma * eps; ``sigma`` a
    float32 scalar."""
    if prediction_type == PredictionType.EPSILON:
        return sample - float(sigma) * model_output
    if prediction_type == PredictionType.V_PREDICTION:
        s2 = sigma * sigma + np.float32(1.0)
        return model_output * float(-sigma / np.sqrt(s2)) + sample / float(s2)
    return model_output


class EulerScheduler(Scheduler):
    def _plan_tables(self, num_inference_steps: int, strength: float):
        cfg = self.config
        if cfg.timestep_spacing == TimestepSpacing.KARRAS:
            acp = cfg.alphas_cumprod()
            all_sigmas = np.sqrt((1 - acp) / acp)
            sigmas = karras_sigma_ramp(float(all_sigmas.min()), float(all_sigmas.max()),
                                       num_inference_steps)
            ts = sigma_to_timestep(sigmas, all_sigmas)
        else:
            ts = spaced_timesteps(cfg.num_train_timesteps, num_inference_steps,
                                  cfg.timestep_spacing, cfg.steps_offset)
            sigmas = _ratio_sigmas(cfg, ts)
        sigmas = np.concatenate([sigmas, [0.0]])
        start = strength_slice(num_inference_steps, strength)
        ts, sigmas = ts[start:], sigmas[start:]
        if cfg.timestep_spacing == TimestepSpacing.LEADING:
            init_noise_sigma = float(np.sqrt(sigmas.max() ** 2 + 1))
        else:
            init_noise_sigma = float(sigmas.max())
        return ts, sigmas, init_noise_sigma

    def set_timesteps(self, num_inference_steps: int, strength: float = 1.0) -> SchedulerPlan:
        ts, sigmas, init_noise_sigma = self._plan_tables(num_inference_steps, strength)
        return SchedulerPlan(timesteps=ts.astype(np.float32), num_steps=len(ts),
                             init_noise_sigma=init_noise_sigma,
                             tables={"sigmas": sigmas.astype(np.float32)})

    def scale_model_input(self, plan, state, sample, i):
        sigma = plan.table("sigmas")[i]
        return sample / float(np.sqrt(sigma * sigma + np.float32(1.0)))

    def _derivative(self, plan, model_output, i, sample):
        sigma = plan.table("sigmas")[i]
        x0 = _euler_pred_x0(sample, model_output, sigma, self.config.prediction_type)
        return (sample - x0) / float(sigma)

    def step(self, plan, state, model_output, i, sample, noise=None):
        sigmas = plan.table("sigmas")
        d = self._derivative(plan, model_output, i, sample)
        return state, sample + d * float(sigmas[i + 1] - sigmas[i])

    def add_noise(self, plan, original, noise, i=0):
        return original + noise * float(plan.table("sigmas")[i])

    def pred_x0(self, plan, state, model_output, i, sample):
        return _euler_pred_x0(sample, model_output, plan.table("sigmas")[i],
                              self.config.prediction_type)
