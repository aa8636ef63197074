"""LMS (linear multistep, order 4), k-diffusion style (port of
ml_stable_diffusion_tpu/schedulers/lms.py).

The Adams-Bashforth coefficients integrate the Lagrange basis over each
sigma interval: a host table of (S, 4) built at plan time; the step is four
multiply-adds over a ring of the last derivatives.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import integrate

from .base import SchedulerPlan
from .euler import EulerScheduler

ORDER = 4


def _lms_coefficient_table(sigmas: np.ndarray, order: int = ORDER) -> np.ndarray:
    """coeffs[i, j] = the integral over [sigma_i, sigma_{i+1}] of the j-th
    Lagrange basis over the last min(i + 1, order) sigmas."""
    S = len(sigmas) - 1
    coeffs = np.zeros((S, order))
    for i in range(S):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            def poly(tau):
                prod = 1.0
                for k in range(cur_order):
                    if k != j:
                        prod *= (tau - sigmas[i - k]) / (sigmas[i - j] - sigmas[i - k])
                return prod

            coeffs[i, j] = integrate.quad(poly, sigmas[i], sigmas[i + 1], epsrel=1e-4)[0]
    return coeffs


class LMSScheduler(EulerScheduler):
    def set_timesteps(self, num_inference_steps: int, strength: float = 1.0) -> SchedulerPlan:
        ts, sigmas, init_noise_sigma = self._plan_tables(num_inference_steps, strength)
        return SchedulerPlan(timesteps=ts.astype(np.float32), num_steps=len(ts),
                             init_noise_sigma=init_noise_sigma,
                             tables={"sigmas": sigmas.astype(np.float32),
                                     "coeffs": _lms_coefficient_table(sigmas).astype(np.float32)})

    def initial_state(self, plan, sample):
        return {"derivs": [torch.zeros_like(sample) for _ in range(ORDER)]}

    def step(self, plan, state, model_output, i, sample, noise=None):
        derivs = list(state["derivs"])
        derivs[i % ORDER] = self._derivative(plan, model_output, i, sample)
        coeffs = plan.table("coeffs")[i]
        prev = sample
        for j in range(ORDER):
            prev = prev + float(coeffs[j]) * derivs[(i - j) % ORDER]
        return {"derivs": derivs}, prev
