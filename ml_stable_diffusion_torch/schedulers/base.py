"""Shared scheduler math (port of ml_stable_diffusion_tpu/schedulers/base.py).

Every per-step constant is precomputed into tables at plan time (host,
float64 numpy), then stored as float32 as the JAX package stores them.  The
JAX package runs the per-step update inside a jitted ``lax.scan``; here the
pipeline loops in Python and each step does the same float32 arithmetic.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import numpy as np


class BetaSchedule(str, enum.Enum):
    LINEAR = "linear"
    SCALED_LINEAR = "scaledLinear"


class PredictionType(str, enum.Enum):
    EPSILON = "epsilon"
    V_PREDICTION = "v_prediction"
    SAMPLE = "sample"


class TimestepSpacing(str, enum.Enum):
    LINSPACE = "linspace"
    LEADING = "leading"
    TRAILING = "trailing"
    KARRAS = "karras"


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Training-time diffusion process constants (defaults = SD 1.x/2.x)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: BetaSchedule = BetaSchedule.SCALED_LINEAR
    prediction_type: PredictionType = PredictionType.EPSILON
    steps_offset: int = 1
    timestep_spacing: TimestepSpacing = TimestepSpacing.LEADING

    def betas(self) -> np.ndarray:
        T = self.num_train_timesteps
        if self.beta_schedule == BetaSchedule.LINEAR:
            return np.linspace(self.beta_start, self.beta_end, T, dtype=np.float64)
        # scaledLinear: linspace in sqrt-space
        return np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5, T,
                           dtype=np.float64) ** 2

    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas())


@dataclasses.dataclass
class SchedulerPlan:
    """Precomputed per-run tables (float32 numpy), indexed by step ``i``.

    ``timesteps`` is what the denoiser is called with; ``num_steps`` is the
    loop length."""

    timesteps: np.ndarray
    num_steps: int
    init_noise_sigma: float
    tables: dict[str, np.ndarray]

    def table(self, name: str) -> np.ndarray:
        return self.tables[name]


def spaced_timesteps(num_train_timesteps: int, num_inference_steps: int,
                     spacing: TimestepSpacing, steps_offset: int) -> np.ndarray:
    """Descending integer timesteps per the given spacing rule."""
    T, S = num_train_timesteps, num_inference_steps
    if spacing == TimestepSpacing.LINSPACE:
        ts = np.linspace(0, T - 1, S).round()[::-1]
    elif spacing == TimestepSpacing.LEADING:
        ratio = T // S
        ts = (np.arange(S) * ratio).round()[::-1] + steps_offset
    elif spacing == TimestepSpacing.TRAILING:
        ratio = T / S
        ts = np.arange(T, 0, -ratio).round() - 1
    else:
        raise ValueError(f"unsupported spacing {spacing}")
    return ts.astype(np.float64)


def karras_sigma_ramp(sigma_min: float, sigma_max: float, n: int,
                      rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) sigma schedule."""
    ramp = np.linspace(0, 1, n)
    min_inv = sigma_min ** (1 / rho)
    max_inv = sigma_max ** (1 / rho)
    return (max_inv + ramp * (min_inv - max_inv)) ** rho


def sigma_to_timestep(sigmas: np.ndarray, all_sigmas: np.ndarray) -> np.ndarray:
    """Invert sigma(t) by piecewise-linear interpolation over the training
    schedule."""
    log_sigmas = np.log(all_sigmas)
    log_q = np.log(sigmas)
    ts = np.empty_like(sigmas)
    for k, lq in enumerate(log_q):
        dists = lq - log_sigmas
        low_idx = int(np.clip((dists >= 0).cumsum().argmax(), 0, len(log_sigmas) - 2))
        high_idx = low_idx + 1
        low, high = log_sigmas[low_idx], log_sigmas[high_idx]
        w = np.clip((low - lq) / (low - high), 0.0, 1.0)
        ts[k] = (1 - w) * low_idx + w * high_idx
    return ts


def strength_slice(num_inference_steps: int, strength: float) -> int:
    """Starting step index for img2img: the loop runs the last
    ``min(S, max(1, int(S * strength)))`` steps."""
    t_enc = min(num_inference_steps, max(1, int(num_inference_steps * strength)))
    return num_inference_steps - t_enc


def pred_original_sample(sample, model_output, alpha_t, sigma_t,
                         prediction_type: PredictionType):
    """A model output -> the predicted x0; ``alpha_t`` = sqrt(acp[t]),
    ``sigma_t`` = sqrt(1 - acp[t]), float32 scalars."""
    if prediction_type == PredictionType.EPSILON:
        return (sample - float(sigma_t) * model_output) / float(alpha_t)
    if prediction_type == PredictionType.V_PREDICTION:
        return float(alpha_t) * sample - float(sigma_t) * model_output
    return model_output  # SAMPLE


def to_epsilon(sample, model_output, alpha_t, sigma_t, prediction_type: PredictionType):
    """A model output -> the epsilon prediction."""
    if prediction_type == PredictionType.EPSILON:
        return model_output
    if prediction_type == PredictionType.V_PREDICTION:
        return float(sigma_t) * sample + float(alpha_t) * model_output
    return (sample - float(alpha_t) * model_output) / float(sigma_t)  # SAMPLE


class Scheduler:
    """Base class: static configuration.  Per-run data lives in the plan and
    in the state dict that ``step`` returns."""

    #: True if ``step`` consumes a fresh noise tensor each call
    needs_noise: bool = False

    def __init__(self, config: SchedulerConfig | None = None, **overrides):
        if config is None:
            config = SchedulerConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config

    def set_timesteps(self, num_inference_steps: int, strength: float = 1.0) -> SchedulerPlan:
        raise NotImplementedError

    def initial_state(self, plan: SchedulerPlan, sample) -> dict[str, Any]:
        return {}

    def scale_model_input(self, plan: SchedulerPlan, state, sample, i: int):
        return sample

    def step(self, plan: SchedulerPlan, state, model_output, i: int, sample, noise=None):
        raise NotImplementedError

    def add_noise(self, plan: SchedulerPlan, original, noise, i: int = 0):
        """Noise a clean latent to the level of step ``i`` (0: the img2img
        start; later steps: the known region of legacy inpainting)."""
        raise NotImplementedError

    def pred_x0(self, plan: SchedulerPlan, state, model_output, i: int, sample):
        """The predicted clean latent at step ``i``.  Default: DDPM scaling at
        the integer training timestep, in float32; sigma-space schedulers
        override it."""
        acp = self.config.alphas_cumprod().astype(np.float32)
        t = int(np.clip(int(plan.timesteps[i]), 0, acp.shape[0] - 1))
        return pred_original_sample(sample, model_output, np.sqrt(acp[t]),
                                    np.sqrt(np.float32(1.0) - acp[t]),
                                    self.config.prediction_type)
