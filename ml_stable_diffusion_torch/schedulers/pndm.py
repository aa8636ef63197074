"""PNDM scheduler, PLMS path (port of ml_stable_diffusion_tpu/schedulers/pndm.py).

The configuration default.  diffusers-PLMS semantics, as the JAX package
encodes them in tables:

- the trajectory has S + 1 model evaluations: the second-to-last training
  timestep is visited twice in the warm-up, so ``plan.num_steps`` is
  ``steps + 1``;
- the epsilon history is a 4-slot ring; the 1st- to 4th-order
  Adams-Bashforth weights of each step are a table row;
- step 1 re-evaluates at the same point: it restores the sample stashed at
  step 0 and re-targets the same interval with the mean of the two outputs;
- img2img slices the front of the PLMS timesteps and the warm-up replays at
  the resume point (the reference scheduler's counter restarts from 0).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import PredictionType, Scheduler, SchedulerPlan, strength_slice

#: slots of the epsilon history
_RING = 4


class PNDMScheduler(Scheduler):
    def set_timesteps(self, num_inference_steps: int, strength: float = 1.0) -> SchedulerPlan:
        cfg = self.config
        S = num_inference_steps
        ratio = cfg.num_train_timesteps // S
        asc = np.arange(S, dtype=np.int64) * ratio + cfg.steps_offset
        # the second-to-last ascending timestep twice (PLMS warm-up)
        plms = np.concatenate([asc[:-1], asc[-2:-1], asc[-1:]])[::-1].copy()

        acp = cfg.alphas_cumprod()
        final_alpha = acp[0]  # set_alpha_to_one=False for SD

        start = strength_slice(num_inference_steps, strength)
        ts = plms[start:]
        N = len(ts)

        # (timestep, prev_timestep) of each update; step 1 re-targets the
        # same interval (fresh: ts[1] + ratio == ts[0], the duplicated row)
        t_upd = ts.copy()
        t_prev = ts - ratio
        if N >= 2:
            t_upd[1] = ts[1] + ratio
            t_prev[1] = ts[1]

        a_t = acp[np.clip(t_upd, 0, None)]
        a_p = np.where(t_prev >= 0, acp[np.clip(t_prev, 0, None)], final_alpha)
        sample_coeff = np.sqrt(a_p / a_t)
        mo_denom = a_t * np.sqrt(1 - a_p) + np.sqrt(a_t * (1 - a_t) * a_p)
        alpha_diff = a_p - a_t

        # weights on [e_current, m0, m1, m2, m3], m0 the newest ring entry
        # after this step's append
        rows = [[0, 1, 0, 0, 0], [0.5, 0.5, 0, 0, 0], [0, 3 / 2, -1 / 2, 0, 0],
                [0, 23 / 12, -16 / 12, 5 / 12, 0]]
        w = np.array([rows[i] if i < 4 else [0, 55 / 24, -59 / 24, 37 / 24, -9 / 24]
                      for i in range(N)], dtype=np.float64).reshape(N, 5)
        # v-prediction -> epsilon at the evaluation timestep
        a_eval = acp[np.clip(ts, 0, None)]

        tables = {
            "sample_coeff": sample_coeff.astype(np.float32),
            "mo_denom": mo_denom.astype(np.float32),
            "alpha_diff": alpha_diff.astype(np.float32),
            "weights": w.astype(np.float32),
            "sqrt_a_eval": np.sqrt(a_eval).astype(np.float32),
            "sqrt_1m_a_eval": np.sqrt(1 - a_eval).astype(np.float32),
        }
        return SchedulerPlan(timesteps=ts.astype(np.float32), num_steps=N,
                             init_noise_sigma=1.0, tables=tables)

    def initial_state(self, plan, sample):
        return {"ets": [torch.zeros_like(sample) for _ in range(_RING)],
                "cur_sample": torch.zeros_like(sample)}

    def step(self, plan, state, model_output, i, sample, noise=None):
        if self.config.prediction_type == PredictionType.V_PREDICTION:
            model_output = (float(plan.table("sqrt_a_eval")[i]) * model_output
                            + float(plan.table("sqrt_1m_a_eval")[i]) * sample)
        # the warm-up: step 0 stashes its sample, step 1 restores it and
        # appends nothing
        cur_sample = sample if i == 0 else state["cur_sample"]
        upd_sample = cur_sample if i == 1 else sample
        slot = 0 if i == 0 else (i - 1) % _RING
        ets = list(state["ets"])
        if i != 1:
            ets[slot] = model_output

        w = plan.table("weights")[i]
        combined = float(w[0]) * model_output
        for j in range(_RING):
            combined = combined + float(w[j + 1]) * ets[(slot - j) % _RING]
        prev = (float(plan.table("sample_coeff")[i]) * upd_sample
                - float(plan.table("alpha_diff")[i]) * combined
                / float(plan.table("mo_denom")[i]))
        return {"ets": ets, "cur_sample": cur_sample}, prev

    def add_noise(self, plan, original, noise, i=0):
        return (float(plan.table("sqrt_a_eval")[i]) * original
                + float(plan.table("sqrt_1m_a_eval")[i]) * noise)
