"""Cheap latent -> RGB preview without a VAE decode (port of
ml_stable_diffusion_tpu/utils/latent_preview.py): a linear map of the 4
latent channels to RGB, for progress callbacks.  Custom factors (e.g. SD3's
16 channels) can be passed per call.
"""

from __future__ import annotations

import numpy as np

#: 4-channel SD latent -> RGB linear factors (rows: latent ch, cols: RGB)
SD_RGB_FACTORS = np.array([
    [0.298, 0.207, 0.208],
    [0.187, 0.286, 0.173],
    [-0.158, 0.189, 0.264],
    [-0.184, -0.271, -0.473],
], dtype=np.float32)


def latent_to_rgb_preview(latents, rgb_factors=None,
                          value_range: tuple[float, float] = (-1.0, 1.0)):
    """(B, h, w, C) scaled latents (NHWC, as progress callbacks get them)
    -> (B, h, w, 3) float in ``value_range``."""
    latents = np.asarray(latents, np.float32)
    if rgb_factors is None:
        if latents.shape[-1] != 4:
            raise ValueError("built-in factors cover 4-channel latents; pass "
                             "rgb_factors for this latent space")
        rgb_factors = SD_RGB_FACTORS
    rgb = latents @ np.asarray(rgb_factors, np.float32)
    lo, hi = value_range
    return np.clip(rgb, lo, hi)
