"""Public generation configuration (copy of
ml_stable_diffusion_tpu/pipelines/config.py).

Field for field the JAX package's ``PipelineConfiguration``, with two
differences: ``rng`` defaults to ``"numpy"`` (the JAX default ``"jax"`` draws
with ``jax.random``, which this package does not reproduce), and
``attention_implementation`` names the port's paths (``"plain"`` for the
JAX ``"xla"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence


@dataclasses.dataclass
class PipelineConfiguration:
    #: one prompt for all image_count images, or a list of image_count prompts
    prompt: str | Sequence[str] = ""
    negative_prompt: str | Sequence[str] = ""

    #: img2img input (NHWC float in [-1, 1] or a PIL image) and strength
    starting_image: Any | None = None
    strength: float = 1.0
    #: inpainting mask, 1 = repaint
    mask_image: Any | None = None

    image_count: int = 1
    step_count: int = 50
    #: one seed (the batch shares one stream) or a list of image_count seeds
    #: (each image reproduces its own seed's stream)
    seed: int | Sequence[int] = 0
    guidance_scale: float = 7.5

    #: SDXL base -> refiner handoff (0..1 fraction of steps)
    refiner_start: float = 0.8

    #: per-ControlNet conditioning images (NHWC arrays or PIL images)
    controlnet_inputs: Sequence[Any] = ()

    #: IP-Adapter reference image and weight
    ip_adapter_image: Any | None = None
    ip_adapter_scale: float = 1.0

    disable_safety: bool = False
    #: the staged path: each stage's weights on the card for that stage only
    #: (with ``offload_params_to_host``)
    reduce_memory: bool = False
    #: denoised-x0 previews for progress callbacks
    use_denoised_intermediates: bool = False

    #: scheduler key from schedulers.SCHEDULER_MAP
    scheduler: str = "PNDM"
    #: "linspace" | "leading" | "trailing" | "karras"
    timestep_spacing: str | None = None
    #: rectified-flow shift (SD3)
    timestep_shift: float = 3.0

    #: "numpy" | "torch" | "nvidia": host streams that give the same initial
    #: noise as the JAX package's modes of the same names
    rng: str = "numpy"

    #: serial batch-1 CFG: two UNet calls of batch N for one of 2N
    unet_batch_one: bool = False

    #: "auto" | "plain" | "flash" (ops/attention.py)
    attention_implementation: str = "auto"

    #: DeepCache interval; 1 = off
    deepcache_interval: int = 1

    #: latent scale/shift; None -> per-family defaults
    encoder_scale_factor: float | None = None
    decoder_scale_factor: float | None = None
    decoder_shift_factor: float | None = None

    # SDXL micro-conditioning
    original_size: tuple[int, int] | None = None
    crops_coords_top_left: tuple[int, int] = (0, 0)
    target_size: tuple[int, int] | None = None
    aesthetic_score: float = 6.0
    negative_aesthetic_score: float = 2.5

    def validate(self):
        if not (0.0 < self.strength <= 1.0):
            raise ValueError("strength must be in (0, 1]")
        if self.step_count < 1:
            raise ValueError("step_count must be >= 1")
        if self.image_count < 1:
            raise ValueError("image_count must be >= 1")
        if self.deepcache_interval < 1:
            raise ValueError("deepcache_interval must be >= 1")
