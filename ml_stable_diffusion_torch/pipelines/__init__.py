"""Generation pipelines."""

from .config import PipelineConfiguration
from .sd import GenerationResult, PipelineProgress, StableDiffusionPipeline
from .sd3 import StableDiffusion3Pipeline
from .sdxl import StableDiffusionXLPipeline

__all__ = ["PipelineConfiguration", "GenerationResult", "PipelineProgress",
           "StableDiffusionPipeline", "StableDiffusion3Pipeline", "StableDiffusionXLPipeline"]
