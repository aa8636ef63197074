"""Generation pipelines."""

from .config import PipelineConfiguration
from .sd import GenerationResult, StableDiffusionPipeline
from .sd3 import StableDiffusion3Pipeline
from .sdxl import StableDiffusionXLPipeline

__all__ = ["PipelineConfiguration", "GenerationResult", "StableDiffusionPipeline",
           "StableDiffusion3Pipeline", "StableDiffusionXLPipeline"]
