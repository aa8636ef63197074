"""Schedulers (port of ml_stable_diffusion_tpu/schedulers): the eight of the
JAX package's map.  Tables are built on the host in float64 numpy and
stored as float32; each step does the JAX package's float32 arithmetic on
device tensors.  The pipeline loops over the steps in Python."""

from .base import BetaSchedule, PredictionType, SchedulerConfig, SchedulerPlan
from .ddim import DDIMScheduler
from .dpm_solver import DPMSolverMultistepScheduler
from .euler import EulerScheduler
from .euler_ancestral import EulerAncestralScheduler
from .flow import DiscreteFlowScheduler
from .lcm import LCMScheduler
from .lms import LMSScheduler
from .pndm import PNDMScheduler

SCHEDULER_MAP = {
    "DDIM": DDIMScheduler,
    "Euler": EulerScheduler,
    "EulerAncestral": EulerAncestralScheduler,
    "DPMSolverMultistep": DPMSolverMultistepScheduler,
    "PNDM": PNDMScheduler,
    "LMS": LMSScheduler,
    "DiscreteFlow": DiscreteFlowScheduler,
    "LCM": LCMScheduler,
}


def get_available_schedulers():
    return dict(SCHEDULER_MAP)


__all__ = ["BetaSchedule", "PredictionType", "SchedulerConfig", "SchedulerPlan",
           "DDIMScheduler", "EulerScheduler", "EulerAncestralScheduler",
           "DPMSolverMultistepScheduler", "PNDMScheduler", "LMSScheduler",
           "DiscreteFlowScheduler", "LCMScheduler", "SCHEDULER_MAP",
           "get_available_schedulers"]
