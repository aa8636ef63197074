"""Schedulers.  DPM-Solver++(2M) (the SD-2.1 main path) and the rectified
flow of SD3 are ported; the rest come with ROADMAP Queue 1 item 11."""

from .base import BetaSchedule, PredictionType, SchedulerConfig, SchedulerPlan
from .dpm_solver import DPMSolverMultistepScheduler
from .flow import DiscreteFlowScheduler

SCHEDULER_MAP = {
    "DPMSolverMultistep": DPMSolverMultistepScheduler,
    "DiscreteFlow": DiscreteFlowScheduler,
}

__all__ = ["BetaSchedule", "PredictionType", "SchedulerConfig", "SchedulerPlan",
           "DPMSolverMultistepScheduler", "DiscreteFlowScheduler", "SCHEDULER_MAP"]
