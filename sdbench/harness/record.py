"""What a run hands the metric readers (``sdbench/metrics/<name>.py``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RunRecord:
    #: the configuration file and the traffic mix, as loaded
    cfg: dict
    mix: dict
    #: host clock (``time.perf_counter``) of the window's start and of its
    #: last completion
    window_start: float
    window_end: float
    #: every request of the window (``window.Done``), in the order sent
    done: list
    #: the pipeline calls of the window (``window.Call``)
    calls: list
    #: the configuration's family module (``sdbench/families/<family>.py``)
    family: object = None
    #: process start to the window's start, in seconds
    setup_s: float = 0.0
    #: ``torch.cuda.max_memory_reserved()`` at the window's end
    peak_bytes: int = 0
    #: the traced slice (``trace.Slice``), or None without one
    slice: object = None
    #: the kernel families (``trace.families()``)
    families: list = dataclasses.field(default_factory=list)
    #: seconds of the window in which the profiler started or stopped (a
    #: closed loop's client waits for it; no request is served meanwhile)
    profiler_s: float = 0.0

    def call_of(self, seed: int):
        """The pipeline call that served the request of ``seed``."""
        return next((c for c in self.calls if seed in c.seeds), None)
