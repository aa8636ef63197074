"""The traced run's device record: ``torch.profiler`` (CUPTI) over a bounded
slice of whole requests, read in memory.  No Chrome trace is written.

``Slice`` holds, in seconds on the profiler's clock, the slice's bounds,
every device event (kernels, copies, sets) with its name, and the
benchmark's host spans (``sdbench.*``), put on that clock by the offset
the slice's own span gives.  ``kernel families`` come from the pattern files of
``sdbench/kernels/<family>.json``: ``{"priority": n, "patterns": [...]}``,
lowercase substrings of a kernel's name; the family of the lowest priority
whose pattern matches wins, and a name no file matches is ``other``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import torch

KERNELS_DIR = Path(__file__).resolve().parents[1] / "kernels"


def families(kernels_dir: Path = KERNELS_DIR) -> list[tuple[int, str, tuple[str, ...]]]:
    out = []
    for path in sorted(kernels_dir.glob("*.json")):
        spec = json.loads(path.read_text())
        out.append((int(spec["priority"]), path.stem,
                    tuple(p.lower() for p in spec["patterns"])))
    return sorted(out)


def family_of(name: str, fams) -> str:
    low = name.lower()
    return next((fam for _, fam, pats in fams if any(p in low for p in pats)), "other")


@dataclasses.dataclass
class Slice:
    start: float
    end: float
    #: (name, start, end) of every device event
    device: list[tuple[str, float, float]]
    #: (name, start, end) of the ``sdbench.*`` host spans
    spans: list[tuple[str, float, float]] = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device events inside the slice, merged."""
        iv = sorted((max(s, self.start), min(e, self.end)) for _, s, e in self.device
                    if e > self.start and s < self.end)
        merged: list[list[float]] = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self) -> list[tuple[str, float]]:
        """Each gap between device work inside the slice, named by the
        innermost host span in progress at its middle."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = []
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                mid = 0.5 * (s + e)
                around = [sp for sp in self.spans if sp[1] <= mid <= sp[2]]
                name = (min(around, key=lambda sp: sp[2] - sp[1])[0] if around
                        else "no benchmark span (between requests)")
                gaps.append((name, e - s))
        return gaps

    def device_time(self, fams) -> dict[str, float]:
        """Seconds of device events by family, clipped to the slice."""
        out: dict[str, float] = {}
        for name, s, e in self.device:
            d = min(e, self.end) - max(s, self.start)
            if d > 0:
                fam = family_of(name, fams)
                out[fam] = out.get(fam, 0.0) + d
        return out


class Tracer:
    """``begin()`` starts the profiler and opens the slice's span, ``end()``
    synchronises and closes both; ``finish()``, once the window has closed,
    reads the events (reading them takes seconds, which the window does not
    pay)."""

    def __init__(self):
        self.slice: Slice | None = None
        self._prof = None
        self._span = None

    @staticmethod
    def _activities():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def warm_up(self):
        """A first profiler session initialises CUPTI: do it in set-up."""
        with torch.profiler.profile(activities=self._activities()):
            torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def begin(self):
        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.start()
        self._span = torch.profiler.record_function("sdbench.slice")
        self._host_begin = time.perf_counter()
        self._span.__enter__()

    def end(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.stop()

    def finish(self, spans) -> Slice | None:
        """After the window: read the events into ``self.slice`` and put the
        host spans (``time.perf_counter``) on it, by the offset of the
        profiler's clock from the host's that the slice's span gives."""
        if self._prof is None:
            return None
        self.slice = read(self._prof)
        self._prof = None
        offset = self.slice.start - self._host_begin
        self.slice.spans = [(n, a + offset, b + offset) for n, a, b in spans]
        return self.slice


def _ns(ev, what: str) -> int:
    if hasattr(ev, f"{what}_ns"):
        return int(getattr(ev, f"{what}_ns")())
    return int(getattr(ev, f"{what}_us")()) * 1000


def read(prof) -> Slice:
    """The profiler's events -> a ``Slice`` (seconds, the profiler's clock)."""
    device, bounds = [], None
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((ev.name(), start * 1e-9, end * 1e-9))
        elif ev.name() == "sdbench.slice":
            bounds = (start * 1e-9, end * 1e-9)
    if bounds is None:
        raise RuntimeError("the profiler recorded no sdbench.slice span")
    return Slice(bounds[0], bounds[1], device)
