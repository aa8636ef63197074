"""The measured window: traffic into ``GenerationServer.submit``, every
request timed from when it was due (open loop) or sent (closed loop) to its
result.

The window starts when set-up ends.  No request is sent after ``seconds``;
every request sent is waited for and counts.  A rate is the images of all
completed requests over the time from the window's start to the last
completion.

``Recorder`` is the benchmark's own span around the pipeline: the server is
handed a proxy whose ``generate_images`` notes each call's start, end,
images, steps and seeds, so that the per-layer readers can tell queue wait
from generation.  It also notes host spans named ``sdbench.*``, the call's
carrying its image count (``sdbench.generate_images[N]``), its host inputs
and its decode: the traced run names the device's idle gaps by them.  They
are taken on the host clock, in whatever thread runs the call (the
profiler records ``record_function`` spans of its own thread only).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future

from .traffic import Request, Traffic

#: how long after the window's close the last results may take
DRAIN_S = 120.0


@dataclasses.dataclass
class Call:
    start: float
    end: float
    images: int
    steps: int
    seeds: tuple[int, ...]
    text_rows: int


@dataclasses.dataclass
class Done:
    request: Request
    sent: float
    #: the latency's start: the due time (open loop) or the send time
    t0: float
    end: float | None = None
    result: object = None
    error: BaseException | None = None
    future: Future | None = None


class Recorder:
    """Wraps ``pipeline``: while ``recording``, the calls into
    ``generate_images`` as ``Call``s, and the host spans (name, start, end)
    of each call, of its host inputs and of its decode."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.calls: list[Call] = []
        self.spans: list[tuple[str, float, float]] = []
        self.recording = False
        self._lock = threading.Lock()
        for name, span in (("_host_inputs", "sdbench.host_inputs"),
                           ("decode_latents", "sdbench.decode")):
            setattr(pipeline, name, self._spanned(getattr(pipeline, name), span))

    def _spanned(self, fn, span):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self._note(span, t0)
        return call

    def _note(self, span, t0):
        if self.recording:
            with self._lock:
                self.spans.append((span, t0, time.perf_counter()))

    def __getattr__(self, name):
        return getattr(self.pipeline, name)

    def generate_images(self, cfg, progress_handler=None, image_hw=(512, 512)):
        t0 = time.perf_counter()
        out = self.pipeline.generate_images(cfg, progress_handler=progress_handler,
                                            image_hw=image_hw)
        t1 = time.perf_counter()
        self._note(f"sdbench.generate_images[{cfg.image_count}]", t0)
        if self.recording:
            seeds = tuple(cfg.seed) if isinstance(cfg.seed, (list, tuple)) else (cfg.seed,)
            rows = 2 * cfg.image_count if isinstance(cfg.prompt, (list, tuple)) else 2
            with self._lock:
                self.calls.append(Call(t0, t1, cfg.image_count, cfg.step_count, seeds, rows))
        return out


def drive(server, make_cfg, image_hw, traffic: Traffic, seconds: float,
          tracer=None) -> tuple:
    """Run the window -> (window start, [Done], generator lateness in s).

    ``make_cfg(request)`` -> the request's ``PipelineConfiguration``.
    ``tracer``: an object with ``begin()`` and ``end()``, called around the
    whole requests that ``traffic.mix["trace_slice_requests"]`` counts: a
    closed loop's from its second request on, an open loop's last ones, so
    that stopping the profiler (seconds) never holds up a request that is
    due."""
    done: list[Done] = []
    n_slice = int(traffic.mix.get("trace_slice_requests", 1))
    state = {"began": False, "ended": False}
    schedule = traffic.schedule(seconds) if traffic.open_loop else None
    first = max(1, len(schedule) - n_slice) if schedule else 1

    def send(req: Request, due: float | None = None) -> Done:
        if tracer is not None and req.index == first:
            t = time.perf_counter()
            tracer.begin()
            state["began"] = True
            state["start_s"] = time.perf_counter() - t
        sent = time.perf_counter()
        d = Done(req, sent, sent if due is None else due)
        fut: Future = server.submit(make_cfg(req), image_hw=tuple(image_hw))

        def finished(f: Future, d=d):
            if f.exception() is not None:
                d.error = f.exception()
            else:
                d.result = f.result()
            d.end = time.perf_counter()

        d.future = fut
        done.append(d)
        fut.add_done_callback(finished)
        return d

    def slice_over(force: bool = False):
        """End a closed loop's traced slice once its requests have all
        returned; ``force``: end it now."""
        if state["began"] and not state["ended"] and (
                force or (len(done) > n_slice
                          and all(d.end is not None for d in done[1:1 + n_slice]))):
            t = time.perf_counter()
            tracer.end()
            state["ended"] = True
            state["stop_s"] = time.perf_counter() - t

    start = time.perf_counter()
    late = 0.0
    if traffic.open_loop:
        for req in schedule:
            due = start + req.due
            while (now := time.perf_counter()) < due:
                time.sleep(min(due - now, 0.01))
            late = max(late, time.perf_counter() - due)
            send(req, due)
        _wait(done)
    else:
        i = 0
        while time.perf_counter() - start < seconds:
            _wait([send(traffic.request(i))])
            slice_over()
            i += 1
    slice_over(force=True)
    _wait(done)
    if state["began"]:
        #: seconds the profiler's start and stop held the window
        tracer.cost_s = (state["start_s"], state["stop_s"])
    return start, done, late


def _wait(ds):
    deadline = time.perf_counter() + DRAIN_S
    for d in ds:
        try:
            d.future.result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:  # noted by the callback; the check counts it
            pass
        while d.end is None and time.perf_counter() < deadline:  # callback pending
            time.sleep(0.001)
