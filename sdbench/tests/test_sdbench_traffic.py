"""The traffic generator and the window rule, against a fake server."""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest
from conftest import ROOT  # noqa: F401  (puts the checkout on sys.path)

from sdbench.harness import window
from sdbench.harness.traffic import Traffic, percentile
from sdbench.reference.pipeline import tokenize

OPEN = {"loop": "open", "rate_per_s": 20.0, "schedule_seed": 3, "image_count": 1,
        "prompt_tokens": [10, 70], "trace_slice_requests": 2}
CLOSED = dict(OPEN, loop="closed", clients=1)
TOK = {"bos": 49406, "eos": 49407, "pad": 49407, "max_length": 77}


def test_same_seed_same_traffic_and_every_seed_the_same_schedule():
    a, b = Traffic(OPEN, 2**31 + 12345).schedule(10), Traffic(OPEN, 2**31 + 12345).schedule(10)
    assert [(r.prompt, r.seed, r.due) for r in a] == [(r.prompt, r.seed, r.due) for r in b]
    c = Traffic(OPEN, 7).schedule(10)
    assert [r.prompt for r in a] != [r.prompt for r in c]
    assert not {r.seed for r in a} & {r.seed for r in c}
    # one realised schedule for every seed; a shorter window offers its prefix
    assert [r.due for r in a] == [r.due for r in c]
    assert [r.due for r in Traffic(OPEN, 7).schedule(4)] == [r.due for r in c if r.due < 4]
    assert a[0].due == 0.0 and a[-1].due < 10
    assert len({r.seed for r in a}) == len(a)
    # another schedule seed, another realisation
    other = Traffic(dict(OPEN, schedule_seed=4), 7).schedule(10)
    assert [r.due for r in other] != [r.due for r in c]


@pytest.mark.parametrize("schedule_seed", [1, 2, 3])
def test_open_loop_arrivals_are_poisson(schedule_seed):
    """Independent exponential gaps: over a long schedule the gaps' mean and
    spread are both 1/rate, and arrivals in 1 s windows have a variance
    equal to their mean, not the smoothed count of a stratified schedule."""
    mix = dict(OPEN, schedule_seed=schedule_seed, rate_per_s=2.4)
    dues = np.array([r.due for r in Traffic(mix, 5).schedule(5000)])
    gaps = np.diff(dues)
    assert gaps.mean() == pytest.approx(1 / 2.4, rel=0.05)
    assert gaps.std() == pytest.approx(1 / 2.4, rel=0.06)
    counts = np.bincount(dues.astype(int), minlength=5000)
    assert counts.var() / counts.mean() == pytest.approx(1.0, rel=0.1)
    # blocks of 8 arrivals span as widely as Poisson's: not nearly the same
    spans = dues[8::8] - dues[:-8:8]
    assert spans.std() / spans.mean() == pytest.approx(8 ** -0.5, rel=0.15)


def test_bursts_from_the_mix_parameters():
    """A burst mix is parameters only: each arrival brings 4 to 8 requests
    within 0.5 s, at the same mean rate of requests."""
    mix = dict(OPEN, rate_per_s=6.0, burst=[4, 8], burst_span_s=0.5)
    dues = np.array([r.due for r in Traffic(mix, 9).schedule(2000)])
    assert len(dues) / 2000 == pytest.approx(6.0, rel=0.1)
    gaps = np.diff(dues)
    inside = gaps[gaps < 0.5]
    assert len(inside) > 0.7 * len(gaps)  # most requests come with a burst
    per_second = np.bincount(dues.astype(int), minlength=2000)
    assert per_second.var() / per_second.mean() > 4  # far burstier than Poisson


def test_prompts_hold_10_to_70_letter_tokens():
    t = Traffic(OPEN, 99)
    counts = []
    for i in range(64):
        ids = tokenize(t.prompt(i), TOK)
        counts.append(int(((ids != TOK["eos"]) & (ids != TOK["bos"])).sum()))
    assert min(counts) == 10 and max(counts) == 70
    assert sorted(set(counts)) == sorted(set(np.linspace(10, 70, 16).round().astype(int)))


class FakeServer:
    """Answers each request after ``delay`` seconds, one at a time."""

    def __init__(self, delay: float):
        self.delay = delay
        self.sent = []
        self._lock = threading.Lock()
        self._free_at = 0.0

    def submit(self, cfg, image_hw=(512, 512)) -> Future:
        fut: Future = Future()
        now = time.perf_counter()
        with self._lock:
            start = max(now, self._free_at)
            self._free_at = start + self.delay
        self.sent.append(now)
        threading.Timer(self._free_at - now, lambda: fut.set_result(
            SimpleNamespace(latents=None, images=None))).start()
        return fut


def test_closed_loop_window_rule():
    server = FakeServer(0.05)
    seconds = 0.5
    start, done, late = window.drive(server, lambda r: r, (8, 8), Traffic(CLOSED, 3), seconds)
    assert all(t - start < seconds for t in server.sent)  # none sent after the window
    assert all(d.end is not None and d.result is not None for d in done)  # all counted
    assert max(d.end for d in done) >= start + seconds  # the last one finished after
    assert [d.request.index for d in done] == list(range(len(done)))
    assert all(d.t0 == d.sent for d in done) and late == 0.0


def test_open_loop_latency_from_the_due_time():
    server = FakeServer(0.08)  # slower than the 20/s offered: a queue builds
    start, done, late = window.drive(server, lambda r: r, (8, 8), Traffic(OPEN, 5), 0.6)
    assert len(done) == len(Traffic(OPEN, 5).schedule(0.6)) >= 8
    assert all(d.result is not None for d in done)
    for d in done:
        assert d.t0 == pytest.approx(start + d.request.due)  # timed from the due time
        assert d.sent >= d.t0
    lat = [d.end - d.t0 for d in done]
    assert lat[-1] > lat[0] + 0.2  # the queue's growth shows in the latency
    assert late < 0.05


def test_percentile():
    assert percentile([3, 1, 2], 50) == 2
    assert percentile(range(11), 90) == 9
    assert percentile([1.0, 2.0], 90) == pytest.approx(1.9)
