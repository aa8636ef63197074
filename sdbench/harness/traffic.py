"""The one traffic generator.  A traffic mix is a JSON file of parameters
(``sdbench/traffic/<name>.json``):

- ``loop``: ``"open"`` (requests due on a schedule, whatever the server
  does) or ``"closed"`` (``clients`` clients, each sending its next request
  when its last one returned);
- ``rate_per_s`` (open loop): the mean arrival rate of requests;
- ``schedule_seed`` (open loop): the seed of the one realised schedule that
  every run of the mix offers;
- ``burst`` (open loop, default [1, 1]): [least, most] requests that one
  arrival brings, each count equally likely;
- ``burst_span_s`` (open loop, default 0): the seconds over which one
  arrival's requests fall, uniformly;
- ``clients`` (closed loop): 1, the one client the window drives;
- ``image_count``: images a request asks for;
- ``prompt_tokens``: [least, most] letter tokens a prompt has (the
  negative prompt is empty, as the configurations state);
- ``trace_slice_requests``: how many whole requests the traced run's
  profiler follows.

An open loop is a Poisson process of arrivals: the first at the window's
start, then independent exponential gaps at ``rate_per_s`` over the mean
burst, each arrival bringing its burst.  The gaps, bursts and spans are
drawn once from ``schedule_seed``, not from the run's seed, so every run
offers the same realised schedule, and a shorter window offers a prefix of
a longer one's.  The run's seed draws the rest: the letters of each
prompt, the order in which prompt lengths cycle through the same evenly
spread set, and each request's noise seed (distinct within a run).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..reference.pipeline import LETTERS

#: prompt lengths a cycle holds
_LENGTHS = 16
#: distinct request seeds: seed_i = (base + i * _STEP) mod 2**32, _STEP odd
_STEP = 2654435761


@dataclasses.dataclass
class Request:
    index: int
    prompt: str
    seed: int
    image_count: int
    #: seconds after the window's start at which an open loop sends it
    due: float | None = None


class Traffic:
    def __init__(self, mix: dict, seed: int):
        if mix["loop"] == "closed" and mix.get("clients", 1) != 1:
            raise ValueError("a closed loop is driven by one client")
        self.mix = mix
        self.seed = int(seed)
        self._rng = np.random.default_rng([self.seed, 0x5D])
        lo, hi = mix["prompt_tokens"]
        self._lengths = self._rng.permutation(np.linspace(lo, hi, _LENGTHS).round().astype(int))
        self._base = int(self._rng.integers(0, 2**32))

    @property
    def open_loop(self) -> bool:
        return self.mix["loop"] == "open"

    def prompt(self, i: int) -> str:
        """Words of 2-9 letters, ``_lengths[i % 16]`` letters in all."""
        rng = np.random.default_rng([self.seed, 0x9E, i])
        n, words = int(self._lengths[i % _LENGTHS]), []
        while n > 0:
            k = min(n, int(rng.integers(2, 10)))
            if 0 < n - k < 2:  # no one-letter tail word
                k = n
            words.append("".join(LETTERS[j] for j in rng.integers(0, 26, size=k)))
            n -= k
        return " ".join(words)

    def request(self, i: int, due: float | None = None) -> Request:
        return Request(i, self.prompt(i), (self._base + i * _STEP) % 2**32,
                       int(self.mix["image_count"]), due)

    def schedule(self, seconds: float) -> list[Request]:
        """Open loop: the requests due inside ``seconds``, in order."""
        return [self.request(i, d) for i, d in enumerate(arrivals(self.mix, seconds))]


def arrivals(mix: dict, seconds: float) -> list[float]:
    """An open loop's due times inside ``seconds``, drawn from the mix's
    ``schedule_seed`` alone."""
    rng = np.random.default_rng([int(mix["schedule_seed"]), 0xA7])
    lo, hi = mix.get("burst", [1, 1])
    span = float(mix.get("burst_span_s", 0.0))
    event_rate = float(mix["rate_per_s"]) / ((lo + hi) / 2.0)
    dues, t = [], 0.0
    while t < seconds:
        k = int(rng.integers(lo, hi + 1))
        dues += [t + o for o in (rng.uniform(0.0, span, k) if span > 0 else [0.0] * k)]
        t += float(rng.exponential(1.0 / event_rate))
    return sorted(d for d in dues if d < seconds)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
