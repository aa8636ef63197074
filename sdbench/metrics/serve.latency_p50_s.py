"""serve.latency_p50_s: the median of all the window's requests, each from
its due time (open loop) or its send (closed loop) to its result.  Below
the knee it falls where a request either runs at once or waits for the
batch in flight, so it swings between runs; the tail, ``latency_p90_s``,
is what the cell holds to a bound."""

from sdbench.harness.traffic import percentile

LAYER = "serving (serving.py)"
MOVES = "latency_p90_s"
UNIT = "s"


def read(run):
    lat = [d.end - d.t0 for d in run.done if d.end is not None]
    return percentile(lat, 50) if lat else None
