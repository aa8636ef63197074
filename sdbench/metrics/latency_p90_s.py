"""latency_p90_s: the 90th percentile of all the window's requests, each
from its due time (open loop) or its send (closed loop) to its result."""

from sdbench.harness.traffic import percentile

UNIT = "s"


def read(run):
    lat = [d.end - d.t0 for d in run.done if d.end is not None]
    return percentile(lat, 90) if lat else None
