"""serve.queue_wait_p90_s: the 90th percentile over the window's requests
of the time from a request's due time (open loop) or send time (closed
loop) to the start of the ``generate_images`` call that served it."""

from sdbench.harness.traffic import percentile

LAYER = "serving (serving.py)"
MOVES = "latency_p90_s"
UNIT = "s"


def read(run):
    waits = [c.start - d.t0 for d in run.done if d.result is not None
             and (c := run.call_of(d.request.seed)) is not None]
    return percentile(waits, 90) if waits else None
