"""serve.send_to_start_ms: the mean over the window's served requests of
the time from a request's send to the start of the ``generate_images``
call that served it (the benchmark's span around the pipeline), in
milliseconds.  For a lone client it is what the server's batching window
and its hand-off to the worker cost every request."""

LAYER = "serving (serving.py)"
MOVES = "images_per_s"
UNIT = "ms"


def read(run):
    waits = [c.start - d.sent for d in run.done if d.result is not None
             and (c := run.call_of(d.request.seed)) is not None]
    return 1e3 * sum(waits) / len(waits) if waits else None
