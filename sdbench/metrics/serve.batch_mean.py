"""serve.batch_mean: the requests a ``generate_images`` call served, on
average: the window's completed requests over the pipeline calls that
served them (the benchmark's span around the pipeline)."""

LAYER = "serving (serving.py)"
MOVES = "latency_p90_s"
UNIT = "requests"


def read(run):
    served = [d for d in run.done if d.result is not None]
    calls = {id(c): c for d in served if (c := run.call_of(d.request.seed)) is not None}
    if not calls:
        return None
    return len(served) / len(calls)
