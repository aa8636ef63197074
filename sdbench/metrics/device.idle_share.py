"""device.idle_share: the share of the traced slice of whole requests in
which no kernel, copy or set ran on the card (the union of the device
events' intervals from the profiler, against the slice's length)."""

LAYER = "device"
MOVES = "images_per_s"
UNIT = "%"


def read(run):
    if run.slice is None or run.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.window_s)
