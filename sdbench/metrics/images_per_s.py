"""images_per_s: the images of all completed requests over the time from
the window's start to the last completion."""

UNIT = "images/s"


def read(run):
    if run.window_end <= run.window_start:
        return None
    return sum(d.request.image_count for d in run.done if d.result is not None) / (
        run.window_end - run.window_start)
