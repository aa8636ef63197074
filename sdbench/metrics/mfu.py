"""mfu: the operations of every model call in the window (the text
encoders' rows, the UNet at each step's CFG batch, the VAE decoder's
images), counted from the configuration's shapes over the plain reference
on the meta device (the family's ``model_flops``,
``sdbench/harness/work.py``), over the window's wall seconds times the
card's bf16 peak (989 TFLOP/s).  The seconds in which a
closed loop's client waited for the profiler to start or stop are not the
system's and are left out."""

from sdbench.harness import work

LAYER = "the whole generation"
MOVES = "images_per_s"
UNIT = "%"


def read(run):
    if not run.calls or run.window_end <= run.window_start:
        return None
    f = run.family.model_flops(run.cfg)
    ops = sum(work.generation_flops(f, c.text_rows, c.images, c.steps) for c in run.calls)
    seconds = run.window_end - run.window_start - run.profiler_s
    return 100.0 * ops / (seconds * work.PEAK_BF16)
