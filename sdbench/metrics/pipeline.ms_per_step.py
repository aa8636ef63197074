"""pipeline.ms_per_step: the time inside ``generate_images`` over the
window's calls (text encoding, the denoise loop, the decode and the host
copies) over the denoising steps those calls ran, in milliseconds."""

LAYER = "pipelines and programs (pipelines/sd.py, sdxl.py, program.py)"
MOVES = "images_per_s"
UNIT = "ms"


def read(run):
    steps = sum(c.steps for c in run.calls)
    if not steps:
        return None
    return 1e3 * sum(c.end - c.start for c in run.calls) / steps
