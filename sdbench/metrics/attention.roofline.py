"""attention.roofline: the least time of the attention calls that the
port's dispatch sends to its flash kernel, over the device time of the
kernels the ``attention`` patterns name, for the generations wholly inside
the traced slice.  The least time is counted by the benchmark from the
configuration's shapes (the family's ``flash_calls``,
``sdbench/harness/work.py``); no implementation can read above 100 %.
Nothing is read when no attention kernel ran."""

from sdbench.harness import trace, work

LAYER = "kernels (ops/attention.py, csrc/flash_attention.cu)"
MOVES = "images_per_s"
UNIT = "%"


def read(run):
    s = run.slice
    if s is None:
        return None
    gens = [(name, a, b) for name, a, b in s.spans
            if name.startswith("sdbench.generate_images") and a >= s.start and b <= s.end]
    least = device = 0.0
    for name, a, b in gens:
        images = int(name.split("[")[1].rstrip("]"))
        least += work.attention_least_seconds(run.family.flash_calls(run.cfg, images))
        for kname, ks, ke in s.device:
            if ks >= a and ke <= b and trace.family_of(kname, run.families) == "attention":
                device += ke - ks
    if device <= 0:
        return None
    return 100.0 * least / device
