"""mmdit.attention.roofline: the least time of the attention calls that the
port sends to its flash kernel in an SD3 generation, over the device time
of the kernels the ``attention`` patterns name, for the generations wholly
inside the traced slice.  The calls, counted by the benchmark from the
configuration's shapes (``sdbench/families/sd3.py``): the joint attention
of every block at every step (the multi-stream entry; its least time is the
family's ``joint_least_seconds``), the dual blocks' self-attention
(``flash_calls``) and the VAE's float32 head.  Each call's least time is the
larger of its q, k, v and o moved once over 3.35 TB/s and its 4 B H Sq Sk D
operations over the peak for its dtype; no implementation can read above
100 %.  Nothing is read when no attention kernel ran, or for a family
without joint attention."""

from sdbench.harness import trace, work

LAYER = "kernels (ops/attention.py, csrc/flash_attention.cu)"
MOVES = "images_per_s"
UNIT = "%"


def read(run):
    s = run.slice
    joint = getattr(run.family, "joint_least_seconds", None)
    if s is None or joint is None:
        return None
    least = device = 0.0
    for name, a, b in s.spans:
        if not (name.startswith("sdbench.generate_images") and a >= s.start and b <= s.end):
            continue
        images = int(name.split("[")[1].rstrip("]"))
        least += joint(run.cfg, images) + work.attention_least_seconds(
            run.family.flash_calls(run.cfg, images))
        for kname, ks, ke in s.device:
            if ks >= a and ke <= b and trace.family_of(kname, run.families) == "attention":
                device += ke - ks
    if device <= 0:
        return None
    return 100.0 * least / device
