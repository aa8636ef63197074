"""geglu.roofline: the least time of the UNet's GEGLU gates, over the
device time of the kernels the ``geglu`` patterns name, for the generations
wholly inside the traced slice.

Each transformer block's feed-forward projects to ``[a | gate]``, 2 x 4C
columns at a level of C channels, and the gate computes ``a * gelu(gate)``:
the least it moves is a and the gate read once and the product written once,
three elements of the UNet's dtype for each gate element, over the card's
3.35 TB/s.  The blocks are counted from the configuration as
``work.unet_flash_calls`` counts them, every level (no token threshold), at
the CFG batch of two rows an image, for each of ``step_count`` steps.
Nothing is read when no such kernel ran (a program that leaves the gate to
PyTorch's elementwise kernels)."""

from sdbench.harness import trace, work

LAYER = "kernels (ops/activations.py, csrc/geglu.cu)"
MOVES = "images_per_s"
UNIT = "%"


def gate_elements(cfg: dict, images: int) -> int:
    """Gate elements of one UNet call at the CFG batch of ``images``."""
    c = cfg["unet"]["config"]
    ch, depth, L = c["block_out_channels"], c["transformer_layers_per_block"], \
        c["layers_per_block"]
    n = len(ch)
    blocks = [0] * n
    for bi, kind in enumerate(c["down_block_types"]):
        if kind == "CrossAttnDownBlock2D":
            blocks[bi] += L * depth[bi]
    for bi, kind in enumerate(c["up_block_types"]):
        if kind == "CrossAttnUpBlock2D":
            blocks[n - 1 - bi] += (L + 1) * depth[n - 1 - bi]
    blocks[n - 1] += depth[n - 1]  # the mid block, at the last level
    tokens = cfg["image_hw"][0] // 8 * cfg["image_hw"][1] // 8
    return sum(2 * images * (tokens // 4 ** lv) * 4 * ch[lv] * count
               for lv, count in enumerate(blocks))


def least_seconds(cfg: dict, images: int) -> float:
    """The least time of a generation's GEGLU gates."""
    size = 2 if cfg["unet"]["dtype"] == "bfloat16" else 4
    return cfg["step_count"] * gate_elements(cfg, images) * 3 * size / work.PEAK_BYTES_PER_S


def read(run):
    s = run.slice
    if s is None:
        return None
    least = device = 0.0
    for name, a, b in s.spans:
        if not (name.startswith("sdbench.generate_images") and a >= s.start and b <= s.end):
            continue
        least += least_seconds(run.cfg, int(name.split("[")[1].rstrip("]")))
        for kname, ks, ke in s.device:
            if ks >= a and ke <= b and trace.family_of(kname, run.families) == "geglu":
                device += ke - ks
    if device <= 0:
        return None
    return 100.0 * least / device
