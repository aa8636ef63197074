"""Whether the timed path produced the right images: ``correct``.

Once the window has closed and the program is freed, a sample of the
images its requests received, drawn from the seed, is worked out again by
the plain reference (``sdbench/reference``, built by the configuration's
family file) from each request's prompt and seed alone.  The sample holds
one image of every position in a request (the n-th of n images runs in
the n-th slot of the denoiser's batch) before it draws more at random.
Two numbers are compared, each against the limit the configuration file
states:

- ``latent_rel_rms``: for each sampled image, the relative RMS distance of
  the final latents the program returned from the reference's, over the
  whole generation (tokens, text encoders, every UNet call with CFG, the
  DPM-Solver++ steps); the widest over the sample;
- ``pixel_mean_abs``: for each sampled image, the mean absolute difference,
  in 8-bit levels, of the program's image from the reference decoder's
  image of the program's own latents: the VAE decoder and the uint8
  conversion alone; the widest over the sample.

A request that failed or never returned is not correct either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.pipeline import Reference, noise, tf32

NUMBERS = ("latent_rel_rms", "pixel_mean_abs")


def sample(done, cfg: dict, seed: int) -> list[tuple[object, int]]:
    """(Done, image index) of the images to check, drawn from the seed:
    one of each image index first, then the rest at random."""
    pool = [(d, j) for d in done if d.result is not None
            for j in range(d.request.image_count)]
    k = min(int(cfg["check"]["images"]), len(pool))
    rng = np.random.default_rng([int(seed), 0xC4EC])
    picked = []
    for j in sorted({j for _, j in pool})[:k]:
        picked.append(int(rng.choice([i for i, (_, jj) in enumerate(pool) if jj == j])))
    rest = [i for i in range(len(pool)) if i not in picked]
    picked += [rest[i] for i in rng.choice(len(rest), size=k - len(picked), replace=False)]
    return [pool[i] for i in sorted(picked)]


def _latent_shape(cfg):
    H, W = cfg["image_hw"]
    return (cfg["vae_decoder"]["config"]["latent_channels"], H // 8, W // 8)


def rel_rms(a: np.ndarray, ref: np.ndarray) -> float:
    a64, r64 = a.astype(np.float64), ref.astype(np.float64)
    return float(np.sqrt(((a64 - r64) ** 2).sum() / max((r64 ** 2).sum(), 1e-30)))


def compare(ref: Reference, cfg: dict, items, outputs) -> dict:
    """``items``: [(prompt, seed, images in its stream, index)];
    ``outputs``: [(latents NHWC (h, w, C), image (H, W, 3) uint8)] of the
    side under test.  -> {number: [per-image values]}."""
    shape = _latent_shape(cfg)
    group = int(cfg["check"]["group"])
    out = {n: [] for n in NUMBERS}
    for lo in range(0, len(items), group):
        part = items[lo:lo + group]
        init = np.stack([noise(s, n, shape)[j] for _, s, n, j in part])
        prompts = [p for p, _, _, _ in part]
        with tf32(False):
            want = ref.denoise(prompts, "", init).permute(0, 2, 3, 1).cpu().numpy()
        got = np.stack([o[0] for o in outputs[lo:lo + group]])
        images = np.stack([o[1] for o in outputs[lo:lo + group]])
        with tf32(False):
            decoded = ref.decode(got)
        for i in range(len(part)):
            out["latent_rel_rms"].append(rel_rms(got[i], want[i]))
            out["pixel_mean_abs"].append(float(np.abs(
                images[i].astype(np.int16) - decoded[i].astype(np.int16)).mean()))
    return out


def run(family, cfg: dict, seed: int, done, device) -> dict:
    """-> {"numbers": {name: widest}, "per_image": {...}, "images": k};
    ``family``: the configuration's family module, whose ``reference``
    builds the plain reference."""
    picked = sample(done, cfg, seed)
    items = [(d.request.prompt, d.request.seed, d.request.image_count, j) for d, j in picked]
    outputs = [(d.result.latents[j], d.result.images[j]) for d, j in picked]
    with tf32(False):
        ref = family.reference(cfg, seed, device)
        per = compare(ref, cfg, items, outputs)
        del ref
    return {"numbers": {n: max(v) if v else None for n, v in per.items()},
            "per_image": per, "images": len(items)}


def verdict(numbers: dict, limits: dict, failed: int) -> bool:
    """Correct: no failed request, and every number read and at or under
    its limit (a limit not yet set fails)."""
    return failed == 0 and all(
        limits.get(n) is not None and v is not None and np.isfinite(v) and v <= limits[n]
        for n, v in numbers.items())


def free_card():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
