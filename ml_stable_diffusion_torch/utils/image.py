"""Image layout helpers (port of ml_stable_diffusion_tpu/utils/image.py).

Decoded images leave the pipeline as (N, H, W, 3) uint8 numpy arrays.  PIL
is imported only by ``to_pil`` and ``pil_to_tensor`` (starting images and
masks given as PIL images), so nothing on the txt2img path needs it.
"""

from __future__ import annotations

import numpy as np


def denormalize_to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1,1] float NHWC -> uint8 NHWC (clamped)."""
    x = np.asarray(x, dtype=np.float32)
    return (np.clip(x / 2.0 + 0.5, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def to_pil(images: np.ndarray) -> list:
    """(N, H, W, 3) uint8 -> list of PIL RGB images."""
    from PIL import Image

    return [Image.fromarray(im) for im in np.asarray(images, np.uint8)]


def pil_to_tensor(images, size: tuple[int, int] | None = None,
                  value_range: tuple[float, float] = (-1.0, 1.0),
                  mask_alpha: bool = True) -> np.ndarray:
    """PIL image(s) -> NHWC float32 in ``value_range``.  ``size``: an
    optional (H, W) LANCZOS resize; ``mask_alpha``: fully transparent
    pixels become 0 before the range is applied."""
    from PIL import Image

    if not isinstance(images, (list, tuple)):
        images = [images]
    lo, hi = value_range
    out = []
    for im in images:
        if size is not None:
            im = im.resize((size[1], size[0]), Image.LANCZOS)
        rgba = np.asarray(im.convert("RGBA"), dtype=np.float32)
        rgb = rgba[..., :3] / 255.0
        if mask_alpha:
            rgb = rgb * (rgba[..., 3:4] / 255.0 > 0)
        out.append(rgb * (hi - lo) + lo)
    return np.stack(out, axis=0).astype(np.float32)


def nchw_to_nhwc(x: np.ndarray) -> np.ndarray:
    return np.transpose(x, (0, 2, 3, 1))


def nhwc_to_nchw(x: np.ndarray) -> np.ndarray:
    return np.transpose(x, (0, 3, 1, 2))
