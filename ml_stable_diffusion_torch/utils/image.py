"""Image layout helpers (port of ml_stable_diffusion_tpu/utils/image.py).

Decoded images leave the pipeline as (N, H, W, 3) uint8 numpy arrays.  PIL
is imported only by ``to_pil``, ``open_image`` and ``pil_to_tensor``
(starting images and masks given as PIL images, and resizes), so nothing on
the txt2img path needs it, and the command line reads and writes PNG files
at the output size through ``utils/png.py``; where Pillow is needed and
missing they raise ``ImportError``.
"""

from __future__ import annotations

import numpy as np


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("pillow is required for image IO (resizing, or a file that "
                          "utils/png.py does not read)") from e
    return Image


def denormalize_to_uint8_numpy(x: np.ndarray) -> np.ndarray:
    """[-1,1] float -> uint8 by the native converter's float32 rule:
    ``uint8(clamp(x * 0.5 + 0.5, 0, 1) * 255 + 0.5)``, halves rounded up
    (``np.round`` would round them to even: a few of a million values
    differ); NaN gives 0."""
    x = np.asarray(x, dtype=np.float32)
    v = np.clip(x * np.float32(0.5) + np.float32(0.5), np.float32(0.0), np.float32(1.0))
    v = np.nan_to_num(v, nan=0.0)
    return (v * np.float32(255.0) + np.float32(0.5)).astype(np.uint8)


def denormalize_to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1,1] float NHWC -> uint8 NHWC (clamped): the native converter
    (``utils/native_image.py``) where it builds, else the same rule in
    numpy."""
    try:
        from .native_image import denormalize_to_uint8_native

        return denormalize_to_uint8_native(x)
    except OSError:
        return denormalize_to_uint8_numpy(x)


def to_pil(images: np.ndarray) -> list:
    """(N, H, W, 3) uint8 -> list of PIL RGB images."""
    Image = _pil()
    return [Image.fromarray(im) for im in np.asarray(images, np.uint8)]


def open_image(path):
    """``PIL.Image.open(path)``."""
    return _pil().open(path)


def pil_to_tensor(images, size: tuple[int, int] | None = None,
                  value_range: tuple[float, float] = (-1.0, 1.0),
                  mask_alpha: bool = True) -> np.ndarray:
    """PIL image(s) -> NHWC float32 in ``value_range``.  ``size``: an
    optional (H, W) LANCZOS resize; ``mask_alpha``: fully transparent
    pixels become 0 before the range is applied."""
    Image = _pil()

    if not isinstance(images, (list, tuple)):
        images = [images]
    out = []
    for im in images:
        if size is not None:
            im = im.resize((size[1], size[0]), Image.LANCZOS)
        out.append(rgba_to_range(np.asarray(im.convert("RGBA")), value_range, mask_alpha))
    return np.stack(out, axis=0).astype(np.float32)


def rgba_to_range(rgba: np.ndarray, value_range: tuple[float, float] = (-1.0, 1.0),
                  mask_alpha: bool = True) -> np.ndarray:
    """(H, W, 4) uint8 RGBA -> (H, W, 3) float32 in ``value_range``;
    ``mask_alpha``: fully transparent pixels become 0 first.  The one
    arithmetic of ``pil_to_tensor`` and ``utils/png.py:to_tensor``."""
    lo, hi = value_range
    rgba = np.asarray(rgba, dtype=np.float32)
    rgb = rgba[..., :3] / 255.0
    if mask_alpha:
        rgb = rgb * (rgba[..., 3:4] / 255.0 > 0)
    return rgb * (hi - lo) + lo


def nchw_to_nhwc(x: np.ndarray) -> np.ndarray:
    return np.transpose(x, (0, 2, 3, 1))


def nhwc_to_nchw(x: np.ndarray) -> np.ndarray:
    return np.transpose(x, (0, 3, 1, 2))
