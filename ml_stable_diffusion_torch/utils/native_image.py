"""The native image converter (``native/image``) through ctypes (port of
ml_stable_diffusion_tpu/utils/native_image.py): ``utils/image.py`` uses it
for ``denormalize_to_uint8`` and falls back to numpy when it cannot be
built.  Both give the numpy rule's bytes."""

from __future__ import annotations

import ctypes

import numpy as np

from .native import load_library

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load():
    lib = load_library("image")
    lib.sdtpu_denormalize_to_uint8.restype = None
    lib.sdtpu_denormalize_to_uint8.argtypes = [_F32P, _U8P, ctypes.c_size_t]
    lib.sdtpu_uint8_to_float.restype = None
    lib.sdtpu_uint8_to_float.argtypes = [_U8P, _F32P, ctypes.c_size_t, ctypes.c_float,
                                         ctypes.c_float]
    return lib


def denormalize_to_uint8_native(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8, clamped; ``OSError`` without the library."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, dtype=np.uint8)
    lib.sdtpu_denormalize_to_uint8(x.ctypes.data_as(_F32P), out.ctypes.data_as(_U8P), x.size)
    return out


def uint8_to_float_native(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """uint8 -> float32 in [lo, hi]; ``OSError`` without the library."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.uint8)
    out = np.empty(x.shape, dtype=np.float32)
    lib.sdtpu_uint8_to_float(x.ctypes.data_as(_U8P), out.ctypes.data_as(_F32P), x.size, lo, hi)
    return out
