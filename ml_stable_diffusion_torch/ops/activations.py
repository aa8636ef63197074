"""GELU variants (port of ml_stable_diffusion_tpu/ops/activations.py).

The same functions computed in float32 and cast back to the input dtype.

The UNet feed-forward's GEGLU gate, ``a * gelu(gate)`` over the two halves of
its projection, has a hand-written CUDA kernel, ``csrc/geglu.cu``, built for
``sm_90a`` on first use (utils/cuda_build.py) and called through ctypes: one
pass that reads the projection once and writes the product once, bit-equal
to the plain chain below.  The JAX package leaves the same expression to
XLA, which fuses it.  Entry points:

- ``geglu_cuda``: the kernel wrapper.  It launches the kernel on a CUDA
  tensor or raises, and counts its launches in ``.launches``;
- ``geglu``: the dispatch.  A tensor off the card (the CPU, or the meta
  device where shapes are recorded) takes the plain chain, and so does any
  tensor inside ``plain_geglu()``, which the training step enters (the
  kernel has no backward); a CUDA tensor otherwise goes to ``geglu_cuda``,
  which raises under grad as the other kernel wrappers do.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..utils import cuda_build

_INV_SQRT2 = 0.7071067811865476
_SQRT_2_OVER_PI = 0.7978845608028654


def gelu_erf(x):
    """Exact GELU via f32 ``erf``."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf * _INV_SQRT2))).to(x.dtype)


def gelu_tanh(x):
    """Tanh-approximate GELU, as ``x * sigmoid(2z)``."""
    xf = x.float()
    z = _SQRT_2_OVER_PI * (xf + 0.044715 * (xf * xf * xf))
    return (xf * torch.sigmoid(2.0 * z)).to(x.dtype)


def quick_gelu(x):
    """CLIP's quick_gelu: ``x * sigmoid(1.702 x)``."""
    xf = x.float()
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict = {}


def _kernel():
    fn = _fns.get("fwd")
    if fn is None:
        fn = cuda_build.load("geglu").geglu_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["fwd"] = fn
    return fn


def geglu_cuda(h, fast: bool = False):
    """``a * gelu(gate)`` of a contiguous CUDA ``h = [a | gate]`` (last
    dimension 2n, float32 or bfloat16) by the hand-written kernel -> (..., n)
    in h's dtype.  ``fast``: quick_gelu in place of the exact GELU.  Raises
    for anything the kernel does not take."""
    cuda_build.refuse_grad("geglu_cuda", "geglu inside plain_geglu(), as the training "
                           "step runs it", h)
    if h.dtype not in _DTYPE_CODES:
        raise ValueError(f"geglu_cuda takes float32 or bfloat16 h, got {h.dtype}")
    if h.ndim == 0 or h.shape[-1] % 2 or h.numel() == 0:
        raise ValueError(f"geglu_cuda needs a non-empty h with an even last dimension, got "
                         f"{tuple(h.shape)}")
    if not h.is_contiguous():
        raise ValueError(f"geglu_cuda takes a contiguous h, got strides {h.stride()} for "
                         f"shape {tuple(h.shape)}")
    if h.device.type != "cuda":
        raise ValueError(f"geglu_cuda needs a CUDA tensor; h is on {h.device}")
    if h.data_ptr() % 16:
        h = h.clone()  # the kernel's 16-byte loads need an aligned base
    n = h.shape[-1] // 2
    out = h.new_empty(*h.shape[:-1], n)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = _kernel()(h.data_ptr(), out.data_ptr(), h.numel() // (2 * n), n,
                       _DTYPE_CODES[h.dtype], int(fast), stream)
    if rc != 0:
        raise RuntimeError(f"geglu kernel launch failed with CUDA error {rc} at h "
                           f"{tuple(h.shape)} {h.dtype}")
    geglu_cuda.launches += 1
    return out


geglu_cuda.launches = 0


#: open ``plain_geglu()`` contexts
_plain_depth = 0


@contextlib.contextmanager
def plain_geglu():
    """Inside, ``geglu`` computes the plain chain on every device: the
    training step's choice (``parallel/train.py``), since the kernel has
    no backward."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def geglu(h, fast: bool = False):
    """The GEGLU gate over ``h = [a | gate]``: ``a * gelu_erf(gate)``, or
    ``a * quick_gelu(gate)`` with ``fast``.  The kernel on a CUDA tensor
    outside ``plain_geglu()``; otherwise the plain chain."""
    if h.device.type != "cuda" or _plain_depth:
        a, gate = h.chunk(2, dim=-1)
        return a * (quick_gelu if fast else gelu_erf)(gate)
    return geglu_cuda(h, fast)
