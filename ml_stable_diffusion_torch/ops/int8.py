"""W8A8 int8 serving ops (port of ml_stable_diffusion_tpu/ops/int8.py).

Symmetric per-tensor int8 activations (a static absmax from calibration,
``compress/w8a8.py``) times per-output-channel int8 weights, accumulated in
int32 and rescaled in float32.  The JAX package runs these products through
XLA (``preferred_element_type=int32``), with no Pallas kernel; here the
product is ``torch._int_mm``.

The rounding follows the JAX dtype rules, so that both packages make the
same int8 values:

- ``quantize_weight_int8`` takes the absmax, ``max(amax, 1e-8) / 127`` and
  ``w / scale`` in the weight's dtype and only then casts the scale to
  float32 (a bf16 weight's scale is a bf16-rounded value);
- an activation is divided by its scale rounded to the activation's dtype
  (JAX casts the weak-typed Python float to bf16 first), by a 0-dim tensor
  of that dtype on the activation's device: a Python float would enter the
  division in float32 and, on the card, as a reciprocal multiply;
- the rescale is ``float32(x_scale) * w_scale`` in float32;
- ``torch.round`` and ``jnp.round`` both round half to even.

Layouts are the port's: a Linear weight (N, K), a convolution OIHW, its
activations NCHW.  A convolution quantizes its activation first and then
unfolds it (im2col) in the activation's float dtype, where the integers of
at most 127 are exact (``F.unfold`` takes no int8), and multiplies the
columns as int8.  A 1x1 convolution is served as a dense layer over the
channels, as the JAX interceptor serves ``_Conv1x1``.

``torch._int_mm`` on the card wants more than 16 rows and K and N multiples
of 8: a smaller operand is padded with zeros and the result sliced, which is
exact, on every device alike.  Nothing falls back to a float product.
Grouped and dilated convolutions are refused (no model of the port has
one).

``Int8Linear`` and ``Int8Conv2d`` are the modules that serve the int8
weights in place of ``nn.Linear`` and ``nn.Conv2d``
(``compress/w8a8.py:w8a8_serving_swap``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

#: ``torch._int_mm``'s least row count on the card is 17; smaller products
#: are padded to this many rows
INT_MM_MIN_ROWS = 32
#: its K and N must be multiples of this on the card
INT_MM_ALIGN = 8


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``like``'s dtype on its device (a fill,
    no host copy: legal while a CUDA graph captures)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def quantize_weight_int8(w: torch.Tensor):
    """-> (w_q int8, scale float32 per output channel, keepdim: (N, 1) for a
    Linear's (N, K), (O, 1, 1, 1) for an OIHW kernel)."""
    amax = w.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)
    scale = torch.maximum(amax, _scalar(1e-8, w)) / _scalar(127.0, w)
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale.float()


def activation_scale(x_amax: float) -> float:
    """The activation's scale, ``max(amax, 1e-8) / 127`` in Python floats."""
    return max(float(x_amax), 1e-8) / 127.0


def quantize_activation(x: torch.Tensor, x_scale: float, dtype=torch.int8) -> torch.Tensor:
    """``clip(round(x / x_scale), -127, 127)`` with the scale rounded to x's
    dtype, as ``dtype`` (int8, or x's own float dtype for im2col)."""
    q = torch.clamp(torch.round(x / _scalar(x_scale, x)), -127, 127)
    return q if dtype == x.dtype else q.to(dtype)


def int_mm(a: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)ᵀ int8 -> (M, N) int32, exact: ``torch._int_mm``
    on the weight's transposed view, with the rows, K and N padded with
    zeros to what the card's library takes (on every device, so the CPU
    runs the card's code path)."""
    M, K = a.shape
    N = w_q.shape[0]
    pm = max(0, INT_MM_MIN_ROWS - M)
    pk, pn = -K % INT_MM_ALIGN, -N % INT_MM_ALIGN
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        w_q = F.pad(w_q, (0, pk, 0, pn))
    out = torch._int_mm(a.contiguous(), w_q.contiguous().t())
    return out if out.shape == (M, N) else out[:M, :N]


def _rescale(acc: torch.Tensor, rescale: torch.Tensor, bias, dtype) -> torch.Tensor:
    y = acc.float() * rescale
    if bias is not None:
        y = y + bias
    return y.to(dtype)


def int8_dense(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, x_amax: float,
               bias=None) -> torch.Tensor:
    """W8A8 dense: x (..., K) float; w_q (N, K) int8; w_scale (N,) or (N, 1)
    float32; ``x_amax`` a static Python float; bias added in float32 after
    the rescale; the result in x's dtype."""
    x_scale = activation_scale(x_amax)
    rescale = torch.tensor(x_scale, dtype=torch.float32) * w_scale.reshape(-1)
    return _dense(x, w_q, rescale.to(x.device), x_scale, bias)


def _dense(x, w_q, rescale, x_scale, bias):
    K = x.shape[-1]
    xq = quantize_activation(x, x_scale)
    acc = int_mm(xq.reshape(-1, K), w_q)
    return _rescale(acc, rescale, bias, x.dtype).reshape(*x.shape[:-1], w_q.shape[0])


def int8_conv(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, x_amax: float,
              bias=None, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """W8A8 convolution: x (B, C, H, W) float; w_q (O, C, kh, kw) int8;
    w_scale (O,) or (O, 1, 1, 1) float32; symmetric ``padding`` (ph, pw);
    the result (B, O, Ho, Wo) contiguous in x's dtype."""
    x_scale = activation_scale(x_amax)
    rescale = torch.tensor(x_scale, dtype=torch.float32) * w_scale.reshape(-1)
    return _conv(x, w_q, rescale.to(x.device), x_scale, bias, _pair(stride), _pair(padding))


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv(x, w_q, rescale, x_scale, bias, stride, padding):
    O, C, kh, kw = w_q.shape
    if (kh, kw) == (1, 1) and stride == (1, 1) and padding == (0, 0):
        y = _dense(x.permute(0, 2, 3, 1), w_q.reshape(O, C), rescale, x_scale, bias)
        return y.permute(0, 3, 1, 2).contiguous()
    B, _, H, W = x.shape
    Ho = (H + 2 * padding[0] - kh) // stride[0] + 1
    Wo = (W + 2 * padding[1] - kw) // stride[1] + 1
    # integers of at most 127 are exact in x's float dtype, which unfold takes
    xr = quantize_activation(x, x_scale, dtype=x.dtype)
    cols = F.unfold(xr, (kh, kw), padding=padding, stride=stride)
    a = torch.empty((B, Ho * Wo, C * kh * kw), dtype=torch.int8, device=x.device)
    a.copy_(cols.transpose(1, 2))
    acc = int_mm(a.reshape(-1, C * kh * kw), w_q.reshape(O, -1))
    y = _rescale(acc, rescale, bias, x.dtype)
    return y.reshape(B, Ho, Wo, O).permute(0, 3, 1, 2).contiguous()


class _Int8Layer(nn.Module):
    """The int8 weight, its float32 per-channel scale, the float bias and
    the activation's absmax (a Python float); the rescale
    ``float32(x_scale) * w_scale`` is held as a buffer."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, bias, x_amax: float):
        super().__init__()
        self.x_amax = float(x_amax)
        self.x_scale = activation_scale(x_amax)
        self.register_buffer("weight_q", w_q)
        self.register_buffer("w_scale", w_scale.reshape(-1).float())
        self.register_buffer("rescale", torch.full((), self.x_scale, dtype=torch.float32,
                                                   device=w_q.device) * self.w_scale,
                             persistent=False)
        self.bias = None if bias is None else nn.Parameter(bias.detach(), requires_grad=False)


class Int8Linear(_Int8Layer):
    """Serves an ``nn.Linear`` as ``int8_dense``."""

    def forward(self, x):
        return _dense(x, self.weight_q, self.rescale, self.x_scale, self.bias)


class Int8Conv2d(_Int8Layer):
    """Serves an ``nn.Conv2d`` as ``int8_conv`` (a 1x1 one as a dense layer
    over the channels)."""

    def __init__(self, w_q, w_scale, bias, x_amax, stride=(1, 1), padding=(0, 0)):
        super().__init__(w_q, w_scale, bias, x_amax)
        self.stride, self.padding = _pair(stride), _pair(padding)

    def forward(self, x):
        return _conv(x, self.weight_q, self.rescale, self.x_scale, self.bias, self.stride,
                     self.padding)
