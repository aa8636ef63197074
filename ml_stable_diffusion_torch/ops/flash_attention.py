"""Flash attention on the H100: the port of the Pallas kernel
``ml_stable_diffusion_tpu/ops/flash_attention.py:_flash_kernel`` and of its
two wrappers, ``flash_attention`` (one query stream: UNet and VAE
self-attention) and ``flash_attention_multi_q`` (several query streams over
one shared KV: the MMDiT joint attention of SD3).

The kernel is hand-written CUDA, ``csrc/flash_attention.cu``, built for
``sm_90a`` on first use (utils/cuda_build.py) and called through ctypes.  Its
header says what bounds it on the card and what its design does about that.
In short: one thread block per (batch*head, query tile) loops over KV tiles
with an online base-2 softmax in f32; q, k and v are read in place from the
(B, S, H, D) layout; ragged edges are masked in the kernel.  bf16 at D = 64
(the UNet and the MMDiT) runs on the tensor cores through ``mma.sync``; f32,
and D = 512 (the VAE's single head), run on the FMA units.  One launch covers
every query stream: the grid counts the query tiles of all streams.

For each of the two functions there are three entry points:

- ``flash_attention_reference`` / ``flash_attention_multi_q_reference``: the
  plain PyTorch version of the same function (the JAX ``_xla_attention``
  math; for several streams: concatenate, attend, split), which the tests
  and ``chip_smoke.py`` hold the kernel against;
- ``flash_attention_cuda`` / ``flash_attention_multi_q_cuda``: the kernel
  wrappers.  They launch the kernel on CUDA tensors or raise, and count
  their launches in their own ``.launches``;
- ``flash_attention`` / ``flash_attention_multi_q``: the FLASH branch of the
  dispatch.  A CPU tensor takes the plain version; a CUDA tensor takes the
  kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from .attention import _plain_attention, _plain_joint_attention

#: head widths the kernel is instantiated for: the UNet's and SD3's MMDiT's
#: 64 (SD3-medium and SD3.5-large both have 64-wide heads) and the VAE's 512
#: (SD-1.5's 40/80/160 come with that model)
SUPPORTED_HEAD_DIMS = (64, 512)
#: query streams one multi-stream launch takes (kMaxStreams in the source)
MAX_STREAMS = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fns: dict = {}


def flash_attention_reference(q, k, v):
    """Plain PyTorch version of the kernel's function."""
    return _plain_attention(q, k, v)


def flash_attention_multi_q_reference(qs, k, v):
    """Plain PyTorch version of the multi-stream function: the streams
    concatenated along the sequence, attended over k/v, and split."""
    return _plain_joint_attention(qs, k, v)


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(cuda_build.load("flash_attention"), name)
        if name == "flash_attention_fwd":
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
        else:
            strides = ctypes.POINTER(ctypes.c_longlong)
            fn.argtypes = ([ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                            strides, strides, ctypes.c_void_p, ctypes.c_void_p]
                           + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
                           + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _vector_ready(x):
    """The kernel loads 16-byte vectors: the base must be 16-byte aligned and
    the batch, sequence and head strides multiples of 8 elements."""
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in x.stride()[:3])):
        return x
    return x.contiguous()


def _checked(who, qs, k, v):
    """Raise for anything the kernel does not take; -> (qs, k, v) ready for
    16-byte loads."""
    named = [(f"q[{i}]" if len(qs) > 1 else "q", q) for i, q in enumerate(qs)]
    for name, x in named + [("k", k), ("v", v)]:
        if x.device.type != "cuda":
            raise ValueError(f"{who} needs CUDA tensors; {name} is on {x.device}")
        if x.ndim != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got {tuple(x.shape)}")
        if x.device != k.device:
            raise ValueError("q, k and v must lie on one device")
        if x.dtype not in _DTYPE_CODES or x.dtype != k.dtype:
            raise ValueError(f"flash kernel takes float32 or bfloat16 q/k/v of one "
                             f"dtype, got {name} {x.dtype} and k {k.dtype}")
    B, Sk, H, D = k.shape
    if v.shape != k.shape or any(q.shape[0] != B or q.shape[2:] != (H, D) for q in qs):
        raise ValueError(f"shape mismatch: q {[tuple(q.shape) for q in qs]}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernel is built for head widths "
                         f"{SUPPORTED_HEAD_DIMS}, got D={D}")
    if Sk == 0 or any(q.shape[1] == 0 for q in qs):
        raise ValueError("flash kernel needs non-empty sequences")
    return [_vector_ready(q) for q in qs], _vector_ready(k), _vector_ready(v)


def _raise_on(rc, what, k):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {rc} "
                           f"at k {tuple(k.shape)} {k.dtype}")


def flash_attention_cuda(q, k, v):
    """softmax(q k^T / sqrt(D)) v over (B, S, H, D) CUDA tensors, by the
    hand-written kernel.  Raises for anything the kernel does not take."""
    (q,), k, v = _checked("flash_attention_cuda", [q], k, v)
    B, Sq, H, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    fwd = _kernel("flash_attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, Sq, k.shape[1], D, _DTYPE_CODES[q.dtype],
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], stream)
    _raise_on(rc, "flash attention", k)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention_multi_q_cuda(qs, k, v):
    """Several (B, Sq_i, H, D) query streams over one (B, Sk, H, D) k/v, by
    one launch of the hand-written kernel; -> one output per stream.
    Raises for anything the kernel does not take."""
    qs = list(qs)
    if not 1 <= len(qs) <= MAX_STREAMS:
        raise ValueError(f"flash_attention_multi_q_cuda takes 1 to {MAX_STREAMS} "
                         f"query streams, got {len(qs)}")
    qs, k, v = _checked("flash_attention_multi_q_cuda", qs, k, v)
    outs = [torch.empty(q.shape, dtype=q.dtype, device=q.device) for q in qs]
    n = len(qs)
    ptrs = ctypes.c_void_p * n
    strides = ctypes.c_longlong * (3 * n)
    fwd = _kernel("flash_attention_multi_q_fwd")
    B, Sk, H, D = k.shape
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        rc = fwd(n, ptrs(*(q.data_ptr() for q in qs)), ptrs(*(o.data_ptr() for o in outs)),
                 (ctypes.c_int * n)(*(q.shape[1] for q in qs)),
                 strides(*(s for q in qs for s in q.stride()[:3])),
                 strides(*(s for o in outs for s in o.stride()[:3])),
                 k.data_ptr(), v.data_ptr(), B, H, Sk, D, _DTYPE_CODES[k.dtype],
                 *k.stride()[:3], *v.stride()[:3], stream)
    _raise_on(rc, "multi-stream flash attention", k)
    flash_attention_multi_q_cuda.launches += 1
    return outs


flash_attention_multi_q_cuda.launches = 0


def flash_attention(q, k, v, bias=None, causal=False):
    """Multi-head flash attention over (B, S, H, D) tensors: the kernel on a
    CUDA tensor, its plain version on a CPU tensor.  The kernel computes
    non-causal attention without bias; the dispatch in ops/attention.py keeps
    both off this path, and an explicit request for them raises."""
    if bias is not None or causal:
        raise ValueError("flash attention takes neither bias nor a causal mask; "
                         "use the plain path")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    return flash_attention_cuda(q, k, v)


def flash_attention_multi_q(qs, k, v):
    """Several query streams attending over ONE shared (B, Sk, H, D) k/v (the
    MMDiT joint attention); -> one output per stream: the kernel on CUDA
    tensors, its plain version on CPU tensors."""
    if k.device.type == "cpu":
        return flash_attention_multi_q_reference(qs, k, v)
    return flash_attention_multi_q_cuda(qs, k, v)
