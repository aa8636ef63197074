"""Attention dispatch (port of ml_stable_diffusion_tpu/ops/attention.py).

Two interchangeable implementations over (B, S, H, D) tensors:

- ``PLAIN``: torch matmuls with f32 logits and an f32 softmax — the
  counterpart of the JAX package's ``XLA`` path, which it left to the
  compiler; here it is left to cuBLAS (or the CPU).
- ``FLASH``: the hand-written CUDA flash kernel (ops/flash_attention.py)
  for the large self-attention sequences (4096, 1024 and 256 tokens at
  512x512 latents, and the VAE's single 512-wide head), at the head widths
  it is built for (``KERNEL_HEAD_DIMS``: SD-1.5's 40/80/160 and 64 in bf16).
- ``AUTO``: FLASH where the shapes qualify, else PLAIN.

As in the JAX package, UNet cross attention (Sk = 77), the causal text
encoder attention and the 8x8 mid-block attention (64 tokens) stay on the
plain path.

``joint_dot_product_attention`` is the MMDiT joint attention of SD3: several
query streams (the 4096 latent and 154 context rows at 1024x1024) over one
shared KV, the same as attending the concatenated streams and splitting.
Its FLASH branch is the kernel's multi-stream entry, one launch per call.
"""

from __future__ import annotations

import enum

import torch

#: flash dispatch threshold on the query and KV lengths (the JAX default)
_FLASH_MIN_S = 256


class AttentionImpl(str, enum.Enum):
    AUTO = "auto"
    PLAIN = "plain"
    FLASH = "flash"


#: process-wide default used by AUTO callers (the JAX package's module-level
#: switch of the same name; generate_images sets it from its configuration)
ATTENTION_IMPLEMENTATION_IN_EFFECT = AttentionImpl.AUTO


def set_attention_implementation(impl: AttentionImpl | str):
    global ATTENTION_IMPLEMENTATION_IN_EFFECT
    ATTENTION_IMPLEMENTATION_IN_EFFECT = AttentionImpl(impl)


def _plain_attention(q, k, v, bias=None, causal=False):
    """The JAX ``_xla_attention`` math: f32 logits, the causal -1e4 mask,
    f32 softmax, probabilities cast to the input dtype, f32 accumulation."""
    B, Sq, H, D = q.shape
    scale = D ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Sk = k.shape[1]
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        # -1e4 (not -inf), as the JAX package does for fp16-family parity
        logits = logits.masked_fill(~mask, -1e4)
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def _plain_joint_attention(q_streams, k, v):
    """The JAX joint-attention XLA path: concatenate the query streams along
    the sequence, attend, split."""
    out = _plain_attention(torch.cat(list(q_streams), dim=1), k, v)
    return list(out.split([q.shape[1] for q in q_streams], dim=1))


def _flash_qualifies(q, k) -> bool:
    """The JAX rule (Sq >= 256, Sk >= 256) on a CUDA tensor whose dtype and
    head width the kernel is built for."""
    from .flash_attention import KERNEL_HEAD_DIMS

    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    return (q.is_cuda and Sq >= _FLASH_MIN_S and Sk >= _FLASH_MIN_S
            and D in KERNEL_HEAD_DIMS.get(q.dtype, ()))


def dot_product_attention(q, k, v, bias=None, causal=False,
                          impl: AttentionImpl | str = AttentionImpl.AUTO):
    """Multi-head attention over (B, S, H, D) tensors.

    ``bias`` is an additive (B or 1, H or 1, Sq, Sk) mask/bias.  AUTO sends
    causal or biased attention to the plain path, as the JAX flash wrapper
    does; an explicit FLASH with either raises.
    """
    impl = AttentionImpl(impl)
    if impl == AttentionImpl.AUTO:
        impl = ATTENTION_IMPLEMENTATION_IN_EFFECT
    if impl == AttentionImpl.AUTO:
        impl = (AttentionImpl.FLASH
                if bias is None and not causal and _flash_qualifies(q, k)
                else AttentionImpl.PLAIN)
    if impl == AttentionImpl.FLASH:
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, bias=bias, causal=causal)
    return _plain_attention(q, k, v, bias=bias, causal=causal)


def joint_dot_product_attention(q_streams, k, v,
                                impl: AttentionImpl | str = AttentionImpl.AUTO):
    """Joint attention: several (B, Sq_i, H, D) query streams over ONE shared
    (B, Sk, H, D) k/v; -> one output per stream.  AUTO decides on the first
    stream, as the JAX package does, so the latent stream takes the context
    stream onto the kernel with it."""
    impl = AttentionImpl(impl)
    if impl == AttentionImpl.AUTO:
        impl = ATTENTION_IMPLEMENTATION_IN_EFFECT
    if impl == AttentionImpl.AUTO:
        impl = (AttentionImpl.FLASH if _flash_qualifies(q_streams[0], k)
                else AttentionImpl.PLAIN)
    if impl == AttentionImpl.FLASH:
        from .flash_attention import flash_attention_multi_q

        return flash_attention_multi_q(q_streams, k, v)
    return _plain_joint_attention(q_streams, k, v)
