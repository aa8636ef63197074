"""Flash attention on the H100: the port of the Pallas kernel
``ml_stable_diffusion_tpu/ops/flash_attention.py:_flash_kernel`` and of its
two wrappers, ``flash_attention`` (one query stream: UNet and VAE
self-attention) and ``flash_attention_multi_q`` (several query streams over
one shared KV: the MMDiT joint attention of SD3).

The kernel is hand-written CUDA, ``csrc/flash_attention.cu``, built for
``sm_90a`` on first use (utils/cuda_build.py) and called through ctypes.  Its
header says what bounds it on the card and what its design does about that.
In short: one thread block per (batch*head, query tile) loops over KV tiles
with an online base-2 softmax in f32; ragged edges are masked in the kernel.
Which kernel serves a call:

- bf16 at D = 64 and 160 (the other UNets and the MMDiT; SD-1.5's 16x16
  blocks): ``wgmma``, a producer warp feeding k/v tiles by TMA to two
  consumer warpgroups (128 query rows a block, or 64 where 128-row tiles
  would leave SMs idle: ``query_tile_rows``), a block a query tile; q, k
  and v read in place from the (B, S, H, D) layout.  A head is held in
  shared memory as ceil(D / 64) chunks of 64 columns, the columns past D
  loaded as zeros (``bf16_plan``);
- bf16 at D = 40 and 80 (SD-1.5's 64x64 and 32x32 blocks, and its cross
  attention over 77-308 keys): the same warpgroups in a persistent kernel.
  At D = 40 the softmax needs fewer tensor-core flops a logit than one SFU
  exponential's time, but what bounds the kernel first is streaming each
  head's k and v through L2 once a query tile; at D = 80, 1024 tokens give
  128 blocks of 128 rows, one wave; over a few hundred keys a block's
  start-up and drain are most of its time.  So: a block an SM walks work
  units, the next unit's loads under this one; at D = 40 two blocks in a
  cluster share each k and v tile load (TMA multicast); P v at N = D and
  the row sums on the tensor cores; the softmax of one kv tile under the
  previous tile's P v; at D = 40 one exponential in eight on the FMA pipe
  (``exp2_fma_emulation`` repeats its arithmetic for the CPU tests);
- f32 at D = 512 (the VAE's single head): ``wgmma`` on tf32 operands in the
  split-precision "3xTF32" form, ``a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi``
  with ``hi = tf32(x)`` and ``lo = tf32(x − hi)``, f32 accumulation.  A
  pre-pass writes the split q, k and v (v transposed) into a workspace; the
  keys may be split across blocks and the partial results merged by a
  combine pass (``wide_f32_plan``).  ``flash_attention_3xtf32_emulation``
  repeats that arithmetic in plain PyTorch for the CPU tests;
- f32 at D = 64 and bf16 at D = 512 (no main path): the FMA units.

One launch covers every query stream: the grid counts the query tiles of
all streams.

For each of the two functions there are three entry points:

- ``flash_attention_reference`` / ``flash_attention_multi_q_reference``: the
  plain PyTorch version of the same function (the JAX ``_xla_attention``
  math; for several streams: concatenate, attend, split), which the tests
  and ``chip_smoke.py`` hold the kernel against;
- ``flash_attention_cuda`` / ``flash_attention_multi_q_cuda``: the kernel
  wrappers.  They launch the kernel on CUDA tensors or raise, and count
  their launches in their own ``.launches``; an f32 D = 512 call goes
  through ``flash_attention_wide_f32_cuda``, which counts it again in its
  own ``.launches``, and its pre-pass ``flash_split_tf32_cuda`` (held
  against ``flash_split_tf32_reference``) counts in its own;
- ``flash_attention`` / ``flash_attention_multi_q``: the FLASH branch of the
  dispatch.  A CPU tensor takes the plain version; a CUDA tensor takes the
  kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..utils import cuda_build
from .attention import _plain_attention, _plain_joint_attention

#: head widths the kernels are built for, by dtype: the widths the JAX
#: package's configurations produce.  bf16: SD-1.5's 40, 80 and 160, the
#: other UNets' and SD3's MMDiT's 64 (wgmma), and 512 (the FMA kernel); f32:
#: 64 (FMA) and the VAE's single 512-wide head (3xTF32).  Any other (dtype,
#: D) stays on the plain path in the dispatch and raises here.
KERNEL_HEAD_DIMS = {torch.bfloat16: (40, 64, 80, 160, 512), torch.float32: (64, 512)}
SUPPORTED_HEAD_DIMS = tuple(sorted(set().union(*KERNEL_HEAD_DIMS.values())))
#: query streams one multi-stream launch takes (kMaxStreams in the source)
MAX_STREAMS = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: streaming multiprocessors of the H100 SXM (kSms in the source)
SMS = 132

_fns: dict = {}


def flash_attention_reference(q, k, v):
    """Plain PyTorch version of the kernel's function."""
    return _plain_attention(q, k, v)


def flash_attention_multi_q_reference(qs, k, v):
    """Plain PyTorch version of the multi-stream function: the streams
    concatenated along the sequence, attended over k/v, and split."""
    return _plain_joint_attention(qs, k, v)


#: the 3xTF32 kernel's head width, query rows a block and keys a tile
WIDE_D = 512
WIDE_ROWS = 64
#: key tiles one block of it accumulates at most (kTfMaxTilesPerSplit): the
#: tensor cores' f32 accumulation drifts with the chain's length
WIDE_MAX_TILES_PER_SPLIT = 32


@dataclasses.dataclass(frozen=True)
class WideF32Plan:
    """Launch plan of the f32 D = 512 kernel (``tf_layout`` in the source)."""
    rows: int             # padded query rows a (b, h): each stream to 64
    keys: int             # padded keys: Sk to 64
    splits: int           # blocks the keys are split across (1: no combine pass)
    tiles_per_split: int  # 64-key tiles a split takes
    blocks: int           # blocks of the main kernel
    workspace_bytes: int


def wide_f32_plan(q_lens, Sk: int, B: int, H: int) -> WideF32Plan:
    """The keys split across ``floor(SMS / blocks)`` blocks when the query
    tiles alone give fewer than ``SMS`` blocks (one block an SM), and into
    ranges of at most ``WIDE_MAX_TILES_PER_SPLIT`` tiles in any case; then
    evened so that no split is empty.  The workspace holds q and k (hi, lo),
    v transposed (hi, lo) and, with splits, each split's partial O, max
    and sum."""
    tiles = sum(-(-n // WIDE_ROWS) for n in q_lens)
    rows, keys = tiles * WIDE_ROWS, -(-Sk // WIDE_ROWS) * WIDE_ROWS
    ntiles, bh = keys // WIDE_ROWS, B * H
    splits = max(-(-ntiles // WIDE_MAX_TILES_PER_SPLIT), min(SMS // (tiles * bh), ntiles))
    per = -(-ntiles // splits)
    splits = -(-ntiles // per)
    floats = 2 * bh * rows * WIDE_D + 4 * bh * keys * WIDE_D
    if splits > 1:
        floats += splits * bh * rows * (WIDE_D + 2)
    return WideF32Plan(rows, keys, splits, per, tiles * splits * bh, 4 * floats)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as the kernel's ``cvt.rna.tf32.f32``: by bit masking
    on the int32 view."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split3(a, b, terms):
    """a @ b in the kernel's split precision: lo·hi + hi·lo + hi·hi (the
    small terms first), each product of tf32 values exact in f32; ``terms``
    1 keeps hi·hi alone (single-pass tf32)."""
    ah, bh = tf32_round(a), tf32_round(b)
    if terms == 1:
        return ah @ bh
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def flash_attention_3xtf32_emulation(q, k, v, terms: int = 3):
    """The f32 D = 512 kernel's arithmetic in plain PyTorch over (B, S, H, D)
    f32 tensors: S = q kᵀ in 3xTF32, P = exp(S/√D − max) split again, P v
    in 3xTF32, divided by the f32 row sum of P.  ``terms=1`` gives
    single-pass tf32 (hi parts only).  For the CPU tests: the card runs the
    kernel."""
    qt, kt, vt = (x.float().transpose(1, 2) for x in (q, k, v))
    s = _split3(qt, kt.transpose(-1, -2), terms) / q.shape[-1] ** 0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _split3(p, vt, terms) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2)


#: head widths of the persistent bf16 kernel (``flash_wgmma_persistent``,
#: SD-1.5's 40 and 80); 64 and 160 take the per-tile one
#: (``flash_wgmma_bf16``)
PERSISTENT_HEAD_DIMS = (40, 80)
#: the persistent kernel's exponentials on the FMA pipe (``exp2_fma``) where
#: the SFU bounds it: one 8-column group of logits in ``kFmaExpEvery`` = 8
FMA_EXP_SHARE = 1 / 8
#: shared memory a block may take (bytes): alone on an SM, and one of two
SMEM_ONE_BLOCK, SMEM_TWO_BLOCKS = 232448, 115712


def _tiles(q_lens, rows: int) -> int:
    return sum(-(-n // rows) for n in q_lens)


def query_tile_rows(q_lens, B: int, H: int, D: int) -> int:
    """Query rows a block of the bf16 wgmma kernels takes for these streams
    (the rules of ``launch_wgmma`` and ``launch_persistent_plan`` in the
    source).  D = 64: 128, unless 128-row tiles give fewer than ``SMS``
    blocks, then 64; D = 160: 64 always (two warpgroups' accumulators would
    exceed a 384-thread block's registers).  D = 40 and 80: 128, unless
    128-row tiles would leave more than half the SMs without one, then 64."""
    tiles = _tiles(q_lens, 128) * B * H
    if D in PERSISTENT_HEAD_DIMS:
        return 128 if 2 * tiles >= SMS else 64
    if -(-D // 64) == 3:
        return 64
    return 64 if tiles < SMS else 128


@dataclasses.dataclass(frozen=True)
class Bf16Plan:
    """Instantiation of a bf16 wgmma kernel (``FlashShape`` and
    ``PersistShape`` in the source)."""
    kernel: str         # "per-tile" (D = 64, 160) or "persistent" (40, 80)
    rows: int           # query rows a tile: 64 a consumer warpgroup
    chunks: int         # 64-column chunks a head takes in shared memory
    kv_rows: int        # keys a kv tile
    stages: int         # kv tiles in flight
    q_buffers: int      # q tiles in shared memory (2: the next unit's loads under this one)
    pv_cols: int        # N of the P v product: whole chunks (per-tile), D (persistent)
    sum_cols: int       # N of the row sums' product on the tensor cores (persistent: 8)
    cluster: int        # blocks a cluster (2: the pair shares each k and v tile load)
    blocks_per_sm: int
    blocks: int         # the grid: one block a tile (per-tile), or the persistent blocks
    fma_exp_share: float  # exponentials on the FMA pipe
    smem_bytes: int


def bf16_plan(q_lens, B: int, H: int, D: int) -> Bf16Plan:
    """The bf16 wgmma kernel's instantiation for these streams at width D.

    D = 64 and 160, the per-tile kernel: ``query_tile_rows``; 128-row kv
    tiles with two warpgroups at one chunk, else 64; three stages at three
    chunks, else four; two blocks an SM at 64 rows and one chunk; a block a
    query tile.

    D = 40 and 80, the persistent kernel: ``query_tile_rows``; kv tiles as
    tall as the query tiles; two blocks an SM at 64 rows and one chunk; four
    kv stages where they fit the block's shared memory, else three, then a
    second q buffer where that fits too; P v at N = D.  At D = 40 with
    128-row tiles, clusters of two blocks over adjacent query tiles of one
    head (the pair shares each k and v tile load).  The grid: a block an SM
    (two at 64 rows and one chunk), or the work units (a cluster's query
    tiles of one head) where they are fewer; clusters as many as fit on the
    card, which on the H100 is every SM pair (the kernel asks the runtime)."""
    chunks = -(-D // 64)
    rows = query_tile_rows(q_lens, B, H, D)
    tiles = _tiles(q_lens, rows) * B * H
    per_sm = 2 if rows == 64 and chunks == 1 else 1
    if D not in PERSISTENT_HEAD_DIMS:
        kv_rows = 128 if rows == 128 and chunks == 1 else 64
        stages = 3 if chunks == 3 else 4
        smem = (1024 + chunks * rows * 128 + 2 * stages * chunks * kv_rows * 128
                + (1 + 3 * stages) * 8)
        return Bf16Plan("per-tile", rows, chunks, kv_rows, stages, 1, 64 * chunks, 0, 1,
                        per_sm, tiles, 0.0, smem)
    limit = SMEM_TWO_BLOCKS if per_sm == 2 else SMEM_ONE_BLOCK

    def smem_bytes(q_buffers, stages):
        return (1024 + q_buffers * chunks * rows * 128 + 2 * stages * chunks * rows * 128
                + 256 + (4 + 3 * stages) * 8)

    stages = 4 if smem_bytes(1, 4) <= limit else 3
    q_buffers = 2 if smem_bytes(2, stages) <= limit else 1
    cluster = 2 if rows == 128 and D == 40 else 1
    units = -(-_tiles(q_lens, rows) // cluster) * B * H
    blocks = min(units, per_sm * SMS // cluster) * cluster
    # a logit's tensor-core flops (q k^T, P v at N = D, the row sum at N = 8)
    # fewer than the 256 an SFU exponential costs in time: FMA-pipe exps
    fma = FMA_EXP_SHARE if 2 * (16 * -(-D // 16) + D + 8) < 256 else 0.0
    return Bf16Plan("persistent", rows, chunks, rows, stages, q_buffers, D, 8, cluster,
                    per_sm, blocks, fma, smem_bytes(q_buffers, stages))


#: ``exp2_fma``'s minimax polynomial for 2^f on [-1/2, 1/2], constant term
#: first, as the source spells its float literals
EXP2_FMA_COEFFS = ("0.9999993", "0.6931218", "0.24024744", "0.05591786", "0.009570102")
#: its relative error bound over [-126, 0] (csrc/hopper.cuh)
EXP2_FMA_REL_ERR = 4e-6


def _fma32(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64;
    the float64 sum's own rounding may move the result by one float32 ulp
    from a fused multiply-add in rare cases)."""
    return (a.double() * b.double() + c.double()).float()


def exp2_fma_emulation(x: torch.Tensor) -> torch.Tensor:
    """The arithmetic of the kernel's FMA-pipe 2^x (``csrc/hopper.cuh:
    exp2_fma``) on float32 tensors: clamp to -126, j = rint(x) by adding
    and subtracting 1.5 * 2^23, f = x - j, 2^f by the degree-4 polynomial in
    Horner form, and j << 23 added to its bits.  For the CPU tests: the card
    runs the kernel."""
    x = torch.clamp(x.float(), min=-126.0)
    magic = torch.tensor(12582912.0)
    t = x + magic
    f = x - (t - magic)
    c = [torch.tensor(float(v), dtype=torch.float32) for v in EXP2_FMA_COEFFS]
    q = _fma32(c[4].expand_as(f), f, c[3].expand_as(f))
    for k in (2, 1, 0):
        q = _fma32(q, f, c[k].expand_as(f))
    bits = q.view(torch.int32).long() + ((t.view(torch.int32).long() << 23) & 0xFFFFFFFF)
    return (((bits + 2**31) % 2**32) - 2**31).int().view(torch.float32)


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(cuda_build.load("flash_attention"), name)
        strides = ctypes.POINTER(ctypes.c_longlong)
        streams = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                   strides, strides, ctypes.c_void_p, ctypes.c_void_p]
        if name == "flash_persistent_fit":
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        elif name == "flash_attention_fwd":
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
        elif name in ("flash_attention_wide_f32_fwd", "flash_split_tf32_fwd"):
            fn.argtypes = (streams + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 6
                           + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_void_p])
        else:
            fn.argtypes = (streams + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
                           + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def persistent_resident_blocks(D: int, rows: int) -> int:
    """Blocks of the persistent bf16 kernel at width D (40 or 80) with
    ``rows``-row tiles that the card holds at once, as the CUDA runtime
    reckons it for the instantiation ``launch_persistent_plan`` takes; what
    ``bf16_plan`` assumes (``blocks_per_sm`` times ``SMS``) is held against
    it on the card.  Launches nothing."""
    blocks = ctypes.c_int(0)
    rc = _kernel("flash_persistent_fit")(D, rows // 64, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"flash_persistent_fit failed with CUDA error {rc} at D={D}, "
                           f"{rows}-row tiles")
    return blocks.value


def _vector_ready(x):
    """The kernel loads 16-byte vectors and TMA tiles: the base must be
    16-byte aligned and the batch, sequence and head strides multiples of 8
    elements (16 bytes at least).  A view that breaks this is copied, never
    launched: a contiguous copy meets it at every width the kernel takes."""
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
    if D not in KERNEL_HEAD_DIMS[k.dtype]:
        raise ValueError(f"flash kernel is built for {k.dtype} head widths "
                         f"{KERNEL_HEAD_DIMS[k.dtype]}, got D={D}")
    if Sk == 0 or any(q.shape[1] == 0 for q in qs):
        raise ValueError("flash kernel needs non-empty sequences")
    return [_vector_ready(q) for q in qs], _vector_ready(k), _vector_ready(v)


_PLAIN = "the plain attention path (AttentionImpl.PLAIN)"


def _raise_on(rc, what, k):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {rc} "
                           f"at k {tuple(k.shape)} {k.dtype}")


def _wide_args(qs, k, v, outs, plan, ws):
    """The arguments both C entries of the f32 D = 512 path take."""
    n = len(qs)
    ptrs = ctypes.c_void_p * n
    strides = ctypes.c_longlong * (3 * n)
    B, Sk, H, _ = k.shape
    return (n, ptrs(*(q.data_ptr() for q in qs)), ptrs(*(o.data_ptr() for o in outs)),
            (ctypes.c_int * n)(*(q.shape[1] for q in qs)),
            strides(*(s for q in qs for s in q.stride()[:3])),
            strides(*(s for o in outs for s in o.stride()[:3])),
            k.data_ptr(), v.data_ptr(), B, H, Sk, *k.stride()[:3], *v.stride()[:3],
            ws.data_ptr(), ws.numel() * 4, plan.splits,
            torch.cuda.current_stream(k.device).cuda_stream)


def wide_f32_planes(ws, plan: WideF32Plan, B: int, H: int):
    """Views of the workspace's split planes: (q hi, q lo) (B·H, rows, 512),
    (k hi, k lo) (B·H, keys, 512), (vᵀ hi, vᵀ lo) (B·H, 512, keys)."""
    bh = B * H
    q, kv = bh * plan.rows * WIDE_D, bh * plan.keys * WIDE_D
    shapes = [(bh, plan.rows, WIDE_D)] * 2 + [(bh, plan.keys, WIDE_D)] * 2 + \
        [(bh, WIDE_D, plan.keys)] * 2
    sizes = [q, q, kv, kv, kv, kv]
    starts = [sum(sizes[:i]) for i in range(6)]
    return [ws[a:a + n].view(shape) for a, n, shape in zip(starts, sizes, shapes)]


def flash_split_tf32_reference(qs, k, v, plan: WideF32Plan):
    """Plain PyTorch version of the pre-pass: the planes of
    ``wide_f32_planes`` (hi = tf32(x), lo = tf32(x − hi)), each query stream
    padded to 64 rows and the keys to ``plan.keys`` with zeros, v
    transposed."""
    B, Sk, H, D = k.shape

    def heads(x, rows):  # (B, S, H, D) -> (B·H, rows, D), zero rows after S
        x = x.float().permute(0, 2, 1, 3).reshape(B * H, x.shape[1], D)
        return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[1]))

    q = torch.cat([heads(q, -(-q.shape[1] // WIDE_ROWS) * WIDE_ROWS) for q in qs], dim=1)
    out = []
    for x in (q, heads(k, plan.keys), heads(v, plan.keys).transpose(1, 2)):
        hi = tf32_round(x)
        out += [hi, tf32_round(x - hi)]
    return out


def flash_split_tf32_cuda(qs, k, v, plan: WideF32Plan, ws):
    """The pre-pass kernel: the split planes of f32 D = 512 query streams,
    k and v into the workspace ``ws`` (``plan.workspace_bytes``)."""
    qs, k, v = _checked("flash_split_tf32_cuda", list(qs), k, v)
    if ws.device != k.device or ws.dtype != torch.float32 or ws.numel() * 4 < plan.workspace_bytes:
        raise ValueError(f"the workspace must be float32 on {k.device} with "
                         f"{plan.workspace_bytes} bytes")
    rc = _kernel("flash_split_tf32_fwd")(*_wide_args(qs, k, v, qs, plan, ws))
    _raise_on(rc, "3xTF32 pre-pass", k)
    flash_split_tf32_cuda.launches += 1


flash_split_tf32_cuda.launches = 0


def flash_attention_wide_f32_cuda(qs, k, v):
    """f32 D = 512 query streams over one k/v by the 3xTF32 kernel: the
    pre-pass (``flash_split_tf32_cuda``), then the main kernel and, with kv
    splits, the combine pass; -> one output per stream.  Takes what
    ``_checked`` has passed, and checks it again."""
    cuda_build.refuse_grad("flash_attention_wide_f32_cuda", _PLAIN, *qs, k, v)
    qs, k, v = _checked("flash_attention_wide_f32_cuda", list(qs), k, v)
    B, Sk, H, D = k.shape
    if k.dtype != torch.float32 or D != WIDE_D:
        raise ValueError(f"the 3xTF32 kernel takes float32 at D={WIDE_D}, got {k.dtype} "
                         f"D={D}")
    plan = wide_f32_plan([q.shape[1] for q in qs], Sk, B, H)
    ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32, device=k.device)
    outs = [torch.empty(q.shape, dtype=q.dtype, device=q.device) for q in qs]
    with torch.cuda.device(k.device):
        flash_split_tf32_cuda(qs, k, v, plan, ws)
        rc = _kernel("flash_attention_wide_f32_fwd")(*_wide_args(qs, k, v, outs, plan, ws))
    _raise_on(rc, "3xTF32 flash attention", k)
    flash_attention_wide_f32_cuda.launches += 1
    return outs


flash_attention_wide_f32_cuda.launches = 0


def _wide_f32(q):
    return q.dtype == torch.float32 and q.shape[-1] == WIDE_D


def flash_attention_cuda(q, k, v):
    """softmax(q k^T / sqrt(D)) v over (B, S, H, D) CUDA tensors, by the
    hand-written kernel.  Raises for anything the kernel does not take."""
    cuda_build.refuse_grad("flash_attention_cuda", _PLAIN, q, k, v)
    (q,), k, v = _checked("flash_attention_cuda", [q], k, v)
    if _wide_f32(q):
        out = flash_attention_wide_f32_cuda([q], k, v)[0]
        flash_attention_cuda.launches += 1
        return out
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
    cuda_build.refuse_grad("flash_attention_multi_q_cuda", _PLAIN, *qs, k, v)
    if not 1 <= len(qs) <= MAX_STREAMS:
        raise ValueError(f"flash_attention_multi_q_cuda takes 1 to {MAX_STREAMS} "
                         f"query streams, got {len(qs)}")
    qs, k, v = _checked("flash_attention_multi_q_cuda", qs, k, v)
    if _wide_f32(k):
        outs = flash_attention_wide_f32_cuda(qs, k, v)
        flash_attention_multi_q_cuda.launches += 1
        return outs
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
