"""The f32 D = 512 flash kernel's split-precision ("3xTF32") design, on the CPU.

The card runs ``csrc/flash_attention.cu:flash_wgmma_3xtf32``; here its
arithmetic runs in plain PyTorch (``flash_attention_3xtf32_emulation``):
every f32 operand split into hi = tf32(x) and lo = tf32(x - hi), each
product taken as lo·hi + hi·lo + hi·hi.  At the VAE's head width on inputs
made with numpy it is held against the plain f32 attention and against the
JAX flash kernel in Pallas interpret mode, within the f32 tolerances of
``chip_smoke.py`` and ``tests/test_torch_flash_card.py`` (max abs 2e-5,
rel RMS 1e-4); single-pass tf32 (hi parts only) falls outside them, so the
card's check can tell the two apart.  Also: the tf32 rounding, the
pre-pass's plain version and the launch plan.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ml_stable_diffusion_tpu.ops.flash_attention import flash_attention as jax_flash

from ml_stable_diffusion_torch.ops.flash_attention import (
    SMS,
    WIDE_MAX_TILES_PER_SPLIT,
    WIDE_ROWS,
    flash_attention,
    flash_attention_3xtf32_emulation,
    flash_attention_reference,
    flash_attention_wide_f32_cuda,
    flash_split_tf32_cuda,
    flash_split_tf32_reference,
    tf32_round,
    wide_f32_plan,
    wide_f32_planes,
)

ATOL = 2e-5
REL_RMS = 1e-4
SHAPE = (1, 1024, 1, 512)


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.RandomState(7)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(3)]


def _errors(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = got - ref
    return np.abs(diff).max(), np.sqrt((diff ** 2).sum() / (ref ** 2).sum())


def test_3xtf32_matches_plain_f32(qkv):
    q, k, v = (torch.from_numpy(x) for x in qkv)
    err, rel = _errors(flash_attention_3xtf32_emulation(q, k, v),
                       flash_attention_reference(q, k, v))
    assert err <= ATOL and rel <= REL_RMS, (err, rel)


def test_3xtf32_matches_pallas_interpret(qkv):
    ref = jax_flash(*(jnp.asarray(x) for x in qkv), block_q=128, block_k=128, interpret=True)
    got = flash_attention_3xtf32_emulation(*(torch.from_numpy(x) for x in qkv))
    err, rel = _errors(got, ref)
    assert err <= ATOL and rel <= REL_RMS, (err, rel)


def test_single_pass_tf32_falls_outside_the_tolerance(qkv):
    """hi·hi alone (plain TF32) misses by ~4e-4 rel RMS at this shape: the
    f32 bound is what makes the kernel split its operands."""
    q, k, v = (torch.from_numpy(x) for x in qkv)
    err, rel = _errors(flash_attention_3xtf32_emulation(q, k, v, terms=1),
                       flash_attention_reference(q, k, v))
    assert rel > REL_RMS and err > ATOL, (err, rel)


def test_tf32_round_is_nearest_ties_away():
    ulp = 2.0 ** -10  # tf32's spacing in [1, 2)
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23, 1.0 + 1.5 * ulp,
                      -(1.0 + ulp / 2), 3.0e-3])
    got = tf32_round(x)
    want = torch.tensor([1.0, 1.0 + ulp, 1.0, 1.0 + 2 * ulp, -(1.0 + ulp)], dtype=torch.float64)
    assert torch.equal(got[:5].double(), want)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # hi + lo carries x to ~2^-22 of its size
    r = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    hi = tf32_round(r)
    lo = tf32_round(r - hi)
    assert ((hi.double() + lo.double() - r.double()).abs() <= r.abs().double() * 2.0 ** -21).all()


def test_split_planes_of_the_prepass():
    """The pre-pass's plain version: each stream padded to 64 rows and the
    keys to the plan's, with zeros; hi + lo give back x; v transposed; the
    planes tile the workspace in its order."""
    rng = np.random.RandomState(1)
    B, H = 2, 3
    qs = [torch.from_numpy(rng.randn(B, n, H, 512).astype(np.float32)) for n in (70, 5)]
    k, v = (torch.from_numpy(rng.randn(B, 100, H, 512).astype(np.float32)) for _ in range(2))
    plan = wide_f32_plan([70, 5], 100, B, H)
    assert (plan.rows, plan.keys) == (128 + 64, 128)
    qh, ql, kh, kl, vh, vl = flash_split_tf32_reference(qs, k, v, plan)
    heads = qs[0].permute(0, 2, 1, 3).reshape(B * H, 70, 512)
    np.testing.assert_allclose((qh + ql)[:, :70], heads, rtol=2.0 ** -21)
    assert qh[:, 70:128].eq(0).all() and ql[:, 133:].eq(0).all()
    second = qs[1].permute(0, 2, 1, 3).reshape(B * H, 5, 512)
    np.testing.assert_allclose((qh + ql)[:, 128:133], second, rtol=2.0 ** -21)
    kt = k.permute(0, 2, 1, 3).reshape(B * H, 100, 512)
    np.testing.assert_allclose((kh + kl)[:, :100], kt, rtol=2.0 ** -21)
    assert kh[:, 100:].eq(0).all()
    vt = v.permute(0, 2, 3, 1).reshape(B * H, 512, 100)
    np.testing.assert_allclose((vh + vl)[:, :, :100], vt, rtol=2.0 ** -21)
    assert vl[:, :, 100:].eq(0).all()
    ws = torch.arange(plan.workspace_bytes // 4, dtype=torch.float32)
    planes = wide_f32_planes(ws, plan, B, H)
    assert [tuple(p.shape) for p in planes] == [tuple(p.shape) for p in (qh, ql, kh, kl, vh, vl)]
    ends = [p.flatten()[-1].item() + 1 for p in planes]
    assert ends == sorted(ends) and all(p.is_contiguous() for p in planes)


@pytest.mark.parametrize("q_lens,sk,B,H", [
    ((16384,), 16384, 1, 1),   # SD3 / SDXL VAE
    ((4096,), 4096, 1, 1),     # SD-2.1 VAE
    ((330,), 330, 1, 1),
    ((4096, 154), 4250, 1, 1),
    ((300,), 300, 2, 3),
    ((5, 70, 64, 1), 140, 2, 2),
])
def test_wide_f32_plan(q_lens, sk, B, H):
    """Splits cover the keys' 64-row tiles exactly, none empty and none
    longer than the accumulation cap; blocks fill the card when the query
    tiles alone would not; the workspace holds the planes and partials."""
    plan = wide_f32_plan(q_lens, sk, B, H)
    tiles = sum(-(-n // WIDE_ROWS) for n in q_lens)
    ntiles = plan.keys // WIDE_ROWS
    assert plan.keys >= sk > plan.keys - WIDE_ROWS
    assert plan.rows == tiles * WIDE_ROWS
    assert plan.tiles_per_split <= WIDE_MAX_TILES_PER_SPLIT
    assert (plan.splits - 1) * plan.tiles_per_split < ntiles <= plan.splits * plan.tiles_per_split
    assert plan.blocks == tiles * B * H * plan.splits
    if tiles * B * H < SMS and ntiles > 1:
        assert plan.splits > 1
    floats = 2 * B * H * 512 * (plan.rows + 2 * plan.keys)
    if plan.splits > 1:
        floats += plan.splits * B * H * plan.rows * 514
    assert plan.workspace_bytes == 4 * floats


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(1, 70, 1, 512).astype(np.float32)) for _ in range(3))
    before = flash_attention_wide_f32_cuda.launches
    got = flash_attention(q, k, v)
    assert flash_attention_wide_f32_cuda.launches == before
    assert torch.equal(got, flash_attention_reference(q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_wide_f32_cuda([q], k, v)
    plan = wide_f32_plan([70], 70, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        flash_split_tf32_cuda([q], k, v, plan, torch.empty(plan.workspace_bytes // 4))
