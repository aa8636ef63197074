"""SD3.5-medium's MMDiT-X in the port, held against the plain float32
reference ``tests/plain_mmditx.py`` on the CPU (the JAX package has no dual
attention): a tiny dual-attention MMDiT (dual blocks, qk RMSNorm, the
``context_pre_only`` last block) forward, and a tiny
``StableDiffusion3Pipeline`` generation through it against the same
pipeline with the plain module in its place; the ``sd35_medium`` preset's
published numbers, SD3-medium's and SD3.5-large's parameters unchanged; the
attention counters by path (a meta-device forward at full width); the
diffusers loader; the sharding guard; and the benchmark's own copy of the
reference (``sdbench/reference/mmdit.py``) against this one.

One test needs an NVIDIA GPU (a captured program's replay credits the
counters) and skips without one.  This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_sd35.py
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_mmditx
from ml_stable_diffusion_torch.convert.load import load_mmdit
from ml_stable_diffusion_torch.convert.native_io import save_file
from ml_stable_diffusion_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from ml_stable_diffusion_torch.models.init import init_random_
from ml_stable_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
from ml_stable_diffusion_torch.models.t5 import T5Config, T5Encoder
from ml_stable_diffusion_torch.models.vae import VAEConfig, VAEDecoder
from ml_stable_diffusion_torch.parallel.sharding import param_sharding_rules, shard_params
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration, StableDiffusion3Pipeline
from ml_stable_diffusion_torch.pipelines.program import ProgramCache, kernel_counters
from ml_stable_diffusion_torch.tokenizer import CLIPTokenizer

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("mmdit_joint_attention", "mmdit_self_attention")
LETTERS = "abcdefghijklmnopqrstuvwxyz"
#: the tiny CLIPs' letters vocabulary: 52 letter tokens, then BOS and EOS
BOS, EOS = 52, 53
CLIP = dict(vocab_size=54, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
            num_attention_heads=2, eos_token_id=EOS, projection_dim=24)
#: dual blocks 0 and 2 of four, the last ``context_pre_only``
TINY = MMDiTConfig(patch_size=2, in_channels=16, out_channels=16, depth=4, hidden_size=32,
                   num_heads=4, context_dim=64, pooled_dim=16 + 24, pos_embed_max_size=16,
                   qk_norm=True, dual_attention_layers=(0, 2))

# Float32 on both sides computing the same products in another order (the
# port's heads through its attention dispatch, the plain one's einsum):
# rounding of ~1e-6 a call.  The tolerances sit a hundred times above it
# and far below what a block without its attn2 changes (see
# test_dual_mmdit_matches_plain_reference).
ATOL_FORWARD = 1e-4
ATOL_LATENTS = 1e-4


def _seeded(module, seed):
    return init_random_(module, torch.Generator().manual_seed(seed)).eval()


def _plain(mmdit: MMDiT) -> plain_mmditx.MMDiTX:
    ref = plain_mmditx.MMDiTX(dataclasses.asdict(mmdit.config))
    ref.load_state_dict(mmdit.state_dict(), strict=True)
    return ref.eval()


def _without_attn2(mmdit: MMDiT) -> plain_mmditx.MMDiTX:
    """The plain model of the same weights with no dual block: attn2 and its
    three modulation chunks left out."""
    D = mmdit.config.hidden_size
    ref = plain_mmditx.MMDiTX(dataclasses.asdict(
        dataclasses.replace(mmdit.config, dual_attention_layers=())))
    ref.load_state_dict({k: v[:6 * D] if ".norm1.linear." in k else v
                         for k, v in mmdit.state_dict().items() if ".attn2." not in k})
    return ref.eval()


def _inputs(B=2, hw=8, S=12, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, 16, hw, hw, generator=g), torch.tensor([700.0, 300.0][:B]),
            torch.randn(B, S, TINY.context_dim, generator=g),
            torch.randn(B, TINY.pooled_dim, generator=g))


def _counts():
    return {k: kernel_counters()[k].launches for k in COUNTERS}


def test_dual_mmdit_matches_plain_reference():
    mmdit = _seeded(MMDiT(TINY), 5)
    assert [hasattr(b, "attn2") for b in mmdit.transformer_blocks] == [True, False, True, False]
    assert mmdit.transformer_blocks[-1].context_pre_only
    args = _inputs()
    with torch.no_grad():
        got, want = mmdit(*args), _plain(mmdit)(*args)
        # the same weights without the dual blocks' attn2: far outside
        single = _without_attn2(mmdit)(*args)
    assert got.shape == (2, 16, 8, 8) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL_FORWARD)
    assert (single - want).abs().max() > 100 * ATOL_FORWARD


def test_sdbench_reference_copy_matches_plain_reference():
    sys.path.insert(0, str(ROOT))
    from sdbench.reference.mmdit import MMDiTX

    ref = _plain(_seeded(MMDiT(TINY), 6))
    copy = MMDiTX(dataclasses.asdict(TINY)).eval()
    copy.load_state_dict(ref.state_dict(), strict=True)
    args = _inputs(seed=2)
    with torch.no_grad():
        torch.testing.assert_close(copy(*args), ref(*args), rtol=0, atol=1e-6)


def test_sd35_medium_preset_states_the_published_numbers():
    c = MMDiTConfig.sd35_medium()
    assert (c.depth, c.hidden_size, c.num_heads, c.hidden_size // c.num_heads) == (24, 1536, 24, 64)
    assert (c.patch_size, c.in_channels, c.out_channels) == (2, 16, 16)
    assert (c.context_dim, c.pooled_dim, c.pos_embed_max_size) == (4096, 2048, 384)
    assert c.qk_norm and c.dual_attention_layers == tuple(range(13))
    with torch.device("meta"):
        n = sum(p.numel() for p in MMDiT(c).parameters())
    assert n == 2_469_663_936  # 2.47 B, 0.23 B of it the 384^2 x 1536 positional table


@pytest.mark.parametrize("preset, count, total", [
    ("sd3_medium", 683, 2_084_951_104), ("sd35_large", 1227, 8_146_280_768)])
def test_sd3_medium_and_sd35_large_keep_their_parameters(preset, count, total):
    """Names and numbers as before dual attention came in."""
    with torch.device("meta"):
        m = MMDiT(getattr(MMDiTConfig, preset)())
    names = [n for n, _ in m.named_parameters()]
    assert len(names) == count and sum(p.numel() for p in m.parameters()) == total
    assert not [n for n in names if "attn2" in n]
    assert {tuple(b.norm1.linear.weight.shape) for b in m.transformer_blocks} == {
        (6 * m.config.hidden_size, m.config.hidden_size)}


@pytest.mark.parametrize("preset, joint, self_", [
    ("sd35_medium", 24, 13), ("sd3_medium", 24, 0)])
def test_counters_count_attention_calls_by_path(preset, joint, self_):
    """One forward at full width, on the meta device (shapes only)."""
    cfg = getattr(MMDiTConfig, preset)()
    with torch.device("meta"):
        m = MMDiT(cfg)
        args = (torch.zeros(2, 16, 128, 128), torch.zeros(()), torch.zeros(2, 154, 4096),
                torch.zeros(2, 2048))
    before = _counts()
    with torch.no_grad():
        out = m(*args)
    after = _counts()
    assert out.shape == (2, 16, 128, 128)
    assert (after[COUNTERS[0]] - before[COUNTERS[0]],
            after[COUNTERS[1]] - before[COUNTERS[1]]) == (joint, self_)


@pytest.fixture
def cuda_device():
    """Decided when the test runs, not at import: every worker collects the
    same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_program_replay_credits_the_counters(cuda_device):
    """The first call counts its eager warm-up and credits its replay; a
    second call replays and credits once."""
    mmdit = _seeded(MMDiT(TINY), 7).to(cuda_device)
    args = [a.numpy() for a in _inputs()]
    names = ("latents", "t", "ctx", "pooled")
    cache = ProgramCache()
    per_forward = (TINY.depth, len(TINY.dual_attention_layers))
    for step, calls in ((0, 2), (1, 1)):
        inputs = dict(zip(names, args))
        before = _counts()
        prog = cache.get("k", (), inputs, lambda b: mmdit(*(b[n] for n in names)),
                         cuda_device)
        with torch.no_grad():
            prog(inputs)
        torch.cuda.synchronize()
        after = _counts()
        assert tuple(after[k] - before[k] for k in COUNTERS) == tuple(
            calls * n for n in per_forward), step
    assert prog.credits["mmdit_joint_attention"] == TINY.depth
    assert prog.credits["mmdit_self_attention"] == 2


# -- the pipeline ---------------------------------------------------------------------

class _LettersT5:
    """A T5 tokenizer over letters: ids 3 + i, EOS 1, padding 0."""

    def tokenize(self, text, max_length):
        ids = [3 + LETTERS.index(ch) for ch in text if ch in LETTERS][:max_length - 1] + [1]
        pad = max_length - len(ids)
        return (np.array(ids + [0] * pad, np.int32), np.array([1] * len(ids) + [0] * pad,
                                                              np.int32))


class _PlainDenoiser(torch.nn.Module):
    """The plain reference behind the port MMDiT's call signature."""

    def __init__(self, mmdit: MMDiT):
        super().__init__()
        self.config = mmdit.config
        self.plain = _plain(mmdit)

    def forward(self, latents, t, context, pooled, controlnet_residuals=None):
        assert controlnet_residuals is None
        return self.plain(latents, t, context, pooled)


@pytest.fixture(scope="module")
def parts():
    vocab = {}
    for ch in LETTERS:
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    vocab.update({"<|startoftext|>": BOS, "<|endoftext|>": EOS})
    tok = CLIPTokenizer(vocab, [])
    vae = VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4,
                    latent_channels=16, use_quant_conv=False)
    return dict(
        tokenizer=tok, tokenizer2=tok,
        text_encoder=_seeded(CLIPTextEncoder(CLIPTextConfig(**CLIP)), 1),
        text_encoder2=_seeded(CLIPTextEncoder(CLIPTextConfig(**CLIP, use_text_projection=True)),
                              2),
        vae_decoder=_seeded(VAEDecoder(vae), 3), t5_tokenizer=_LettersT5(),
        t5_encoder=_seeded(T5Encoder(T5Config(vocab_size=32, d_model=64, d_kv=8, d_ff=64,
                                              num_layers=2, num_heads=4)), 4),
        t5_sequence_length=16, device="cpu"), _seeded(MMDiT(TINY), 8)


def test_sd3_generation_matches_the_plain_mmditx(parts):
    kw, mmdit = parts
    cfg = PipelineConfiguration(prompt="a red fox", negative_prompt="", seed=11, step_count=3,
                                scheduler="DiscreteFlow", guidance_scale=4.5,
                                disable_safety=True)
    before = _counts()
    got = StableDiffusion3Pipeline(mmdit=mmdit, **kw).generate_images(cfg, image_hw=(64, 64))
    after = _counts()
    want = StableDiffusion3Pipeline(mmdit=_PlainDenoiser(mmdit), **kw).generate_images(
        cfg, image_hw=(64, 64))
    # three CFG steps (batch 2), one forward each; the decode runs no MMDiT
    assert tuple(after[k] - before[k] for k in COUNTERS) == (3 * TINY.depth, 3 * 2)
    assert got.latents.shape == (1, 8, 8, 16) and np.isfinite(got.latents).all()
    np.testing.assert_allclose(got.latents, want.latents, rtol=0, atol=ATOL_LATENTS)
    assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1


# -- loading and sharding ---------------------------------------------------------------

def test_loader_reads_dual_attention_layers(tmp_path):
    """A diffusers ``transformer/`` directory of SD3.5-medium's layout, at a
    tiny width, loads strictly, its dual blocks where the config puts them."""
    src = _seeded(MMDiT(TINY), 9)
    (tmp_path / "config.json").write_text(json.dumps({
        "_class_name": "SD3Transformer2DModel", "num_layers": TINY.depth,
        "num_attention_heads": TINY.num_heads,
        "attention_head_dim": TINY.hidden_size // TINY.num_heads,
        "caption_projection_dim": TINY.hidden_size, "joint_attention_dim": TINY.context_dim,
        "pooled_projection_dim": TINY.pooled_dim, "patch_size": 2, "in_channels": 16,
        "out_channels": 16, "pos_embed_max_size": 16, "qk_norm": "rms_norm",
        "dual_attention_layers": [0, 2]}))
    save_file({k: v.contiguous() for k, v in src.state_dict().items()},
              str(tmp_path / "diffusion_pytorch_model.safetensors"))
    got = load_mmdit(tmp_path, dtype=torch.float32, device="cpu")
    assert got.config == TINY
    args = _inputs(seed=3)
    with torch.no_grad():
        torch.testing.assert_close(got(*args), src(*args), rtol=0, atol=0)


def test_sharding_refuses_dual_attention_blocks(parts):
    kw, mmdit = parts
    with pytest.raises(ValueError, match=r"transformer_blocks\.0, transformer_blocks\.2"):
        shard_params(mmdit, mesh=None)
    with pytest.raises(ValueError, match="dual-attention"):
        param_sharding_rules(mmdit, mesh=None)
    pipe = StableDiffusion3Pipeline(mmdit=mmdit, **kw)
    weights = [p.data_ptr() for p in pipe.text_encoder.parameters()]
    with pytest.raises(ValueError, match="dual-attention"):
        pipe.shard(mesh=None)
    # refused before any module was placed
    assert pipe.mesh is None
    assert [p.data_ptr() for p in pipe.text_encoder.parameters()] == weights
    assert not any(hasattr(m, "shards") for m in pipe.text_encoder.modules())
