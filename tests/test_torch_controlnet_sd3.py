"""The port's SD3 ControlNet and the MMDiT's residual scheme against the JAX
package, and SD3 generations with T5 and with SD3 ControlNets against the
JAX ``StableDiffusion3Pipeline``, on the CPU.

Tiny models, seeded N(0, 0.2) weights (the nets' zero-initialised patch
embedding and projections too, so the residuals move the latents):

- the MMDiT with 3, 4 and 5 residuals against a depth-5 MMDiT (interval =
  ceil(5 / n): 2, 2, 1; the last block adds none), and the ControlNet, each
  against Flax in float32: relative RMS error at most 1e-5 (a thousandth of
  what the residuals move the MMDiT's output by), and max abs within
  tests/test_torch_mmdit.py's MMDiT bound, 2e-4, or for the ControlNet's
  residuals (peaks ~100 with these weights) 2e-5 of the peak: the timestep
  embedding's sin/cos at ~1000 rad differ by an f32 ulp of the argument
  (ROADMAP Queue 3).  A residual only the last block would read changes
  nothing;
- whole generations (latents atol 1e-3, uint8 within 1, as
  tests/test_torch_sd3.py holds SD3): one net with
  ``force_zeros_for_pooled_projection`` true, one with it false, both nets
  together, and the T5 encoder on (tests/test_torch_sd3.py runs it off).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_stable_diffusion_tpu.models.controlnet_sd3 import SD3ControlNetConfig as JaxCNConfig
from ml_stable_diffusion_tpu.models.controlnet_sd3 import SD3ControlNetModel as JaxCN
from ml_stable_diffusion_tpu.models.mmdit import MMDiT as JaxMMDiT
from ml_stable_diffusion_tpu.models.mmdit import MMDiTConfig as JaxMMDiTConfig
from ml_stable_diffusion_tpu.models.t5 import T5Config as JaxT5Config
from ml_stable_diffusion_tpu.models.t5 import T5Encoder as JaxT5Encoder
from ml_stable_diffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
from ml_stable_diffusion_tpu.models.vae import VAEEncoder as JaxVAEEncoder
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig
from ml_stable_diffusion_tpu.tokenizer.t5 import T5Tokenizer as JaxT5Tokenizer

from ml_stable_diffusion_torch.convert.from_jax import (
    mmdit_state_dict,
    sd3_controlnet_state_dict,
    t5_state_dict,
)
from ml_stable_diffusion_torch.models.controlnet_sd3 import (
    SD3ControlNetConfig,
    SD3ControlNetModel,
)
from ml_stable_diffusion_torch.models.mmdit import MMDiT, MMDiTConfig
from ml_stable_diffusion_torch.models.t5 import T5Config, T5Encoder
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration
from ml_stable_diffusion_torch.tokenizer.t5 import T5Tokenizer

from helpers import randomize_params
from test_native_t5 import _unigram_json
from test_torch_sd3 import HW, MM_CTX, POOLED, T5_LEN, _kw, pair  # noqa: F401
from test_torch_models import _layout
from torch_helpers import port_vae_encoder

MM = dict(patch_size=2, in_channels=16, out_channels=16, hidden_size=32, num_heads=4,
          context_dim=MM_CTX, pooled_dim=POOLED, pos_embed_max_size=16)
#: the MMDiT bound of tests/test_torch_mmdit.py
ATOL = 2e-4
REL_RMS = 1e-5


def _rel_rms(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _flax_mmdit(depth, seed):
    model = JaxMMDiT(JaxMMDiTConfig(depth=depth, **MM))
    params = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 8, 8, 16)),
                            jnp.zeros((1,)), jnp.zeros((1, 10, MM_CTX)),
                            jnp.zeros((1, POOLED)))["params"]
    return model, randomize_params(params, seed)


def _flax_controlnet(num_layers, seed, force_zeros=True, depth=2):
    cfg = JaxCNConfig(mmdit=JaxMMDiTConfig(depth=depth, **MM), num_layers=num_layers,
                      force_zeros_for_pooled_projection=force_zeros)
    model = JaxCN(cfg)
    z = jnp.zeros((1, 8, 8, 16))
    params = jax.eval_shape(model.init, jax.random.key(1), z, jnp.zeros((1,)),
                            jnp.zeros((1, 10, MM_CTX)), jnp.zeros((1, POOLED)), z)["params"]
    return model, randomize_params(params, seed)


def _port_mmdit(model, params):
    port = MMDiT(MMDiTConfig(**dataclasses.asdict(model.config)))
    port.load_state_dict(mmdit_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    return port


def _port_controlnet(model, params):
    cfg = model.config
    port = SD3ControlNetModel(SD3ControlNetConfig(
        mmdit=MMDiTConfig(**dataclasses.asdict(cfg.mmdit)), num_layers=cfg.num_layers,
        force_zeros_for_pooled_projection=cfg.force_zeros_for_pooled_projection))
    port.load_state_dict(sd3_controlnet_state_dict(jax.tree.map(np.asarray, params)),
                         strict=True)
    return port


def _inputs(seed=3):
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(2, 8, 8, 16).astype(np.float32),
                t=np.asarray([997.25, 3.5], np.float32),
                ctx=rng.randn(2, 10, MM_CTX).astype(np.float32),
                pooled=rng.randn(2, POOLED).astype(np.float32),
                cond=rng.randn(2, 8, 8, 16).astype(np.float32))


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def mmdit5():
    model, params = _flax_mmdit(5, 41)
    return model, params, _port_mmdit(model, params)


@pytest.mark.parametrize("n", [3, 4, 5])
def test_mmdit_residuals_match_flax(mmdit5, n):
    """depth 5: n = 3 and 4 give interval 2 (blocks 0-1, 2-3 read residuals
    0 and 1; 3 of 3 and 4 of 4 unread), n = 5 interval 1; block 4, the
    context_pre_only one, adds none."""
    model, params, port = mmdit5
    inp = _inputs()
    rng = np.random.RandomState(10 + n)
    res = [rng.randn(2, 16, 32).astype(np.float32) * 0.5 for _ in range(n)]
    ref = np.asarray(model.apply({"params": params}, inp["x"], inp["t"], inp["ctx"],
                                 inp["pooled"], controlnet_residuals=tuple(res)))
    base = np.asarray(model.apply({"params": params}, inp["x"], inp["t"], inp["ctx"],
                                  inp["pooled"]))
    args = (_nchw(inp["x"]), torch.from_numpy(inp["t"]), torch.from_numpy(inp["ctx"]),
            torch.from_numpy(inp["pooled"]))
    with torch.no_grad():
        got = port(*args, controlnet_residuals=[torch.from_numpy(r) for r in res])
        unread = [torch.from_numpy(r) for r in res]
        unread[-1] = unread[-1] + 100.0  # read by no block but the last
        got_unread = port(*args, controlnet_residuals=unread)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert _rel_rms(got, ref) <= REL_RMS
    # the residuals move the output far more than the two differ
    assert _rel_rms(base, ref) > 1e3 * REL_RMS
    # n = 3, 4: residual n-1 is past the last interval; n = 5: the last
    # block's own, which it does not add
    assert torch.equal(got_unread.permute(0, 2, 3, 1), torch.from_numpy(got))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_controlnet_matches_flax(scale):
    model, params = _flax_controlnet(2, 42)
    port = _port_controlnet(model, params)
    inp = _inputs(4)
    ref, ref_mid = model.apply({"params": params}, inp["x"], inp["t"], inp["ctx"],
                               inp["pooled"], inp["cond"], conditioning_scale=scale)
    with torch.no_grad():
        got, mid = port(_nchw(inp["x"]), torch.from_numpy(inp["t"]),
                        torch.from_numpy(inp["ctx"]), torch.from_numpy(inp["pooled"]),
                        _nchw(inp["cond"]), conditioning_scale=scale)
    assert mid is None and ref_mid is None and len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == (2, 16, 32)
        g, r = g.numpy(), np.asarray(r)
        assert np.abs(g - r).max() <= 2e-5 * np.abs(r).max()
        assert _rel_rms(g, r) <= REL_RMS


def test_sd3_medium_controlnet_layout_loads():
    """Every converted key of the full-size JAX net exists in the port's
    module with the converted shape, and nothing is missing (what a strict
    load checks), from abstract shapes only."""
    jcfg = JaxCNConfig.sd3_medium()
    z = jnp.zeros((1, 16, 16, 16))
    layout = _layout(JaxCN(jcfg), (z, jnp.zeros((1,)), jnp.zeros((1, 154, 4096)),
                                   jnp.zeros((1, 2048)), z), sd3_controlnet_state_dict)
    with torch.device("meta"):
        port = SD3ControlNetModel(SD3ControlNetConfig.sd3_medium())
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    M, D = jcfg.mmdit.pos_embed_max_size, jcfg.mmdit.hidden_size
    assert layout.pop("pos_embed.pos_embed") == (M, M, D)
    assert want.pop("pos_embed.pos_embed") == (1, M * M, D)
    assert layout == want
    n = sum(p.numel() for p in port.parameters())
    assert 1.0e9 < n < 1.2e9, n  # ~1.1 B parameters


# -- generations ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def parts(pair):
    """The tiny SD3 pipelines of tests/test_torch_sd3.py plus a 16-channel
    VAE encoder and two nets, force_zeros true and false."""
    jax_pipe, port_pipe = pair
    cfg = JaxVAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                       norm_num_groups=4, latent_channels=16, use_quant_conv=False)
    enc = JaxVAEEncoder(cfg)
    ep = randomize_params(jax.eval_shape(enc.init, jax.random.key(5), jnp.zeros((1, 64, 64, 3)))[
        "params"], 35)
    nets = [_flax_controlnet(2, 43 + i, force_zeros=fz) for i, fz in enumerate((True, False))]
    return dict(jax_pipe=jax_pipe, port_pipe=port_pipe, enc=(enc, ep),
                port_enc=port_vae_encoder(enc, ep), nets=nets,
                port_nets=[_port_controlnet(*net) for net in nets])


def _with_nets(parts, which):
    jax_pipe, port_pipe = (copy.copy(parts[k]) for k in ("jax_pipe", "port_pipe"))
    jax_pipe.vae_encoder, jax_pipe.vae_encoder_params = parts["enc"]
    jax_pipe.controlnets = [parts["nets"][i] for i in which]
    jax_pipe._programs = {}
    port_pipe.vae_encoder = parts["port_enc"]
    port_pipe.controlnets = [parts["port_nets"][i] for i in which]
    return jax_pipe, port_pipe


def _control(seed):
    return np.random.RandomState(seed).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)


def _assert_generations_agree(jax_pipe, port_pipe, kw):
    ref = jax_pipe.generate_images(JaxConfig(**kw), image_hw=HW)
    got = port_pipe.generate_images(PipelineConfiguration(**kw), image_hw=HW)
    assert got.latents.shape == (1, 8, 8, 16) and np.isfinite(got.latents).all()
    np.testing.assert_allclose(got.latents, ref.latents, atol=1e-3)
    ref_images = np.stack([np.asarray(im) for im in ref.images])
    assert np.abs(got.images.astype(int) - ref_images.astype(int)).max() <= 1
    return got


@pytest.mark.parametrize("which", [(0,), (1,), (0, 1)],
                         ids=["force_zeros", "pooled_and_shift", "two_nets"])
def test_generation_with_controlnets_matches_jax(parts, which):
    jax_pipe, port_pipe = _with_nets(parts, which)
    kw = _kw(controlnet_inputs=[_control(60 + i) for i in which])
    got = _assert_generations_agree(jax_pipe, port_pipe, kw)
    plain = parts["port_pipe"].generate_images(PipelineConfiguration(**_kw()), image_hw=HW)
    assert np.abs(got.latents - plain.latents).max() > 1e-3  # the nets move the latents


def test_generation_with_t5_matches_jax(parts, tmp_path):
    """T5 on: its ids and mask at t5_sequence_length, its states as the
    context's last T5_LEN rows."""
    tok_json = _unigram_json(tmp_path)
    cfg = dict(vocab_size=256, d_model=MM_CTX, d_kv=16, d_ff=64, num_layers=2, num_heads=4)
    t5 = JaxT5Encoder(JaxT5Config(**cfg))
    ids = jnp.ones((1, T5_LEN), jnp.int32)
    t5_p = randomize_params(jax.eval_shape(t5.init, jax.random.key(6), ids, ids)["params"], 36)
    port_t5 = T5Encoder(T5Config(**cfg))
    port_t5.load_state_dict(t5_state_dict(jax.tree.map(np.asarray, t5_p)), strict=True)
    jax_pipe, port_pipe = (copy.copy(parts[k]) for k in ("jax_pipe", "port_pipe"))
    jax_pipe.t5_encoder, jax_pipe.t5_encoder_params = t5, t5_p
    jax_pipe.t5_tokenizer = JaxT5Tokenizer(tok_json)
    jax_pipe._programs = {}
    port_pipe.t5_encoder, port_pipe.t5_tokenizer = port_t5.eval(), T5Tokenizer(tok_json)
    kw = _kw(prompt="a photo of the cat", negative_prompt="hello world")
    got = _assert_generations_agree(jax_pipe, port_pipe, kw)
    plain = parts["port_pipe"].generate_images(PipelineConfiguration(**kw), image_hw=HW)
    assert np.abs(got.latents - plain.latents).max() > 1e-3  # T5 moves the latents
