"""The GEGLU gate's CUDA kernel against the eager chain it replaces, on the card.

Skips without an NVIDIA GPU.  This file imports no JAX, so it also runs on
a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_geglu_card.py
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest
import torch

from ml_stable_diffusion_torch.models.unet import FeedForward, UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_torch.ops.activations import geglu, geglu_cuda, gelu_erf, quick_gelu
from ml_stable_diffusion_torch.parallel.train import _plain_kernels
from ml_stable_diffusion_torch.pipelines.program import GenerationProgram

#: (tokens a sample, n) of each feed-forward of the SDXL base UNet at 1024²
#: (128² latents) and the SD-2.1 UNet at 512² (64² latents): n = 4 x channels
SDXL_SHAPES = [(4096, 2560), (1024, 5120)]
SD21_SHAPES = [(4096, 1280), (1024, 2560), (256, 5120), (64, 5120)]


@pytest.fixture
def cuda_device():
    """Decided when the test runs, not at import: every worker collects the
    same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


def _h(rows, n, dtype, seed):
    """Gate values over [-12, 12] (both of erf's ranges, and sigmoid's
    saturation), a values of either sign."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (4.0 * torch.randn(rows, 2 * n, generator=g, device="cuda")).to(dtype)


def _chain(h, fast):
    a, gate = h.chunk(2, dim=-1)
    return a * (quick_gelu if fast else gelu_erf)(gate)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("tokens,n", SDXL_SHAPES + SD21_SHAPES + [(33, 1001), (5, 12)])
def test_kernel_is_bit_equal_to_the_chain(tokens, n, batch, dtype, fast, cuda_device):
    """Every feed-forward shape, and two tails: n = 1001 (no vector divides
    it: the element-wise pass) and n = 12 (float32 vectors, not bf16's)."""
    h = _h(batch * tokens, n, dtype, seed=n + batch)
    before = geglu_cuda.launches
    got = geglu(h.view(batch, tokens, 2 * n), fast=fast)
    assert geglu_cuda.launches == before + 1
    want = _chain(h, fast).view(batch, tokens, n)
    assert got.dtype == dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs().max().item()
    assert torch.equal(got, want), f"max abs difference {diff}"


@pytest.mark.cuda
def test_an_unaligned_base_is_copied(cuda_device):
    buf = _h(1, 2 * 1280 + 1, torch.bfloat16, seed=4).view(-1)
    h = buf[1:4 * 1280 + 1].view(2, 2 * 1280)  # 2 bytes off a 16-byte boundary
    assert h.data_ptr() % 16
    assert torch.equal(geglu_cuda(h), _chain(h, False))


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_captured_and_replayed(fast, cuda_device):
    h = _h(2 * 1024, 5120, torch.bfloat16, seed=7)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        geglu(h, fast=fast)  # warm-up off the capture: builds and loads the kernel
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = geglu(h, fast=fast)
    h.copy_(_h(2 * 1024, 5120, torch.bfloat16, seed=8))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, _chain(h, fast))


def _unet(cfg):
    with torch.device("meta"):
        unet = UNet2DConditionModel(cfg)
    unet = unet.to_empty(device="cuda").to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for p in unet.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=g, device="cuda"))
    return unet.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("preset,want", [("sdxl", 70), ("sd21", 16)])
def test_launches_per_unet_call(preset, want, cuda_device):
    """One launch a transformer block: SDXL base 10 + 60, SD-2.1 5 x 3 + 1,
    whatever the latents' size (here 32², CFG batch 2)."""
    cfg = getattr(UNetConfig, preset)()
    unet = _unet(cfg)
    args = [torch.randn(2, 4, 32, 32, device="cuda"), torch.tensor(500.0, device="cuda"),
            torch.randn(2, 77, cfg.cross_attention_dim, device="cuda")]
    if cfg.addition_embed_type == "text_time":
        args.append({"text_embeds": torch.randn(2, 1280, device="cuda"),
                     "time_ids": torch.tensor([[1024.0, 1024.0, 0, 0, 1024.0, 1024.0]] * 2,
                                              device="cuda")})
    before = geglu_cuda.launches
    with torch.no_grad():
        out = unet(*args)
    torch.cuda.synchronize()
    assert geglu_cuda.launches - before == want
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("preset,want", [("sdxl", 70), ("sd21", 16)])
def test_a_captured_program_credits_its_launches(preset, want, cuda_device):
    """A UNet call inside a ``GenerationProgram``: the capture leaves the
    counter as it was, the first call counts the warm-up and the replay,
    and every later replay adds one UNet call's launches."""
    cfg = getattr(UNetConfig, preset)()
    unet = _unet(cfg)
    g = np.random.default_rng(0)
    inputs = {"latents": g.standard_normal((2, 4, 32, 32), dtype=np.float32),
              "context": g.standard_normal((2, 77, cfg.cross_attention_dim), dtype=np.float32)}
    extra = {}
    if cfg.addition_embed_type == "text_time":
        extra = {"text_embeds": torch.randn(2, 1280, device="cuda"),
                 "time_ids": torch.tensor([[1024.0, 1024.0, 0, 0, 1024.0, 1024.0]] * 2,
                                          device="cuda")}
    t = torch.tensor(500.0, device="cuda")

    def body(b):
        with torch.no_grad():
            args = [b["latents"], t, b["context"]] + ([extra] if extra else [])
            return unet(*args)

    prog = GenerationProgram(body, inputs, torch.device("cuda"))
    before = geglu_cuda.launches
    prog(inputs)
    torch.cuda.synchronize()
    assert prog.warmup_launches["geglu"] == want and prog.credits["geglu"] == want
    assert geglu_cuda.launches - before == 2 * want  # the warm-up and one replay
    before = geglu_cuda.launches
    out = prog(inputs)
    torch.cuda.synchronize()
    assert geglu_cuda.launches - before == want
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_grad_raises_and_the_training_context_takes_the_chain(fast, cuda_device):
    """Under grad the wrapper raises and launches nothing; inside the
    training step's plain-kernel context the chain runs and its backward
    too; without grad the kernel runs."""
    torch.manual_seed(1)
    ff = FeedForward(64, fast_gelu=fast).to("cuda")
    x = torch.randn(2, 16, 64, device="cuda", requires_grad=True)
    before = geglu_cuda.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ff(x)
    assert geglu_cuda.launches == before
    with _plain_kernels():
        ff(x).square().sum().backward()
    assert geglu_cuda.launches == before
    assert x.grad is not None and all(p.grad is not None for p in ff.parameters())
    with torch.no_grad():
        ff(x)
    assert geglu_cuda.launches == before + 1
