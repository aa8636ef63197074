"""The GEGLU gate's dispatch on the CPU: ``geglu`` is the plain chain there
bit for bit, ``FeedForward`` computes what it computed before the kernel
existed, and the kernel wrapper refuses what its kernel does not take.  The
kernel itself is held against the chain on the card
(tests/test_torch_geglu_card.py)."""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import pytest
import torch

from ml_stable_diffusion_torch.models.unet import FeedForward, UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_torch.ops import activations
from ml_stable_diffusion_torch.ops.activations import geglu, geglu_cuda, gelu_erf, quick_gelu


def _h(rows, n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return (4.0 * torch.randn(rows, 2 * n, generator=g)).to(dtype)


def _chain(h, fast):
    a, gate = h.chunk(2, dim=-1)
    return a * (quick_gelu if fast else gelu_erf)(gate)


@pytest.mark.parametrize("n", [8, 7])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_geglu_on_the_cpu_is_the_plain_chain(dtype, fast, n):
    h = _h(6, n, dtype, seed=n)
    got = geglu(h, fast=fast)
    assert got.dtype == dtype and got.shape == (6, n)
    assert torch.equal(got, _chain(h, fast))


@pytest.mark.parametrize("fast", [False, True])
def test_feed_forward_output_unchanged(fast):
    torch.manual_seed(3)
    ff = FeedForward(16, fast_gelu=fast).to(torch.bfloat16)
    x = torch.randn(2, 5, 16).to(torch.bfloat16)
    with torch.no_grad():
        a, gate = ff.net[0].proj(x).chunk(2, dim=-1)
        want = ff.net[2](a * (quick_gelu if fast else gelu_erf)(gate))
        assert torch.equal(ff(x), want)
    assert ff.gelu is (quick_gelu if fast else gelu_erf)


def test_the_cpu_never_reaches_the_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("geglu_cuda called on the CPU")

    monkeypatch.setattr(activations, "geglu_cuda", refuse)
    cfg = UNetConfig(block_out_channels=(16, 32), down_block_types=(
        "CrossAttnDownBlock2D", "DownBlock2D"), up_block_types=("UpBlock2D",
                                                                "CrossAttnUpBlock2D"),
        layers_per_block=1, transformer_layers_per_block=(1, 1), num_attention_heads=(2, 4),
        cross_attention_dim=16, norm_num_groups=8)
    torch.manual_seed(0)
    unet = UNet2DConditionModel(cfg)
    with torch.no_grad():
        out = unet(torch.randn(1, 4, 8, 8), torch.tensor(10.0), torch.randn(1, 7, 16))
    assert out.shape == (1, 4, 8, 8) and bool(torch.isfinite(out).all())
    h = _h(2, 8, torch.float32, seed=1).requires_grad_()
    assert torch.equal(geglu(h).detach(), _chain(h.detach(), False))


@pytest.mark.parametrize("fast", [False, True])
def test_gradients_are_the_plain_chains(fast):
    h = _h(4, 6, torch.float32, seed=9)
    h1, h2 = h.clone().requires_grad_(), h.clone().requires_grad_()
    w = torch.randn(4, 6, generator=torch.Generator().manual_seed(2))
    (geglu(h1, fast=fast) * w).sum().backward()
    (_chain(h2, fast) * w).sum().backward()
    assert h1.grad is not None and torch.equal(h1.grad, h2.grad)


@pytest.mark.parametrize("h,error,match", [
    (torch.zeros(2, 8), ValueError, "needs a CUDA tensor"),
    (torch.zeros(2, 7), ValueError, "even last dimension"),
    (torch.zeros(8, 2).t(), ValueError, "contiguous"),
    (torch.zeros(2, 8, dtype=torch.float16), ValueError, "float32 or bfloat16"),
    (torch.zeros(2, 8, requires_grad=True), RuntimeError, "no backward"),
])
def test_the_kernel_wrapper_refuses(h, error, match):
    before = geglu_cuda.launches
    with pytest.raises(error, match=match):
        geglu_cuda(h)
    assert geglu_cuda.launches == before


@pytest.mark.parametrize("grad", [False, True])
def test_meta_tensors_take_the_chain(monkeypatch, grad):
    """Shapes are recorded on the meta device (kernel_bounds.py), with grad
    on and off: the chain there, never the kernel wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("geglu_cuda called off the card")

    monkeypatch.setattr(activations, "geglu_cuda", refuse)
    with torch.device("meta"):
        ff = FeedForward(16)
    x = torch.empty(2, 5, 16, device="meta")
    with torch.set_grad_enabled(grad):
        out = ff(x)
    assert out.shape == (2, 5, 16) and out.requires_grad == grad


def test_plain_geglu_nests():
    assert activations._plain_depth == 0
    with activations.plain_geglu():
        with activations.plain_geglu():
            assert activations._plain_depth == 2
        assert activations._plain_depth == 1
    assert activations._plain_depth == 0


@pytest.mark.parametrize("raises", [False, True])
def test_the_training_steps_context_is_undone(raises):
    """``make_train_step``'s one plain-kernel context: plain attention and
    the GEGLU chain inside, both as they were after it, on an error too."""
    from ml_stable_diffusion_torch.ops import attention
    from ml_stable_diffusion_torch.parallel.train import _plain_kernels

    before = attention.ATTENTION_IMPLEMENTATION_IN_EFFECT
    try:
        with _plain_kernels():
            assert attention.ATTENTION_IMPLEMENTATION_IN_EFFECT == attention.AttentionImpl.PLAIN
            assert activations._plain_depth == 1
            if raises:
                raise KeyError("inside")
    except KeyError:
        assert raises
    assert attention.ATTENTION_IMPLEMENTATION_IN_EFFECT == before
    assert activations._plain_depth == 0
