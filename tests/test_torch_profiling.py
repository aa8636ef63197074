"""The port's profiling helpers (``utils/profiling.py``) on the CPU.

``trace_summary`` reads a synthetic trace in torch's Chrome-trace format
(the counterpart of tests/test_utils_extra.py::test_trace_summary_synthetic
for the JAX module); the flops it gives a recorded matmul or convolution are
held against a hand count on a trace recorded on the CPU; ``cost_summary``'s
flops for a tiny UNet forward equal a count worked out from the shapes of
its layers.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses
import gzip
import json

import pytest
import torch
import torch.nn.functional as F

from ml_stable_diffusion_torch.models.unet import Attention, UNet2DConditionModel, UNetConfig
from ml_stable_diffusion_torch.ops.attention import AttentionImpl, set_attention_implementation
from ml_stable_diffusion_torch.utils.profiling import (
    PEAK_BYTES_PER_S,
    PEAK_FLOPS,
    cost_summary,
    kernel_family,
    op_flops,
    trace,
    trace_summary,
)

from torch_helpers import tiny_unet, traced

CONV_DIMS = [[2, 4, 8, 8], [8, 4, 3, 3], [8], [], [], [], [], [], []]
CONV_CONSTS = ["", "", "", "[1, 1]", "[1, 1]", "[1, 1]", "False", "[0, 0]", "1"]
CONV_FLOPS = 2 * 2 * 8 * 8 * (8 * 4 * 3 * 3)
BMM_FLOPS = 2 * 4 * 64 * 32 * 64


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _kernel(name, corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr, "External id": corr}}


def test_trace_summary_synthetic(tmp_path):
    unet = "ml_stable_diffusion_torch/models/unet.py"
    events = [
        {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "python"}},
        # a convolution launched from the UNet
        _x("python_function", f"{unet}(233): forward", 0, 100),
        _x("cpu_op", "aten::conv2d", 5, 50),
        _x("cpu_op", "aten::convolution", 6, 48, **{"Input Dims": CONV_DIMS,
                                                     "Concrete Inputs": CONV_CONSTS}),
        _x("cuda_runtime", "cudaLaunchKernel", 8, 1, correlation=9),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 5, correlation=1),
        # one bmm, two launches: its flops count once
        _x("python_function", "ml_stable_diffusion_torch/ops/attention.py(55): _plain_attention",
           200, 50),
        _x("cpu_op", "aten::bmm", 205, 30, **{"Input Dims": [[4, 64, 32], [4, 32, 64]]}),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 5, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 220, 5, correlation=6),
        # an elementwise op under torch's own frame, inside a port frame
        _x("python_function", f"{unet}(300): forward", 300, 60),
        _x("python_function", "torch/nn/modules/activation.py(400): forward", 301, 50),
        _x("cpu_op", "aten::silu", 305, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 310, 5, correlation=4),
        # a captured graph's replay: two flash kernels under one launch
        _x("python_function", "ml_stable_diffusion_torch/pipelines/program.py(90): replay",
           400, 30),
        _x("cuda_runtime", "cudaGraphLaunch", 405, 10, correlation=5),
        # the autograd thread: no Python frames
        _x("cpu_op", "autograd::engine::evaluate_function", 500, 40, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 510, 5, tid=2, correlation=7),
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 1, "tid": 1, "ts": 10, "id": 1},
        # the convolution's layout transpose, then the convolution: its flops
        # go to the longer kernel
        _kernel("void cudnn::engines_precompiled::nchwToNhwcKernel<bf16>", 9, 990, 1.0),
        _kernel("sm90_xmma_fprop_implicit_gemm_bf16f32_tilesize128x128", 1, 1000, 10.0),
        _kernel("nvjet_hsh_128x64_64x4_1x2_h_bz_coopA_NNT", 2, 1100, 4.0),
        _kernel("nvjet_hsh_128x64_64x4_1x2_h_bz_coopA_NNT", 6, 1110, 4.0),
        _kernel("void at::native::vectorized_elementwise_kernel<4, silu>", 4, 1200, 3.0),
        _kernel("void flash_wgmma_bf16<2, 64>(FlashParams)", 5, 1300, 20.0),
        _kernel("void flash_wgmma_bf16<2, 64>(FlashParams)", 5, 1330, 20.0),
        _kernel("sm90_xmma_wgrad_implicit_gemm", 7, 1400, 6.0),
        _kernel("Memcpy HtoD (Pageable -> Device)", 8, 1500, 2.0, cat="gpu_memcpy"),
    ]
    with gzip.open(tmp_path / "host_1.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)

    s = trace_summary(tmp_path, steps=2)
    assert s["total_ms_per_step"] == pytest.approx(70.0 / 2 / 1e3)
    cats = {r["name"]: r for r in s["by_category"]}
    assert list(cats) == ["flash", "conv", "gemm", "elementwise", "copy", "layout"]
    assert cats["layout"]["tflops"] is None
    assert cats["flash"]["us_per_step"] == 20.0 and cats["flash"]["launches_per_step"] == 1.0
    assert cats["flash"]["tflops"] is None
    assert cats["conv"]["us_per_step"] == 8.0
    assert cats["conv"]["tflops"] == pytest.approx(CONV_FLOPS / (16.0 * 1e6))
    assert cats["gemm"]["tflops"] == pytest.approx(BMM_FLOPS / (8.0 * 1e6))
    srcs = {r["name"]: r for r in s["by_source"]}
    assert set(srcs) == {f"{unet}:233", "ml_stable_diffusion_torch/ops/attention.py:55",
                         f"{unet}:300", "ml_stable_diffusion_torch/pipelines/program.py:90"}
    assert srcs["ml_stable_diffusion_torch/pipelines/program.py:90"]["launches_per_step"] == 1.0
    assert srcs[f"{unet}:300"]["us_per_step"] == 1.5
    assert len(trace_summary(tmp_path, top=2)["by_category"]) == 2


@pytest.mark.parametrize("name,family", [
    ("void flash_wgmma_persistent<2, 40, 2>(PersistentParams)", "flash"),
    ("void gn_silu_kernel<__nv_bfloat16>(GnParams)", "group_norm"),
    ("void (anonymous namespace)::geglu_vec_kernel<__nv_bfloat16, false>"
     "(const __nv_bfloat16*, __nv_bfloat16*, long long, long long)", "geglu"),
    ("void dequant_wgmma_bf16<128, 128>(Args)", "dequant_matmul"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv"),
    ("nvjet_hsh_256x128_64x4_2x1_v_bz_coopB_TNT", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor<float>>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float, MeanOps>>", "reduction"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>", "layer_norm"),
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>", "group_norm"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float>", "layout"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float>", "gemm"),
    ("void (anonymous namespace)::cunn_SoftMaxForwardReg<float, float>", "softmax"),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc", "conv"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex", "other"),
])
def test_kernel_families(name, family):
    assert kernel_family(name) == family


def _recorded_ops(log_dir):
    (path,) = log_dir.glob("*.pt.trace.json.gz")
    with gzip.open(path, "rt") as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("cat") == "cpu_op"]


def test_recorded_op_flops_match_a_hand_count(tmp_path):
    """What the profiler records on the CPU for a convolution, its backward and
    the three matmuls, read by ``op_flops``."""
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    w = torch.randn(8, 4, 3, 3, requires_grad=True)
    a, b = torch.randn(16, 32), torch.randn(32, 24)
    with trace(tmp_path) as d:
        F.conv2d(x, w, stride=2, padding=1).sum().backward()
        torch.mm(a, b)
        torch.addmm(torch.zeros(24), a, b)
        torch.bmm(torch.randn(3, 16, 32), torch.randn(3, 32, 24))
    assert d == tmp_path
    got = {}
    for e in _recorded_ops(tmp_path):
        flops = op_flops(e["name"], e["args"])
        if flops is not None:
            got[e["name"]] = flops
    conv = 2 * 2 * 4 * 4 * (8 * 4 * 3 * 3)
    assert got == {"aten::convolution": conv, "aten::convolution_backward": 2 * conv,
                   "aten::mm": 2 * 16 * 32 * 24, "aten::addmm": 2 * 16 * 32 * 24,
                   "aten::bmm": 2 * 3 * 16 * 32 * 24}
    # no device here: nothing ran on a card
    assert trace_summary(tmp_path)["total_ms_per_step"] == 0.0


def _hand_count(model, *inputs):
    """2 x multiply-adds of every convolution and linear layer from its
    weight and output shapes, plus attention's two products, 4 B Sq Sk C."""
    total = 0

    def conv(m, args, out):
        nonlocal total
        total += 2 * out.numel() * m.weight[0].numel()

    def linear(m, args, out):
        nonlocal total
        total += 2 * out.numel() * m.in_features

    def attn(m, args, out):
        nonlocal total
        x = args[0]
        context = args[1] if len(args) > 1 and args[1] is not None else x
        total += 4 * x.shape[0] * x.shape[1] * context.shape[1] * x.shape[2]

    hooks = []
    for m in model.modules():
        fn = {torch.nn.Conv2d: conv, torch.nn.Linear: linear, Attention: attn}.get(type(m))
        if fn is not None:
            hooks.append(m.register_forward_hook(fn))
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return total


def test_cost_summary_flops_match_the_shapes():
    jax_model, _ = traced(tiny_unet)
    unet = UNet2DConditionModel(UNetConfig(**dataclasses.asdict(jax_model.config)))
    g = torch.Generator().manual_seed(0)
    inputs = (torch.randn(2, 4, 16, 16, generator=g), torch.tensor([10.0, 500.0]),
              torch.randn(2, 77, 48, generator=g))
    set_attention_implementation(AttentionImpl.PLAIN)
    try:
        with torch.no_grad():
            cost = cost_summary(unet, *inputs)
        want = _hand_count(unet, *inputs)
    finally:
        set_attention_implementation(AttentionImpl.AUTO)
    assert cost["flops"] == want
    assert cost["argument_bytes"] == sum(x.numel() * 4 for x in inputs)
    assert cost["parameter_bytes"] == sum(p.numel() * 4 for p in unet.parameters())
    assert cost["output_bytes"] == 2 * 4 * 16 * 16 * 4
    assert cost["compute_bound_ms"] == pytest.approx(want / PEAK_FLOPS * 1e3)
    moved = cost["argument_bytes"] + cost["parameter_bytes"] + cost["output_bytes"]
    assert cost["bandwidth_bound_ms"] == pytest.approx(moved / PEAK_BYTES_PER_S * 1e3)
