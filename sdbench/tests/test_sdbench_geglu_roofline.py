"""geglu.roofline: the least time counted from the configuration's shapes,
and the reader on synthetic slices."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
from conftest import ROOT

from sdbench import run
from sdbench.harness import trace

SD21 = json.loads((ROOT / "sdbench/configs/sd21-base-512.json").read_text())
SDXL = json.loads((ROOT / "sdbench/configs/sdxl-base-1024.json").read_text())
FAMS = trace.families()
READER = run.reader("geglu.roofline")
KERNEL = "void (anonymous namespace)::geglu_vec_kernel<__nv_bfloat16, false>"


def test_the_kernel_has_a_family_of_its_own():
    assert trace.family_of(KERNEL, FAMS) == "geglu"
    assert trace.family_of("void at::native::vectorized_elementwise_kernel<4, "
                           "GeluCUDAKernelImpl>", FAMS) == "elementwise"


@pytest.mark.parametrize("cfg,images,elements,least_ms", [
    # SDXL at batch 8: 10 blocks at 4096 tokens x 2560, 60 at 1024 x 5120;
    # 20.13 GB a step over 30 steps
    (SDXL, 4, 8 * (10 * 4096 * 2560 + 60 * 1024 * 5120), 180.29),
    # SD-2.1 at batch 2: five blocks at each of 4096, 1024 and 256 tokens,
    # the mid block's one at 64; 20 steps
    (SD21, 1, 2 * 5 * (4096 * 1280 + 1024 * 2560 + 256 * 5120) + 2 * 64 * 5120, 3.31),
])
def test_least_time_from_the_shapes(cfg, images, elements, least_ms):
    assert READER.gate_elements(cfg, images) == elements
    assert READER.least_seconds(cfg, images) == pytest.approx(
        cfg["step_count"] * elements * 6 / 3.35e12)
    assert 1e3 * READER.least_seconds(cfg, images) == pytest.approx(least_ms, abs=0.005)


def _record(device, spans):
    s = trace.Slice(0.0, 2.0, device)
    s.spans = spans
    return SimpleNamespace(slice=s, cfg=SDXL, families=FAMS)


def test_a_kernel_at_its_least_time_reads_100():
    least = READER.least_seconds(SDXL, 4)
    rec = _record([(KERNEL, 0.1, 0.1 + least / 2), (KERNEL, 0.5, 0.5 + least / 2),
                   ("void at::native::vectorized_elementwise_kernel<4, MulFunctor>", 0.3, 0.4),
                   (KERNEL, 1.95, 2.5)],  # outside the generation: not counted
                  [("sdbench.generate_images[4]", 0.05, 1.9)])
    assert READER.read(rec) == pytest.approx(100.0)


@pytest.mark.parametrize("device,spans", [
    # the parent: the gate is PyTorch's elementwise kernels
    ([("void at::native::vectorized_elementwise_kernel<4, MulFunctor>", 0.1, 0.2)],
     [("sdbench.generate_images[4]", 0.0, 1.0)]),
    # a geglu kernel, but in no generation wholly inside the slice
    ([(KERNEL, 1.5, 1.6)], [("sdbench.generate_images[4]", 1.0, 2.5)]),
])
def test_nothing_to_read(device, spans):
    assert READER.read(_record(device, spans)) is None
    assert READER.read(SimpleNamespace(slice=None)) is None
