"""A captured program's spans on the card: the first call of a key records
``program.fill``, ``program.capture`` (with the pool's bytes) and
``program.run``; a second call fills and replays and captures nothing.

Skips without an NVIDIA GPU.  This file imports no JAX, so it also runs on
a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_spans_card.py
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import numpy as np
import pytest
import torch

from ml_stable_diffusion_torch.pipelines.program import ProgramCache
from ml_stable_diffusion_torch.utils import profiling


@pytest.fixture
def cuda_device():
    """Decided when the test runs, not at import: every worker collects the
    same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_capture_span_on_the_first_call_only(cuda_device):
    cache = ProgramCache()
    x = np.arange(4096, dtype=np.float32).reshape(64, 64)
    profiling.take()
    profiling.enable()
    try:
        outs = []
        for step in range(2):
            prog = cache.get("k", (), {"x": x + step}, lambda b: b["x"] * 2.0 + 1.0,
                             cuda_device, kind="decode")
            outs.append(prog({"x": x + step}).cpu().numpy())
    finally:
        profiling.disable()
    recs = profiling.take()
    names = [r.name for r in sorted(recs, key=lambda r: r.start_ns)]
    assert names == ["program.fill", "program.capture", "program.run",
                     "program.fill", "program.run"]
    capture = next(r for r in recs if r.name == "program.capture")
    assert capture.attrs["kind"] == "decode" and capture.attrs["pool_bytes"] >= 0
    assert len(cache.captures) == 1
    for step, out in enumerate(outs):
        np.testing.assert_array_equal(out, (x + step) * 2.0 + 1.0)
