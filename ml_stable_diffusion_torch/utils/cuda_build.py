"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  On first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at the
root of the checkout, under a file name keyed on the hash of the source and
of the shared ``csrc/*.cuh`` headers, and
loaded with ``ctypes``.  A later process finds the library already built; a
changed source builds anew.  Nothing here runs at import time.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
#: name -> (seconds, nvcc's ptxas report) of the build this process ran
build_reports: dict[str, tuple[float, str]] = {}


def refuse_grad(who: str, plain: str, *tensors):
    """Raise ``RuntimeError`` when autograd would need a gradient through a
    hand-written kernel.  A kernel fills a ``torch.empty`` through ctypes, so
    its output has no ``grad_fn`` and a backward pass would stop there
    without a word; the kernels have no backward, as the JAX package's
    Pallas kernels have none.  ``plain``: the differentiable path to name."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{who} has no backward: an input requires grad with grad mode "
                           f"on; run {plain}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source exists."""
    # the key covers the shared headers too: a changed helper rebuilds
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu"), "-ldl"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_reports[name] = (time.perf_counter() - t0, proc.stderr)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib


def build_all() -> list[Path]:
    """Build every ``csrc/*.cu`` at once, one ``nvcc`` process per source."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as pool:
        return list(pool.map(build, names))
