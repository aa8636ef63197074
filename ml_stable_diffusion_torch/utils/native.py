"""Build and load the repository's native host libraries (``native/``: the
C++ BPE and unigram tokenizers, the image converter and the safetensors
header parser) through ctypes.

At first use ``make -C native BUILD=<dir>`` compiles all four (a few
seconds with g++) into a fresh directory beside ``BUILD_DIR``
(``build/native/`` at the root of the checkout), and each library is then
moved into ``BUILD_DIR`` with one rename, so that processes building at the
same time never load a half-written file.  A later process finds them
built.  Nothing is written into ``native/build/``.  When the build fails
(no compiler, no ``make``), ``load_library`` raises ``OSError`` after the
failure was logged, and each binding falls back to its pure-Python path;
the failure is remembered, so later calls in the process neither run
``make`` again nor log again.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

logger = logging.getLogger(__name__)

REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO_ROOT / "native"
BUILD_DIR = REPO_ROOT / "build" / "native"
LIBRARIES = ("bpe", "image", "io", "unigram")

#: seconds of the build this process ran (None: it ran none)
build_seconds: float | None = None
#: a build of this process failed: no later call without ``force`` tries again
build_failed = False
_loaded: dict[Path, ctypes.CDLL] = {}


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"libsdtpu_{name}.so"


def build_native(force: bool = False) -> Path | None:
    """Build the four libraries unless they are there -> ``BUILD_DIR``, or
    None when the build failed (logged once: without ``force`` a failed
    build is not tried again)."""
    global build_seconds, build_failed
    if not force and all(lib_path(n).exists() for n in LIBRARIES):
        return BUILD_DIR
    if build_failed and not force:
        return None
    t0 = time.perf_counter()
    tmp = None
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix=".build-", dir=BUILD_DIR))
        subprocess.run(["make", "-C", str(NATIVE_DIR), f"BUILD={tmp}"], check=True,
                       capture_output=True, text=True)
        for n in LIBRARIES:
            os.replace(tmp / f"libsdtpu_{n}.so", lib_path(n))
    except subprocess.CalledProcessError as e:
        logger.warning("native build failed (make exit %d): %s", e.returncode,
                       (e.stderr or "").strip()[-2000:])
        build_failed = True
        return None
    except OSError as e:
        logger.warning("native build failed: %s", e)
        build_failed = True
        return None
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    build_seconds, build_failed = time.perf_counter() - t0, False
    logger.info("native libraries built in %.2f s into %s", build_seconds, BUILD_DIR)
    return BUILD_DIR


def load_library(name: str) -> ctypes.CDLL:
    """``libsdtpu_<name>.so``, built first if needed; ``OSError`` when it
    cannot be built or loaded."""
    path = lib_path(name)
    if not path.exists() and build_native() is None:
        raise OSError(f"native library {path.name} unavailable: its build failed")
    lib = _loaded.get(path)
    if lib is None:
        lib = _loaded[path] = ctypes.CDLL(str(path))
    return lib
