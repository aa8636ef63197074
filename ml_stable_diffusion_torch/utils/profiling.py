"""Profiling and tracing (port of ml_stable_diffusion_tpu/utils/profiling.py).

``trace`` records a ``torch.profiler`` session (CPU and, on a card, CUDA
activity, with Python stacks and input shapes) and writes it as a Chrome
trace; ``trace_summary`` reads that file back with the standard library and
sums device time by kernel family and by the port's source lines;
``cost_summary`` counts a function's flops with ``FlopCounterMode`` and
bounds its time at the card's peaks.  The JAX module's roofline constants
are a TPU's; these are the published dense rates of an NVIDIA H100 SXM.

``span`` and ``add`` record the port's own spans (the server's queue and
batches, a generation's host phases, its programs and decode) in memory,
on the ``time.perf_counter_ns`` clock, once ``enable()`` has been called;
``take()`` hands them over.  Recording is off by default, and then
``span`` returns one shared object that does nothing.
"""

from __future__ import annotations

import ast
import contextlib
import glob
import gzip
import itertools
import json
import logging
import os
import re
import tempfile
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

import torch

logger = logging.getLogger(__name__)

#: NVIDIA H100 SXM, dense: bf16 tensor-core rate and HBM3 bandwidth
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

#: kernel families by name, the first match wins (the port's kernels first;
#: the gamma/beta gradient kernels of both norms count as layer_norm)
_FAMILIES = (
    ("flash", ("flash_",)),
    ("group_norm", ("gn_silu", "group_norm", "groupnorm", "rowwisemoments",
                    "computefusedparams", "computeinternalgradients",
                    "computebackwardfusedparams")),
    ("geglu", ("geglu",)),
    ("layer_norm", ("layer_norm", "gammabeta")),
    ("dequant_matmul", ("dequant_", "splitk_reduce")),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "winograd")),
    ("layout", ("nchwtonhwc", "nhwctonchw")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "matmul", "gemv", "splitkreduce")),
    ("softmax", ("softmax",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "catarray", "upsample")),
    ("reduction", ("reduce",)),
)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "python_function", "cuda_runtime", "cuda_driver")
_SOURCE = re.compile(r"(ml_stable_diffusion_torch/[\w/]+\.py)\((\d+)\)")


def _default_dir() -> Path:
    return Path(tempfile.gettempdir()) / "sd_torch_trace"


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Record a ``torch.profiler`` session over the block and write it to
    ``log_dir/<time>_<pid>.pt.trace.json.gz`` (Chrome trace format; open it
    in Perfetto or read it with ``trace_summary``).  Yields the directory."""
    log_dir = Path(log_dir) if log_dir is not None else _default_dir()
    log_dir.mkdir(parents=True, exist_ok=True)
    wanted = {torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA}
    activities = sorted(wanted & set(torch.profiler.supported_activities()),
                        key=lambda a: a.value)
    with torch.profiler.profile(activities=activities, record_shapes=True,
                                with_stack=True) as prof:
        try:
            yield log_dir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = log_dir / f"{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.pt.trace.json.gz"
    prof.export_chrome_trace(str(path))
    logger.info("profile trace written to %s", path)


class SpanRecord(NamedTuple):
    """One finished span.  Times are ``time.perf_counter_ns()``;
    ``parent_id`` is the span that was open on the same thread when this
    one opened (None at the top, and for ``add``'s spans)."""

    name: str
    span_id: int
    parent_id: int | None
    thread_id: int
    start_ns: int
    end_ns: int
    attrs: dict


class _NoSpan:
    """What ``span`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def note(self, **attrs):
        pass


_NO_SPAN = _NoSpan()
_recording = False
_records: list[SpanRecord] = []
_records_lock = threading.Lock()
_span_ids = itertools.count(1)
#: ``.stack``: the ids of the calling thread's open spans, innermost last
_open = threading.local()


def _open_stack() -> list[int]:
    try:
        return _open.stack
    except AttributeError:
        _open.stack = []
        return _open.stack


def _append(record: SpanRecord):
    with _records_lock:
        _records.append(record)


class _Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _open_stack()
        self.parent_id = stack[-1] if stack else None
        self.span_id = next(_span_ids)
        stack.append(self.span_id)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        _open_stack().pop()
        if _recording:  # a span still open at ``disable()`` is dropped
            _append(SpanRecord(self.name, self.span_id, self.parent_id,
                               threading.get_ident(), self.start_ns, end_ns, self.attrs))
        return None

    def note(self, **attrs):
        """Attributes known only once the span's work is done."""
        self.attrs.update(attrs)


def enable():
    """Record spans from now on, in every thread of the process."""
    global _recording
    _recording = True


def disable():
    """Stop recording (a span still open is not recorded); what was
    recorded stays until ``take``."""
    global _recording
    _recording = False


def span(name: str, **attrs):
    """A context manager that records the block as the span ``name`` with
    ``attrs`` (request ids, images, batch size, program kind), nested in the
    span the thread has open.  While recording is off: one shared object
    that takes no clock reading and records nothing."""
    if not _recording:
        return _NO_SPAN
    return _Span(name, attrs)


def add(name: str, start_ns: int, end_ns: int, **attrs):
    """Record a span whose ends were read on two threads (a request's time
    in the server's queue), with no parent."""
    if _recording:
        _append(SpanRecord(name, next(_span_ids), None, threading.get_ident(), start_ns,
                           end_ns, attrs))


def take() -> list[SpanRecord]:
    """The spans recorded so far, in the order they closed; clears them."""
    with _records_lock:
        out = list(_records)
        _records.clear()
    return out


def kernel_family(name: str, cat: str = "kernel") -> str:
    """The family of a device event: ``flash``, ``group_norm``, ``geglu``,
    ``layer_norm``, ``dequant_matmul``, ``conv``, ``layout`` (cuDNN's NCHW
    and NHWC transposes), ``gemm``, ``softmax``, ``elementwise``,
    ``reduction``, ``copy`` (memcpy, memset) or ``other``."""
    if cat != "kernel":
        return "copy"
    low = name.lower()
    return next((fam for fam, keys in _FAMILIES if any(k in low for k in keys)), "other")


def _literal(text):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return None


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def op_flops(name: str, args: dict) -> float | None:
    """Flops of a recorded matmul or convolution from its ``Input Dims``
    (and, for a convolution, its stride, padding, dilation and groups in
    ``Concrete Inputs``); None for any other op."""
    dims = args.get("Input Dims") or []
    consts = args.get("Concrete Inputs") or []
    try:
        if name in ("aten::mm", "aten::bmm"):
            a, b = dims[0], dims[1]
        elif name in ("aten::addmm", "aten::baddbmm"):
            a, b = dims[1], dims[2]
        elif name == "aten::convolution":
            x, w = dims[0], dims[1]
            stride, pad, dil = (_literal(c) for c in consts[3:6])
            if _literal(consts[6]):  # transposed
                return None
            out = [(n + 2 * p - d * (k - 1) - 1) // s + 1
                   for n, k, s, p, d in zip(x[2:], w[2:], stride, pad, dil)]
            return 2.0 * x[0] * _prod(out) * _prod(w)
        elif name == "aten::convolution_backward":
            gy, w = dims[0], dims[2]
            mask = _literal(consts[10])
            return 2.0 * _prod(gy) / gy[1] * _prod(w) * sum(bool(m) for m in mask[:2])
        else:
            return None
        return 2.0 * _prod(a) * b[-1]
    except (IndexError, TypeError, ZeroDivisionError):
        return None


def _launch_context(events) -> dict:
    """correlation id of each runtime launch -> (the innermost port source
    line on the host stack or None, (key, flops) of the innermost op with
    known flops or None), from one sweep over each host thread's nested
    events."""
    threads = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _HOST_CATS:
            threads[(e.get("pid"), e.get("tid"))].append(e)
    out = {}
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack = []  # (end, source or None, (key, flops) or None)
        for n, e in enumerate(evs):
            while stack and stack[-1][0] <= e["ts"]:
                stack.pop()
            args = e.get("args") or {}
            if e["cat"] in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    out[args["correlation"]] = (
                        next((s[1] for s in reversed(stack) if s[1]), None),
                        next((s[2] for s in reversed(stack) if s[2]), None))
                continue
            end = e["ts"] + e.get("dur", 0)
            if e["cat"] == "python_function":
                m = _SOURCE.search(e["name"])
                stack.append((end, m and f"{m[1]}:{m[2]}", None))
            else:
                flops = op_flops(e["name"], args)
                stack.append((end, None, None if flops is None else ((id(evs), n), flops)))
    return out


def _latest_trace(log_dir: Path) -> Path:
    paths = [Path(p) for pattern in ("*.trace.json.gz", "*.trace.json")
             for p in glob.glob(str(log_dir / "**" / pattern), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no *.trace.json[.gz] under {log_dir}")
    return max(paths, key=lambda p: p.stat().st_mtime)


def trace_summary(log_dir: str | Path | None = None, steps: int = 1, top: int = 20) -> dict:
    """Sum the device time of the newest trace under ``log_dir`` by kernel
    family (``by_category``) and by the innermost
    ``ml_stable_diffusion_torch/...py:line`` on the launching host stack
    (``by_source``; launches from threads without Python frames, such as
    autograd's backward, have none).  ``steps`` divides the totals into
    per-step numbers.  Each row: ``name``, ``us_per_step``,
    ``launches_per_step`` and ``tflops``: the flops of the recorded matmuls
    and convolutions whose longest kernel is in the row, over the row's
    time (None where there are none; a captured graph's kernels have
    none)."""
    path = _latest_trace(Path(log_dir) if log_dir is not None else _default_dir())
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    context = _launch_context(events)
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    launches = [context.get((e.get("args") or {}).get("correlation"), (None, None))
                for e in device]
    # an op's flops go to its longest kernel (a cuDNN convolution also
    # launches layout transposes; a split-K GEMM its reduction)
    longest = {}
    for i, (e, (_, op)) in enumerate(zip(device, launches)):
        if op is not None and (op[0] not in longest
                               or e.get("dur", 0) > device[longest[op[0]][0]].get("dur", 0)):
            longest[op[0]] = (i, op[1])
    credit = dict(longest.values())
    cat = defaultdict(lambda: [0.0, 0.0, 0])
    src = defaultdict(lambda: [0.0, 0.0, 0])
    for i, (e, (source, _)) in enumerate(zip(device, launches)):
        for table, key in ((cat, kernel_family(e.get("name", ""), e["cat"])), (src, source)):
            if key is not None:
                row = table[key]
                row[0] += float(e.get("dur", 0))
                row[1] += credit.get(i, 0.0)
                row[2] += 1

    def rows(table):
        return [{"name": k, "us_per_step": d / steps, "launches_per_step": n / steps,
                 "tflops": f / (d * 1e6) if f and d else None}
                for k, (d, f, n) in sorted(table.items(), key=lambda kv: -kv[1][0])[:top]]

    total = sum(v[0] for v in cat.values())
    return {"total_ms_per_step": total / steps / 1e3, "by_category": rows(cat),
            "by_source": rows(src)}


def _tensor_bytes(tree) -> int:
    seen, total = set(), 0
    for x in torch.utils._pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor) and id(x) not in seen:
            seen.add(id(x))
            total += x.numel() * x.element_size()
    return total


def cost_summary(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode`` -> its
    flops (the aten matmuls, convolutions and attention it dispatches; a
    hand-written kernel's work is not seen, so count attention on the plain
    path), the bytes of its arguments, of its parameters and buffers when
    ``fn`` is an ``nn.Module``, and of its outputs, and the least times the
    card could take: ``compute_bound_ms`` at ``PEAK_FLOPS`` and
    ``bandwidth_bound_ms`` with each of those bytes moved once at
    ``PEAK_BYTES_PER_S``.  Gradients are recorded if grad mode is on."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    res = {"flops": flops, "argument_bytes": _tensor_bytes((args, kwargs)),
           "parameter_bytes": (_tensor_bytes([*fn.parameters(), *fn.buffers()])
                               if isinstance(fn, torch.nn.Module) else 0),
           "output_bytes": _tensor_bytes(out)}
    moved = res["argument_bytes"] + res["parameter_bytes"] + res["output_bytes"]
    res["compute_bound_ms"] = flops / PEAK_FLOPS * 1e3
    res["bandwidth_bound_ms"] = moved / PEAK_BYTES_PER_S * 1e3
    return res
