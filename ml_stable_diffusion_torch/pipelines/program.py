"""One captured program per generation: the counterpart of the JAX
pipelines' ``_build_program`` and their ``_programs`` cache
(ml_stable_diffusion_tpu/pipelines/sd.py:812, :182).

The JAX package traces a whole generation (text encode -> start -> the
denoise scan -> latents) into one XLA program per cache key and calls it
with new arguments.  Here the same generation is one ``torch.cuda.CUDAGraph``
per key:

- ``GenerationProgram`` holds static input buffers, a body that reads only
  them and returns one output tensor, and the graph.  The first call copies
  its inputs into the buffers, runs the body once eagerly on a side stream
  (the kernels build, the libraries initialise, every lazy allocation
  happens there), captures it, and replays it; a later call copies and
  replays.  On a CPU device the body runs uncaptured on the buffers: the
  only place it runs without a graph.  A capture error raises; nothing
  falls back to the eager loop.
- A replay runs no Python, so the kernel wrappers' launch counters
  (``.launches`` of each function in ``kernel_counters()``) would not move.
  The counts taken while the body is captured are the program's credit:
  the counters are put back after the capture (a capture launches nothing)
  and every replay adds the credit.  The warm-up's launches are real and
  count; a capture whose counts differ from its warm-up's raises.
- ``ProgramCache`` is a pipeline's programs by key, all captured into one
  memory pool: programs of one pipeline never run at once, and each call's
  output is read before the next program runs.  The cache also holds the
  addresses of the weights the programs were captured against and is
  emptied when they move (a module replaced, moved or cast).

The key (``program_key``) is JAX's generate_images key, field for field
(``JAX_KEY_FIELDS``), then what the port's body bakes that JAX's key lacks,
then the name, shape and dtype of every static input (``jax.jit`` retraces on
a new input shape by itself, a graph does not) with the host flags the body
branches on, then the denoiser's dtype, then a sharded pipeline's mesh shape
and rank (``mesh_key``).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..utils import profiling

#: the fields of the JAX program key, as its source spells them, in order
#: (ml_stable_diffusion_tpu/pipelines/sd.py:1327-1336); ``program_key``
#: computes the same values in the same order
JAX_KEY_FIELDS = (
    "cfg.scheduler", "cfg.step_count", "N", "h", "w", "guidance_on", "n_ctrl",
    "img2img", "inpaint", "ip_on", "round(cfg.ip_adapter_scale, 4) if ip_on else 0",
    "cfg.unet_batch_one", "cfg.rng == 'jax'", "cfg.timestep_spacing", "round(strength, 4)",
    "cfg.guidance_scale", "cfg.timestep_shift", "cfg.attention_implementation",
    "cfg.use_denoised_intermediates", "cfg.deepcache_interval",
    "self._conditioning_cache_key(cfg)",
)


def jax_key(cfg, N, h, w, guidance_on, n_ctrl, img2img, inpaint, ip_on, strength,
            conditioning) -> tuple:
    """The values of ``JAX_KEY_FIELDS``."""
    return (cfg.scheduler, cfg.step_count, N, h, w, guidance_on, n_ctrl, img2img, inpaint,
            ip_on, round(cfg.ip_adapter_scale, 4) if ip_on else 0, cfg.unet_batch_one,
            cfg.rng == "jax", cfg.timestep_spacing, round(strength, 4), cfg.guidance_scale,
            cfg.timestep_shift, cfg.attention_implementation,
            cfg.use_denoised_intermediates, cfg.deepcache_interval, conditioning)


def input_signature(inputs: dict) -> tuple:
    """(name, shape, dtype) of every host array and (name, value) of every
    host flag, sorted by name."""
    return tuple((name, v.shape, str(v.dtype)) if isinstance(v, np.ndarray) else (name, v)
                 for name, v in sorted(inputs.items()))


def mesh_key(mesh) -> tuple | None:
    """A sharded pipeline's mesh shape and this process's rank (None
    unsharded): each rank captures its own program over its own shards."""
    if mesh is None:
        return None
    return tuple(mesh.shape), dist.get_rank()


def program_key(jax_part: tuple, port_part: tuple, inputs: dict, dtype, mesh=None) -> tuple:
    return (jax_part, port_part, input_signature(inputs), str(dtype), mesh)


def kernel_counters() -> dict[str, object]:
    """The kernel wrappers, each counting its launches in ``.launches``, and
    the MMDiT's attention calls by path (joint, and MMDiT-X self), counted
    the same way."""
    from ..models.mmdit import mmdit_joint_attention, mmdit_self_attention
    from ..ops.flash_attention import (
        flash_attention_cuda,
        flash_attention_multi_q_cuda,
        flash_attention_wide_f32_cuda,
        flash_split_tf32_cuda,
    )
    from ..ops.activations import geglu_cuda
    from ..ops.groupnorm import group_norm_silu_cuda
    from ..ops.palettized import palettized_dense_fused_cuda

    return {"flash_attention": flash_attention_cuda,
            "flash_attention_multi_q": flash_attention_multi_q_cuda,
            "flash_attention_wide_f32": flash_attention_wide_f32_cuda,
            "flash_split_tf32": flash_split_tf32_cuda,
            "group_norm_silu": group_norm_silu_cuda,
            "palettized_dense_fused": palettized_dense_fused_cuda,
            "geglu": geglu_cuda,
            "mmdit_joint_attention": mmdit_joint_attention,
            "mmdit_self_attention": mmdit_self_attention}


def _counts(counters) -> dict[str, int]:
    return {name: fn.launches for name, fn in counters.items()}


class GenerationProgram:
    """Static input buffers, a body over them, and (on the card) the graph
    that replays it.  ``inputs``: the first call's inputs, which fix the
    buffers' shapes and dtypes (host arrays; anything else is a host flag
    handed to the body as it is).  ``kind`` names the program in its spans
    (``program.fill``, ``program.capture``, ``program.run``)."""

    def __init__(self, body: Callable[[dict], torch.Tensor], inputs: dict,
                 device: torch.device, pool=None, on_capture=None, kind: str = "generation"):
        self.body = body
        self.device = device
        self.kind = kind
        self.pool = pool
        self.on_capture = on_capture
        self.buffers: dict = {}
        self._staging: dict = {}
        for name, v in inputs.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(v))
                self.buffers[name] = torch.empty(t.shape, dtype=t.dtype, device=device)
                if device.type == "cuda":  # pinned host copies fill the buffers
                    self._staging[name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            else:
                self.buffers[name] = v
        self.graph: torch.cuda.CUDAGraph | None = None
        self.output: torch.Tensor | None = None
        #: launches a replay credits, by counter name (the capture's counts)
        self.credits: dict[str, int] = {}
        #: the eager warm-up's launches, by counter name
        self.warmup_launches: dict[str, int] = {}
        self.capture_seconds = 0.0
        #: growth of the card's reserved memory across the capture (the pool)
        self.pool_bytes = 0

    def _fill(self, inputs: dict):
        with profiling.span("program.fill", kind=self.kind):
            for name, v in inputs.items():
                buf = self.buffers[name]
                if not isinstance(buf, torch.Tensor):
                    continue
                src = torch.from_numpy(np.ascontiguousarray(v))
                if src.shape != buf.shape or src.dtype != buf.dtype:
                    raise ValueError(f"input {name!r} is {tuple(src.shape)} {src.dtype}; the "
                                     f"program was built for {tuple(buf.shape)} {buf.dtype}")
                staging = self._staging.get(name)
                if staging is not None:
                    staging.copy_(src)
                    src = staging
                buf.copy_(src, non_blocking=True)

    def __call__(self, inputs: dict) -> torch.Tensor:
        """Fill the buffers from ``inputs`` and run: -> the body's output
        (the program's own tensor: read it before the next call)."""
        self._fill(inputs)
        if self.device.type == "cuda" and self.graph is None:
            self._capture()
        with profiling.span("program.run", kind=self.kind):
            if self.device.type != "cuda":
                return self.body(self.buffers)
            self.graph.replay()
            for name, fn in kernel_counters().items():
                fn.launches += self.credits.get(name, 0)
        return self.output

    def _capture(self):
        """The eager warm-up on a side stream, then the capture."""
        with profiling.span("program.capture", kind=self.kind) as capture_span:
            counters = kernel_counters()
            t0 = time.perf_counter()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            before = _counts(counters)
            with torch.cuda.stream(side):
                self.body(self.buffers)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.warmup_launches = {k: v - before[k] for k, v in _counts(counters).items()}
            torch.cuda.synchronize(self.device)
            # the warm-up's cached blocks go back to the card first (the capture
            # would release them itself), so that the growth below is the pool's
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            before = _counts(counters)
            try:
                with torch.cuda.graph(graph, pool=self.pool):
                    output = self.body(self.buffers)
            finally:
                # a capture launches nothing: its counts become the credit
                captured = _counts(counters)
                for name, fn in counters.items():
                    fn.launches = before[name]
            credits = {k: v - before[k] for k, v in captured.items()}
            if credits != self.warmup_launches:
                raise RuntimeError(f"the captured body launched {credits}, its warm-up "
                                   f"{self.warmup_launches}: the body is not one program")
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
            capture_span.note(pool_bytes=self.pool_bytes)
            self.graph, self.output, self.credits = graph, output, credits
            self.capture_seconds = time.perf_counter() - t0
            if self.on_capture is not None:
                self.on_capture(self)


class ProgramCache:
    """A pipeline's programs by key, captured into one memory pool, valid
    for the weight addresses they were captured against."""

    def __init__(self):
        self.programs: dict = {}
        self.pool = None
        self.fingerprint = None
        #: programs this cache has built (and, on the card, captured)
        self.built = 0
        #: launches of every capture's warm-up, by counter name: a
        #: generation's own launches are the counters' growth less these
        self.warmup_launches: dict[str, int] = {}
        #: (key, capture seconds, pool bytes) of every capture
        self.captures: list[tuple] = []

    def __len__(self):
        return len(self.programs)

    def clear(self):
        self.programs.clear()
        self.pool = None
        self.fingerprint = None

    def get(self, key, fingerprint, inputs: dict, body, device,
            kind: str = "generation") -> GenerationProgram:
        """The program of ``key``, built from ``body`` and ``inputs`` when
        missing; every program is dropped first when the weights' addresses
        (``fingerprint``) are not those the cache was built against."""
        if fingerprint != self.fingerprint:
            self.clear()
            self.fingerprint = fingerprint
        prog = self.programs.get(key)
        if prog is None:
            if device.type == "cuda" and self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            prog = self.programs[key] = GenerationProgram(body, inputs, device, self.pool,
                                                          lambda p: self._captured(key, p),
                                                          kind)
            self.built += 1
        return prog

    def _captured(self, key, prog: GenerationProgram):
        for name, n in prog.warmup_launches.items():
            self.warmup_launches[name] = self.warmup_launches.get(name, 0) + n
        self.captures.append((key, prog.capture_seconds, prog.pool_bytes))


def weights_fingerprint(modules) -> tuple:
    """The addresses of every parameter and buffer of ``modules``: a graph
    reads weights where they were when it was captured."""
    return tuple(t.data_ptr() for m in modules for t in (*m.parameters(), *m.buffers()))
