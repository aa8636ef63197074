"""Serving facade (port of ml_stable_diffusion_tpu/serving.py).

What an app server needs around a pipeline:

- ``precompile``: build and capture every (configuration, batch size)
  program up front (pipelines/program.py), so that no user request pays for
  a capture or for the kernels' first build;
- thread-safe request execution: one generation at a time on the card, in
  the order the lock grants it (PyTorch launches asynchronously; the lock
  orders whole generations);
- ``submit``: dynamic batching.  Concurrent single-image requests whose
  program fields agree coalesce into one batched generation (per-image
  prompts and seeds ride the pipeline's multi-prompt and multi-seed
  support), which replays one captured program for all of them; requests
  that cannot merge go to a worker pool, still ordered by the lock;
- rolling latency statistics (``utils.timer.SampleTimer``).

A W8A8 pipeline with a DeepCache bucket serves as any other: its batch is
one merged program (the JAX max-throughput preset).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

from .pipelines.config import PipelineConfiguration
from .pipelines.sd import GenerationResult
from .utils.timer import SampleTimer

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """A program bucket: requests with these fields replay its program."""

    image_hw: tuple[int, int] = (512, 512)
    step_count: int = 20
    scheduler: str = "DPMSolverMultistep"
    image_count: int = 1
    guidance_scale: float = 7.5
    #: DeepCache for this bucket (PipelineConfiguration.deepcache_interval);
    #: 1 = exact
    deepcache_interval: int = 1


@dataclasses.dataclass
class _Pending:
    cfg: PipelineConfiguration
    image_hw: tuple[int, int]
    future: Future


class GenerationServer:
    """Serves ``pipeline`` (any of the port's pipelines): ``max_batch``
    requests at most merge into one generation, collected for up to
    ``batch_window_s`` after the first."""

    def __init__(self, pipeline, configs: list[ServeConfig] | None = None,
                 max_batch: int = 4, batch_window_s: float = 0.010):
        self.pipeline = pipeline
        self.configs = configs or [ServeConfig()]
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self._lock = threading.Lock()
        self.timer = SampleTimer()
        self.requests_served = 0
        self.batches_run = 0
        self._queue: list[_Pending] = []
        self._cv = threading.Condition()
        self._batcher: threading.Thread | None = None
        self._closed = False
        #: runs non-batchable submissions (img2img, ControlNet, IP-Adapter,
        #: multi-image) off the caller's thread; generate() still orders them
        self._direct_pool = ThreadPoolExecutor(max_workers=2,
                                               thread_name_prefix="sdtorch-direct")

    def precompile(self, batch_sizes: tuple[int, ...] = (1,)):
        """Build and capture every configured program with a dummy prompt,
        at each of ``batch_sizes`` (each merged batch size is a program of
        its own)."""
        for sc in self.configs:
            for b in batch_sizes:
                n = sc.image_count * b
                cfg = PipelineConfiguration(
                    prompt=["warmup"] * n if b > 1 else "warmup",
                    seed=list(range(n)) if b > 1 else 0,
                    step_count=sc.step_count, scheduler=sc.scheduler, image_count=n,
                    guidance_scale=sc.guidance_scale, disable_safety=True,
                    deepcache_interval=sc.deepcache_interval)
                logger.info("precompiling %s batch=%d", sc, b)
                with self._lock:
                    self.pipeline.generate_images(cfg, image_hw=sc.image_hw)
        logger.info("precompiled %d configurations", len(self.configs))

    def generate(self, cfg: PipelineConfiguration,
                 image_hw: tuple[int, int] = (512, 512)) -> GenerationResult:
        with self._lock:
            with self.timer:
                result = self.pipeline.generate_images(cfg, image_hw=image_hw)
            self.requests_served += 1
            return result

    # -- dynamic batching ---------------------------------------------------------

    @staticmethod
    def _batchable(cfg: PipelineConfiguration) -> bool:
        """Mergeable requests: one image, txt2img, no per-request image
        inputs.  Everything else runs alone."""
        return (cfg.image_count == 1
                and cfg.starting_image is None
                and cfg.ip_adapter_image is None
                and not cfg.controlnet_inputs
                and not isinstance(cfg.prompt, (list, tuple)))

    @staticmethod
    def _batch_key(p: _Pending):
        """Everything that selects or parametrizes the program (the
        pipelines' program key) except prompt and seed."""
        c = p.cfg
        return (p.image_hw, c.step_count, c.scheduler, c.timestep_spacing,
                c.timestep_shift, c.guidance_scale, c.rng, c.unet_batch_one,
                c.attention_implementation, c.disable_safety,
                c.original_size, c.target_size, c.crops_coords_top_left,
                c.aesthetic_score, c.negative_aesthetic_score,
                round(c.refiner_start, 4), c.deepcache_interval)

    def submit(self, cfg: PipelineConfiguration,
               image_hw: tuple[int, int] = (512, 512)) -> Future:
        """Enqueue a request; -> a Future of its GenerationResult.

        Compatible requests arriving within ``batch_window_s`` run as one
        batched generation (up to ``max_batch``).  Non-batchable requests
        run through a worker pool, so ``submit`` never blocks for a whole
        generation."""
        if self._closed:
            raise RuntimeError("server is shut down")
        if not self._batchable(cfg):
            return self._direct_pool.submit(self.generate, cfg, tuple(image_hw))
        fut: Future = Future()
        p = _Pending(cfg, tuple(image_hw), fut)
        with self._cv:
            if self._closed:
                raise RuntimeError("server is shut down")
            self._queue.append(p)
            if self._batcher is None:
                self._batcher = threading.Thread(target=self._batch_loop, daemon=True)
                self._batcher.start()
            self._cv.notify()
        return fut

    def shutdown(self, timeout: float | None = 10.0):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._batcher is not None:
            self._batcher.join(timeout)
        self._direct_pool.shutdown(wait=True)

    def _take_batch(self) -> list[_Pending]:
        """Wait for work, then collect up to max_batch key-compatible
        requests within the batching window."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait(0.1)
            if not self._queue:
                return []
            head_key = self._batch_key(self._queue[0])
            deadline = time.monotonic() + self.batch_window_s
            while (len([p for p in self._queue
                        if self._batch_key(p) == head_key]) < self.max_batch):
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    break
                self._cv.wait(remaining)
            batch, rest = [], []
            for p in self._queue:
                if self._batch_key(p) == head_key and len(batch) < self.max_batch:
                    batch.append(p)
                else:
                    rest.append(p)
            self._queue[:] = rest
            return batch

    def _batch_loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                if self._closed:
                    return
                continue
            try:
                result = self._run_batch(batch)
            except Exception as e:  # every waiting future gets the failure
                logger.exception("batched generation failed")
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)
                continue
            for i, p in enumerate(batch):
                p.future.set_result(GenerationResult(
                    images=result.images[i:i + 1], latents=result.latents[i:i + 1],
                    nsfw_flags=[result.nsfw_flags[i]],
                    seconds_per_step=result.seconds_per_step))

    def _run_batch(self, batch: list[_Pending]) -> GenerationResult:
        first = batch[0]
        if len(batch) == 1:
            return self.generate(first.cfg, first.image_hw)
        merged = dataclasses.replace(
            first.cfg,
            prompt=[p.cfg.prompt for p in batch],
            negative_prompt=[p.cfg.negative_prompt for p in batch],
            seed=[p.cfg.seed for p in batch],
            image_count=len(batch))
        with self._lock:
            with self.timer:
                result = self.pipeline.generate_images(merged, image_hw=first.image_hw)
            self.requests_served += len(batch)
            self.batches_run += 1
        logger.info("batched %d requests into one generation", len(batch))
        return result

    def stats(self) -> dict:
        t = self.timer
        return {
            "requests_served": self.requests_served,
            "batches_run": self.batches_run,
            "e2e_latency_mean_s": round(t.mean, 4) if t.samples else None,
            "e2e_latency_median_s": round(t.median, 4) if t.samples else None,
            "e2e_latency_stdev_s": round(t.stdev, 4) if t.samples else None,
        }
