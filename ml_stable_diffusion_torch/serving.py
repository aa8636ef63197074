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
- rolling latency statistics (``utils.timer.SampleTimer``) and each
  batched request's wait in the queue;
- spans (``utils.profiling.span``), each carrying its requests' ids:
  ``serve.idle`` while the batcher finds no work, ``serve.queued`` from a
  request's enqueue to its batch's close, ``serve.batch`` while a batch
  forms, ``serve.generate`` from before the lock to the pipeline's return.

A W8A8 pipeline with a DeepCache bucket serves as any other: its batch is
one merged program (the JAX max-throughput preset).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import statistics
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

from .pipelines.config import PipelineConfiguration
from .pipelines.sd import GenerationResult
from .utils import profiling
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
    request_id: int = 0
    #: ``time.perf_counter_ns()`` when ``submit`` queued it
    enqueued_ns: int = 0


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
        #: seconds each batched request waited in the queue, enqueue to take
        self._queue_waits: list[float] = []
        self._request_ids = itertools.count(1)
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
        return self._generate(cfg, image_hw, (next(self._request_ids),))

    def _generate(self, cfg: PipelineConfiguration, image_hw: tuple[int, int],
                  request_ids: tuple[int, ...]) -> GenerationResult:
        """One generation under the lock, serving the requests
        ``request_ids`` (more than one: a merged batch)."""
        with profiling.span("serve.generate", requests=request_ids, images=cfg.image_count):
            with self._lock:
                with self.timer:
                    result = self.pipeline.generate_images(cfg, image_hw=image_hw)
                self.requests_served += len(request_ids)
                if len(request_ids) > 1:
                    self.batches_run += 1
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
            return self._direct_pool.submit(self._generate, cfg, tuple(image_hw),
                                            (next(self._request_ids),))
        fut: Future = Future()
        p = _Pending(cfg, tuple(image_hw), fut, next(self._request_ids))
        with self._cv:
            if self._closed:
                raise RuntimeError("server is shut down")
            p.enqueued_ns = time.perf_counter_ns()
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
            if not self._queue and not self._closed:
                with profiling.span("serve.idle"):
                    while not self._queue and not self._closed:
                        self._cv.wait(0.1)
            if not self._queue:
                return []
            with profiling.span("serve.batch") as formed:
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
                taken_ns = time.perf_counter_ns()
                for p in batch:
                    self._queue_waits.append((taken_ns - p.enqueued_ns) * 1e-9)
                    profiling.add("serve.queued", p.enqueued_ns, taken_ns,
                                  request=p.request_id)
                formed.note(size=len(batch), requests=tuple(p.request_id for p in batch))
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
        ids = tuple(p.request_id for p in batch)
        if len(batch) == 1:
            return self._generate(first.cfg, first.image_hw, ids)
        merged = dataclasses.replace(
            first.cfg,
            prompt=[p.cfg.prompt for p in batch],
            negative_prompt=[p.cfg.negative_prompt for p in batch],
            seed=[p.cfg.seed for p in batch],
            image_count=len(batch))
        result = self._generate(merged, first.image_hw, ids)
        logger.info("batched %d requests into one generation", len(batch))
        return result

    def stats(self) -> dict:
        """The JAX server's fields (``e2e_latency_*``: the generation under
        the lock), then the batched requests' wait in the queue, enqueue to
        take: median and 90th percentile (linear interpolation)."""
        t = self.timer
        with self._cv:
            waits = list(self._queue_waits)
        return {
            "requests_served": self.requests_served,
            "batches_run": self.batches_run,
            "e2e_latency_mean_s": round(t.mean, 4) if t.samples else None,
            "e2e_latency_median_s": round(t.median, 4) if t.samples else None,
            "e2e_latency_stdev_s": round(t.stdev, 4) if t.samples else None,
            "queue_wait_median_s": round(statistics.median(waits), 4) if waits else None,
            "queue_wait_p90_s": round(_p90(waits), 4) if waits else None,
        }


def _p90(xs: list[float]) -> float:
    if len(xs) == 1:
        return xs[0]
    return statistics.quantiles(xs, n=10, method="inclusive")[-1]
