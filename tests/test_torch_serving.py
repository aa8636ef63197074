"""The port's serving facade (ml_stable_diffusion_torch/serving.py) against
the JAX one (ml_stable_diffusion_tpu/serving.py), on the CPU over tiny SD
with the same weights: three concurrent submits coalesce into one batch in
both servers, and each request's latents match JAX's (atol 1e-3, the
pipeline tests' tolerance) and its own generation run alone (atol 2e-4, as
tests/test_serving.py holds the JAX server); an img2img submit runs alone;
``_batch_key`` reads JAX's fields; ``precompile`` builds one program per
(configuration, batch size); ``shutdown`` ends the batcher.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import ast
import inspect
import textwrap

import numpy as np
import pytest

from ml_stable_diffusion_tpu import serving as jax_serving
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig

from ml_stable_diffusion_torch import serving
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

from torch_helpers import pipelines, port_sd_pipeline

HW = (64, 64)
REQUESTS = [("a cat", 1), ("a dog", 2), ("a fish", 3)]


def _kw(prompt, seed, **kw):
    return {**dict(prompt=prompt, seed=seed, step_count=2, scheduler="DDIM",
                   disable_safety=True, rng="numpy"), **kw}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return pipelines(tmp_path_factory.mktemp("tok"), weight_seed=71, encoder=True)


def _served(server, config_cls):
    futs = [server.submit(config_cls(**_kw(p, s)), image_hw=HW) for p, s in REQUESTS]
    results = [f.result(timeout=600) for f in futs]
    assert server.batches_run == 1 and server.requests_served == 3
    return results


def test_batches_coalesce_and_match_jax_and_single_runs(pair):
    jax_pipe, port_pipe = pair
    jax_server = jax_serving.GenerationServer(jax_pipe, max_batch=4, batch_window_s=1.0)
    port_server = serving.GenerationServer(port_pipe, max_batch=4, batch_window_s=1.0)
    try:
        ref = _served(jax_server, JaxConfig)
        got = _served(port_server, PipelineConfiguration)
        for (prompt, seed), g, r in zip(REQUESTS, got, ref):
            assert g.latents.shape == (1, 8, 8, 4) and g.images.shape == (1, 64, 64, 3)
            np.testing.assert_allclose(g.latents, r.latents, atol=1e-3)
            alone = port_pipe.generate_images(PipelineConfiguration(**_kw(prompt, seed)),
                                              image_hw=HW)
            np.testing.assert_allclose(g.latents, alone.latents, atol=2e-4)
        # an img2img request cannot merge: it runs alone, off the caller's thread
        image = np.zeros((1, *HW, 3), np.float32)
        fut = port_server.submit(PipelineConfiguration(**_kw("x", 5, starting_image=image,
                                                            strength=0.5)), image_hw=HW)
        assert np.isfinite(fut.result(timeout=600).latents).all()
        assert port_server.batches_run == 1 and port_server.requests_served == 4
        stats = port_server.stats()
        assert stats["requests_served"] == 4 and stats["e2e_latency_median_s"] > 0
    finally:
        jax_server.shutdown()
        port_server.shutdown()


def _returned_fields(fn):
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    ret = next(n for n in ast.walk(tree) if isinstance(n, ast.Return))
    return [ast.unparse(e) for e in ret.value.elts]


def test_batch_key_reads_the_jax_fields():
    assert _returned_fields(serving.GenerationServer._batch_key) == \
        _returned_fields(jax_serving.GenerationServer._batch_key)
    kw = dict(prompt="p", seed=4, step_count=7, scheduler="Euler", timestep_spacing="karras",
              timestep_shift=2.0, guidance_scale=3.0, rng="torch", unet_batch_one=True,
              attention_implementation="plain", disable_safety=True, original_size=(512, 768),
              target_size=(640, 640), crops_coords_top_left=(4, 8), aesthetic_score=5.5,
              negative_aesthetic_score=2.0, refiner_start=0.71234, deepcache_interval=3)
    got = serving.GenerationServer._batch_key(
        serving._Pending(PipelineConfiguration(**kw), (96, 128), None))
    ref = jax_serving.GenerationServer._batch_key(
        jax_serving._Pending(JaxConfig(**kw), (96, 128), None))
    assert got == ref
    batchable = [dict(), dict(image_count=2), dict(prompt=["a"]),
                 dict(starting_image=np.zeros((1, 8, 8, 3))), dict(controlnet_inputs=[1]),
                 dict(ip_adapter_image=np.zeros((8, 8, 3)))]
    assert [serving.GenerationServer._batchable(PipelineConfiguration(**c)) for c in batchable] \
        == [jax_serving.GenerationServer._batchable(JaxConfig(**c)) for c in batchable]


def test_precompile_builds_each_program_and_shutdown_ends(tmp_path):
    pipe = port_sd_pipeline(tmp_path, seed=81, encoder=False)
    configs = [serving.ServeConfig(image_hw=HW, step_count=2, scheduler="DDIM"),
               serving.ServeConfig(image_hw=HW, step_count=3, scheduler="Euler")]
    server = serving.GenerationServer(pipe, configs)
    server.precompile(batch_sizes=(1, 2))
    main = [k for k in pipe._programs.programs if k[0] != "decode"]
    assert len(main) == len(configs) * 2
    built = pipe._programs.built
    fut = server.submit(PipelineConfiguration(**_kw("a cat", 9, step_count=3,
                                                   scheduler="Euler")), image_hw=HW)
    assert np.isfinite(fut.result(timeout=600).latents).all()
    assert pipe._programs.built == built  # the request replays a precompiled program
    server.shutdown()
    assert not server._batcher.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        server.submit(PipelineConfiguration(**_kw("a cat", 1)), image_hw=HW)
