"""The port's W8A8 subcommands of ``compress`` (``w8a8-calibrate``,
``w8a8-analyze``) against the JAX library functions fed the port's probe
batch (NHWC), on the CPU, over tests/torch_cli_helpers.py's tiny SD
checkpoint; and a port-written scales file and a JAX-written recipe both
serve ``generate --w8a8-scales``, skipping the same layers as the JAX
pipeline.  The JAX side runs the Flax UNet eagerly under an interceptor:
most of this file's time.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import json

import pytest

import jax.numpy as jnp

import ml_stable_diffusion_tpu.convert.load as jax_load
import ml_stable_diffusion_torch.convert.load as port_load
from ml_stable_diffusion_torch.cli import compress, generate
from ml_stable_diffusion_torch.utils import png

from torch_cli_helpers import GEN, float32, run
from torch_cli_helpers import ckpt, probe  # noqa: F401  (fixtures)


@pytest.fixture(scope="module")
def calibrated(ckpt, tmp_path_factory, probe):
    """The port's ``w8a8-calibrate`` and ``w8a8-analyze`` on two probe
    prompts."""
    d = tmp_path_factory.mktemp("w8a8")
    common = ["-i", str(ckpt), "--size", "64x64", "--probe-prompts", "2", "--device", "cpu"]
    run(compress, ["w8a8-calibrate", "-o", str(d / "scales.json")] + common)
    run(compress, ["w8a8-analyze", "--scales", str(d / "scales.json"), "-o",
                     str(d / "recipe.json")] + common)
    return (json.loads((d / "scales.json").read_text()),
            json.loads((d / "recipe.json").read_text()), d)


def _jax_w8a8_run_fn(probe):
    import flax.linen as nn

    (latents, t, ctx), model, params = probe

    def run_fn(interceptor):
        args = (jnp.asarray(latents), jnp.asarray(t), jnp.asarray(ctx))
        if interceptor is None:
            return model.apply({"params": params}, *args)
        with nn.intercept_methods(interceptor):
            return model.apply({"params": params}, *args)

    return run_fn


def test_compress_w8a8_calibrate_matches_jax_library(calibrated, probe):
    from ml_stable_diffusion_tpu.compress.w8a8 import capture_activation_scales

    scales, _, _ = calibrated
    (latents, t, ctx), model, params = probe
    want = capture_activation_scales(
        lambda inp: model.apply({"params": params}, *inp),
        [(jnp.asarray(latents), jnp.asarray(t), jnp.asarray(ctx))])
    assert set(scales) == set(want) and any("attn" in k for k in scales)
    for k, v in want.items():
        assert scales[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k


def test_compress_w8a8_analyze_matches_jax_library(calibrated, probe):
    """The single-layer sweep and the recipe's rule on six layers (three
    attention projections, three others), and the first three steps of the
    cumulative pass, against the JAX library's (eager flax with an
    interceptor: a pass costs a second here)."""
    from ml_stable_diffusion_tpu.compress.w8a8 import (
        benchmark_w8a8,
        build_w8a8_recipe,
        quantizable_dense_paths,
    )

    scales, recipe, _ = calibrated
    run_fn = _jax_w8a8_run_fn(probe)
    layers = quantizable_dense_paths(scales)
    assert set(recipe["single_layer"]) == set(layers)
    attn = [k for k in layers if "attn" in k]
    subset = attn[:3] + [k for k in layers if "attn" not in k][:3]
    single = benchmark_w8a8(run_fn, scales, paths=subset, cumulative=False)
    for k, v in single.items():
        assert abs(recipe["single_layer"][k] - v) <= 0.05, k
    want = build_w8a8_recipe(recipe["single_layer"], scales)
    assert recipe["skip"] == want["skip"] and recipe["thresholds"] == want["thresholds"]
    assert recipe["act_scales"] == scales
    kept = list(recipe["cumulative"])
    assert set(kept) == set(layers) - set(want["skip"])
    cum = benchmark_w8a8(run_fn, scales, paths=kept[:3], cumulative=True)
    for k in kept[:3]:
        assert abs(recipe["cumulative"][k] - cum[k]) <= 0.05, k


@float32()
def test_w8a8_scales_from_either_package_serve_generate(ckpt, calibrated, tmp_path,
                                                        monkeypatch):
    """The port's scales file (JAX paths) and a recipe the JAX library
    wrote, its skip list in JAX paths: ``generate --w8a8 --w8a8-scales``
    quantizes every scaled layer but the skipped ones, as the JAX pipeline
    does."""
    from ml_stable_diffusion_tpu.compress.w8a8 import build_w8a8_recipe
    from ml_stable_diffusion_torch.compress.w8a8 import jax_path

    scales, _, d = calibrated
    layers = sorted(scales)
    single = {k: (10.0 if i % 3 == 0 else 60.0) for i, k in enumerate(layers)}
    jax_recipe = build_w8a8_recipe(single, scales)
    assert jax_recipe["skip"]
    (tmp_path / "jax_recipe.json").write_text(json.dumps(jax_recipe))
    pipes = []
    real = port_load.load_pipeline
    monkeypatch.setattr(port_load, "load_pipeline",
                        lambda *a, **kw: pipes.append(real(*a, **kw)) or pipes[-1])
    served = {}
    for name, path in (("scales", d / "scales.json"), ("recipe", tmp_path / "jax_recipe.json")):
        (png_path,) = run(generate, GEN + ["-i", str(ckpt), "-o", str(tmp_path / name),
                                             "--device", "cpu", "--w8a8", "--w8a8-scales",
                                             str(path)])
        assert png.read_png(png_path).shape == (64, 64, 3)
        unet = pipes[-1].unet
        served[name] = {jax_path(unet, k) for k in pipes[-1].int8_weights}
    # the JAX pipeline's choice on the same files
    jax_pipe = jax_load.load_pipeline(ckpt, compute_dtype=jnp.float32)
    jax_pipe.enable_w8a8(scales)
    assert served["scales"] == set(jax_pipe.int8_weights)
    jax_pipe = jax_load.load_pipeline(ckpt, compute_dtype=jnp.float32)
    jax_pipe.enable_w8a8(jax_recipe["act_scales"],
                         skip_patterns=("to_out_0",) + tuple(jax_recipe["skip"]))
    assert served["recipe"] == set(jax_pipe.int8_weights)
    assert served["recipe"] == served["scales"] - set(jax_recipe["skip"])
