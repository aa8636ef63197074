"""The port's ``compress`` command (``ml_stable_diffusion_torch/cli/compress.py``)
against the JAX package's, on the CPU, over tests/torch_cli_helpers.py's
tiny SD checkpoint: ``palettize``, ``mbp-build-recipe``, ``mbp-report`` and
``mbp-apply`` against the JAX command's outputs (keys translated by
``from_jax.unet_flax_path``); ``mbp-analyze`` against the JAX library
functions fed the port's probe batch (NHWC).  The W8A8 subcommands are in
tests/test_torch_cli_w8a8.py.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import functools
import json

import pytest
import torch

import jax
import jax.numpy as jnp

import ml_stable_diffusion_tpu.compress as jax_compress
from ml_stable_diffusion_tpu.cli import compress as jax_compress_cli

import ml_stable_diffusion_torch.compress as port_compress
from ml_stable_diffusion_torch.cli import compress
from ml_stable_diffusion_torch.convert import from_jax
from ml_stable_diffusion_torch.convert.artifacts import load_module

from torch_cli_helpers import MIN_SIZE, run
from torch_cli_helpers import ckpt, probe  # noqa: F401  (fixtures)


def _flax_key(port_key: str) -> str:
    """A port state-dict key of a UNet kernel -> the JAX MBP key."""
    module, _, leaf = port_key.rpartition(".")
    assert leaf == "weight", port_key
    return from_jax.unet_flax_path(module) + "/kernel"


@pytest.fixture(scope="module")
def small_palettes():
    """Both packages' ``palettize_tree`` and MBP sweeps over every kernel of
    64 elements or more."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_compress, "palettize_tree",
                   functools.partial(jax_compress.palettize_tree, min_size=MIN_SIZE))
        mp.setattr(port_compress, "palettize_tree",
                   functools.partial(port_compress.palettize_tree, min_size=MIN_SIZE))
        yield


def test_compress_palettize_matches_jax(ckpt, tmp_path, small_palettes):
    run(jax_compress_cli, ["palettize", "-i", str(ckpt), "-o", str(tmp_path / "j"),
                             "--nbits", "4"])
    run(compress, ["palettize", "-i", str(ckpt), "-o", str(tmp_path / "p"), "--nbits", "4",
                     "--device", "cpu"])
    got, manifest = load_module(tmp_path / "p", name="Unet", dequantize=False, device="cpu")
    want = from_jax.unet_state_dict(load_module(tmp_path / "j", name="Unet", dequantize=False,
                                                device="cpu")[0])
    assert set(got) == set(want) and len(manifest["palettized"]) > 5
    for k, v in want.items():
        if k in manifest["palettized"]:
            assert torch.equal(got[k].lut, v.lut) and torch.equal(got[k].indices, v.indices)
        else:
            assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def analysis(ckpt, tmp_path_factory, probe):
    """The port's ``mbp-analyze`` (the kernels of ``MIN_SIZE`` elements or
    more, 4 and 8 bits) beside the JAX ``benchmark_signal_integrity`` and
    ``benchmark_baselines`` on the port's probe batch."""
    from ml_stable_diffusion_tpu.compress.mixed_bit import (
        benchmark_baselines,
        benchmark_signal_integrity,
        palettizable_paths,
    )
    from ml_stable_diffusion_torch.compress.mixed_bit import palettizable_paths as port_paths

    (latents, t, ctx), model, params = probe
    path = tmp_path_factory.mktemp("mbp") / "analysis.json"
    import ml_stable_diffusion_torch.compress.mixed_bit as port_mbp

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_mbp, "palettizable_paths",
                   functools.partial(port_paths, min_size=MIN_SIZE))
        run(compress, ["mbp-analyze", "-i", str(ckpt), "-o", str(path), "--nbits", "4", "8",
                         "--size", "64x64", "--probe-prompts", "2", "--device", "cpu"])
    forward = jax.jit(lambda p: model.apply({"params": p}, jnp.asarray(latents),
                                            jnp.asarray(t), jnp.asarray(ctx)))
    paths = palettizable_paths(params, min_size=MIN_SIZE)
    want = benchmark_signal_integrity(forward, params, nbits_list=(4, 8), paths=paths)
    want["baselines"] = benchmark_baselines(forward, params, paths)
    return json.loads(path.read_text()), want


def test_compress_mbp_analyze_matches_jax_library(analysis):
    got, want = analysis
    assert len(want["single_layer"]) > 5
    assert {_flax_key(k) for k in got["single_layer"]} == set(want["single_layer"])
    for k, by_bits in got["single_layer"].items():
        for nbits, psnr in by_bits.items():
            assert abs(psnr - want["single_layer"][_flax_key(k)][nbits]) <= 0.05, (k, nbits)
    assert set(got["baselines"]) == set(want["baselines"])
    for k, v in got["baselines"].items():
        assert abs(v - want["baselines"][k]) <= 0.05, k


def test_compress_mbp_recipe_report_apply_match_jax(ckpt, tmp_path, analysis):
    """From one analysis (the JAX library's, and the same keyed by the
    port's names): the recipes, the report and the applied artifacts."""
    _, want = analysis
    names = {k: from_jax.unet_module_name(k.rpartition("/")[0]) + ".weight"
             for k in want["single_layer"]}
    assert all(_flax_key(v) == k for k, v in names.items())
    port_analysis = {"single_layer": {names[k]: v for k, v in want["single_layer"].items()},
                     "baselines": want["baselines"]}
    (tmp_path / "j.json").write_text(json.dumps(want))
    (tmp_path / "p.json").write_text(json.dumps(port_analysis))
    for pkg, module, extra in (("j", jax_compress_cli, []), ("p", compress, ["--device", "cpu"])):
        run(module, ["mbp-build-recipe", "-i", str(tmp_path / f"{pkg}.json"), "-o",
                       str(tmp_path / f"{pkg}-recipe.json"), "--psnr-threshold", "30"] + extra)
        run(module, ["mbp-report", "-i", str(tmp_path / f"{pkg}.json"), "--checkpoint",
                       str(ckpt), "-o", str(tmp_path / f"{pkg}.md"), "--output-json",
                       str(tmp_path / f"{pkg}-rows.json")] + extra)
        run(module, ["mbp-apply", "-i", str(ckpt), "--recipe",
                       str(tmp_path / f"{pkg}-recipe.json"), "-o", str(tmp_path / f"{pkg}-out")]
              + extra)
    jr = json.loads((tmp_path / "j-recipe.json").read_text())
    pr = json.loads((tmp_path / "p-recipe.json").read_text())
    assert {_flax_key(k): v for k, v in pr.items()} == jr and 4 in jr.values()
    assert (tmp_path / "p.md").read_text() == (tmp_path / "j.md").read_text()
    assert json.loads((tmp_path / "p-rows.json").read_text()) == json.loads(
        (tmp_path / "j-rows.json").read_text())
    got, manifest = load_module(tmp_path / "p-out", name="Unet", dequantize=False, device="cpu")
    want_sd = from_jax.unet_state_dict(load_module(tmp_path / "j-out", name="Unet",
                                                   dequantize=False, device="cpu")[0])
    assert set(manifest["palettized"]) == {names[k] for k, v in jr.items() if v < 16}
    for k, v in want_sd.items():
        if k in manifest["palettized"]:
            assert torch.equal(got[k].lut, v.lut) and torch.equal(got[k].indices, v.indices)
        else:
            assert torch.equal(got[k], v), k
