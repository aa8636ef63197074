"""The port's compression slice against the JAX package, on the CPU:
palettization, mixed-bit recipes, artifacts, ``from_jax`` on palettized
leaves, ``install_palettized`` and ``load_pipeline_from_artifacts``.

Inputs are made with numpy from seeds and given to both packages.
Tolerances, each with its reason:

- ``palettize_array``: the port fits in float32 on the same data in the same
  order (quantile init, 12 Lloyd steps), and measured LUTs bitwise equal to
  JAX's; the tests hold them to rtol 1e-6 (a different float32 summation
  order in the segment sums may move a centroid by an ulp) and the indices
  to at most 1e-4 of elements differing (ties at a midpoint moved by such an
  ulp; measured 0);
- mixed-bit PSNRs: within 0.05 dB (the toy model's float32 matmuls sum in
  different orders; PSNRs are rounded to 0.01 dB by both);
- generations: latents atol 1e-3, as tests/test_torch_pipeline.py;
- artifacts and ``from_jax``: exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import flax.linen as flax_nn

from ml_stable_diffusion_tpu.compress import mixed_bit as jax_mbp
from ml_stable_diffusion_tpu.compress import palettize as jax_pal
from ml_stable_diffusion_tpu.convert import artifacts as jax_artifacts
from ml_stable_diffusion_tpu.convert.load import (
    load_pipeline_from_artifacts as jax_load_pipeline_from_artifacts,
)
from ml_stable_diffusion_tpu.convert.report import compute_psnr as jax_compute_psnr
from ml_stable_diffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
from ml_stable_diffusion_tpu.pipelines import PipelineConfiguration as JaxConfig

from ml_stable_diffusion_torch.compress import mixed_bit as mbp
from ml_stable_diffusion_torch.compress import palettize as pal
from ml_stable_diffusion_torch.convert import artifacts, native_io
from ml_stable_diffusion_torch.convert.from_jax import clip_text_state_dict, unet_state_dict
from ml_stable_diffusion_torch.convert.load import load_pipeline_from_artifacts
from ml_stable_diffusion_torch.convert.report import compute_psnr
from ml_stable_diffusion_torch.models.vae import VAEConfig
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration

from helpers import tiny_tokenizer
from torch_helpers import pipelines

LUT_RTOL = 1e-6
MAX_INDEX_MISMATCH = 1e-4
GEN = dict(prompt="a cat", negative_prompt="blurry", step_count=3,
           scheduler="DPMSolverMultistep", guidance_scale=7.5, seed=5, disable_safety=True,
           rng="numpy")
HW = (64, 64)


def _assert_same_palettization(got: pal.PalettizedTensor, want):
    """``got`` (port, torch layout) against ``want`` (JAX, same layout)."""
    assert tuple(got.shape) == tuple(want.shape) and got.nbits == want.nbits
    np.testing.assert_allclose(got.lut.numpy(), want.lut, rtol=LUT_RTOL)
    mismatch = (got.indices.numpy() != np.asarray(want.indices).ravel()).mean()
    assert mismatch <= MAX_INDEX_MISMATCH, mismatch


@pytest.mark.parametrize("nbits", [1, 2, 4, 6, 8])
def test_palettize_array_matches_jax(nbits):
    w = (np.random.RandomState(nbits).randn(300, 500) * 0.05).astype(np.float32)
    got = pal.palettize_array(torch.from_numpy(w), nbits)
    assert got.indices.dtype == torch.uint8 and got.lut.dtype == torch.float32
    _assert_same_palettization(got, jax_pal.palettize_array(w, nbits))
    assert got.compressed_bytes == jax_pal.palettize_array(w, nbits).compressed_bytes


def test_subsample_is_jax_choice():
    """``RandomState(0).choice(n, 1 << 22, replace=False)`` draws the
    positions ``permutation(n)[:1 << 22]``: the port draws them that way."""
    n = (1 << 22) + 12345
    want = np.random.RandomState(0).choice(np.arange(n), pal.FIT_MAX, replace=False)
    np.testing.assert_array_equal(pal._subsample(n).numpy(), want)


@pytest.mark.parametrize("layout", ["dense", "conv"])
def test_large_tensor_fits_in_jax_order(layout):
    """Above 1 << 22 elements the LUT is fitted on a subsample drawn in flat
    order.  The port fits in the JAX layout's order, so it fits on exactly
    the values JAX fits on (and, for the Linear weight, gets JAX's LUT and
    indices); the torch layout's order would draw other values."""
    rng = np.random.RandomState(7)
    if layout == "dense":
        w_jax = (rng.randn(2048, 2049) * 0.02).astype(np.float32)        # (K, N)
        to_torch = (1, 0)
    else:
        w_jax = (rng.randn(3, 3, 466, 1001) * 0.02).astype(np.float32)   # HWIO
        to_torch = (3, 2, 0, 1)
    w_torch = torch.from_numpy(w_jax.transpose(to_torch).copy())         # (N, K) / OIHW
    n = w_jax.size
    assert n > pal.FIT_MAX
    chosen = np.random.RandomState(0).choice(w_jax.ravel(), pal.FIT_MAX, replace=False)
    fit = pal.jax_layout(w_torch).reshape(-1)[pal._subsample(n)]
    np.testing.assert_array_equal(fit.numpy(), chosen)
    assert not np.array_equal(w_torch.reshape(-1)[pal._subsample(n)].numpy(), chosen)
    if layout == "dense":
        want = jax_pal.palettize_array(w_jax, 6)
        want_torch = jax_pal.PalettizedTensor(
            want.indices.reshape(want.shape).transpose(to_torch).ravel(), want.lut,
            tuple(w_torch.shape), 6)
        _assert_same_palettization(pal.palettize_weight(w_torch, 6), want_torch)


@pytest.fixture(scope="module")
def jax_unet_tree(pair):
    """The JAX palettization of the tiny UNet at 8 bits, min_size 128 (as
    tests/test_palettized_serving.py): (tree, stats)."""
    return jax_pal.palettize_tree(pair[0].unet_params, 8, min_size=128)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return pipelines(tmp_path_factory.mktemp("tok"), weight_seed=11)


@pytest.mark.parametrize("module", ["unet", "text_encoder"])
def test_palettize_tree_matches_jax(pair, jax_unet_tree, module):
    """The same weights palettized (JAX: leaves named ``kernel``; port:
    nn.Linear / nn.Conv2d weights) with the same statistics, LUTs and
    indices, the JAX result mapped through ``from_jax``.  The text encoder
    at min_size 1, where every norm and embedding is big enough: only the
    module type keeps them dense."""
    jax_pipe, port_pipe = pair
    if module == "unet":
        (jax_tree, jax_stats), convert, min_size, nbits = jax_unet_tree, unet_state_dict, 128, 8
    else:
        jax_tree, jax_stats = jax_pal.palettize_tree(jax_pipe.text_encoder_params, 6, min_size=1)
        convert, min_size, nbits = clip_text_state_dict, 1, 6
    tree, stats = pal.palettize_tree(getattr(port_pipe, module), nbits, min_size=min_size)
    assert stats == jax_stats and stats["palettized"] > 0
    want = convert(jax_tree)
    assert set(want) == set(tree)
    palettized = {k for k, v in tree.items() if isinstance(v, pal.PalettizedTensor)}
    assert palettized == {k for k, v in want.items() if isinstance(v, pal.PalettizedTensor)}
    for key in palettized:
        _assert_same_palettization(tree[key], want[key])
    dense = pal.dequantize_tree(tree)
    assert all(not isinstance(v, pal.PalettizedTensor) for v in dense.values())
    fake, fake_stats = pal.palettize_weights(getattr(port_pipe, module), nbits, min_size)
    assert fake_stats == stats and all(torch.equal(fake[k], dense[k]) for k in dense)


def test_from_jax_palettized_leaves(jax_unet_tree):
    """A palettized JAX kernel converts to the port layout with its indices
    permuted: dequantized, it is the transposed JAX dequantization exactly."""
    jax_tree, _ = jax_unet_tree
    got = unet_state_dict(jax_tree)
    want = unet_state_dict(jax.tree.map(np.asarray, jax_pal.dequantize_tree(jax_tree)))
    n = 0
    for key, v in got.items():
        if isinstance(v, pal.PalettizedTensor):
            assert torch.equal(v.dequantize(), want[key])
            n += 1
    assert n > 0 and any(v.ndim == 4 for v in want.values())


# -- mixed-bit ----------------------------------------------------------------------

class _JaxToy(flax_nn.Module):
    @flax_nn.compact
    def __call__(self, x):
        x = flax_nn.relu(flax_nn.Dense(64, name="lay1")(x))
        x = flax_nn.relu(flax_nn.Dense(64, name="lay2")(x))
        return flax_nn.Dense(8, name="to_out_0")(x)


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.lay1, self.lay2, self.to_out_0 = nn.Linear(32, 64), nn.Linear(64, 64), nn.Linear(64, 8)

    def forward(self, x):
        return self.to_out_0(torch.relu(self.lay2(torch.relu(self.lay1(x)))))


def test_mixed_bit_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(16, 32).astype(np.float32)
    model = _JaxToy()
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0), jnp.asarray(x))["params"])
    toy = _Toy()
    toy.load_state_dict({f"{name}.{'weight' if leaf == 'kernel' else 'bias'}":
                         torch.from_numpy(np.array(v.T if leaf == "kernel" else v))
                         for name, leaves in params.items() for leaf, v in leaves.items()})
    state = dict(toy.state_dict())

    def jax_run(p):
        return np.asarray(model.apply({"params": p}, jnp.asarray(x)))

    def run(sd):
        with torch.no_grad():
            return torch.func.functional_call(toy, sd, (torch.from_numpy(x),))

    jax_paths = jax_mbp.palettizable_paths(params, min_size=1000)
    paths = mbp.palettizable_paths(toy, min_size=1000)
    assert paths == [f"{p[0]}.weight" for p in jax_paths] == ["lay1.weight", "lay2.weight"]
    want = jax_mbp.benchmark_signal_integrity(jax_run, params, nbits_list=(2, 8),
                                              paths=jax_paths)["single_layer"]
    out_json = tmp_path / "mbp.json"
    got = mbp.benchmark_signal_integrity(run, toy, nbits_list=(2, 8), paths=paths,
                                         out_json=out_json)["single_layer"]
    assert json.loads(out_json.read_text())["single_layer"] == got
    for p in jax_paths:
        for b in ("2", "8"):
            assert abs(got[f"{p[0]}.weight"][b] - want["/".join(p)][b]) <= 0.05

    jax_recipe = jax_mbp.build_recipe(want, psnr_threshold=30.0)
    recipe = mbp.build_recipe(got, psnr_threshold=30.0)
    assert recipe == {k.replace("/kernel", ".weight"): v for k, v in jax_recipe.items()}
    assert mbp.recipe_average_bits(recipe, state) == jax_mbp.recipe_average_bits(jax_recipe,
                                                                                   params)
    jax_applied = jax_mbp.apply_recipe(params, jax_recipe)
    applied = mbp.apply_recipe(state, recipe)
    for name in ("lay1", "lay2"):
        np.testing.assert_array_equal(applied[f"{name}.weight"].numpy(),
                                      np.asarray(jax_applied[name]["kernel"]).T)
    kept = mbp.apply_recipe_palettized(state, recipe)
    assert isinstance(kept["lay1.weight"], pal.PalettizedTensor)
    assert torch.equal(kept["lay1.weight"].dequantize(), applied["lay1.weight"])
    a, b = run(applied), run(state)
    assert compute_psnr(a, b) == pytest.approx(jax_compute_psnr(a.numpy(), b.numpy()), abs=1e-9)
    rows = mbp.mbp_report_rows(got, {"r": recipe}, state)
    assert rows["total_weights"] == 32 * 64 + 64 * 64 and rows["analyzed_layers"] == 2
    assert mbp.recipe_estimated_psnr(recipe, got) == pytest.approx(
        jax_mbp.recipe_estimated_psnr(jax_recipe, want), abs=0.05)
    assert mbp.descending_psnr_order(got, 2) == [
        k.replace("/kernel", ".weight") for k in jax_mbp.descending_psnr_order(want, 2)]
    assert "| r |" in mbp.mbp_report(got, {"r": recipe}, state)
    base = mbp.benchmark_baselines(run, toy, paths=paths)
    jax_base = jax_mbp.benchmark_baselines(jax_run, params, paths=jax_paths)
    for key in ("serving_bf16", "linear_8bit"):
        assert base[key] == pytest.approx(jax_base[key], abs=0.05)


# -- artifacts --------------------------------------------------------------------

def _trees():
    """The same content as a JAX tree and as a port tree: a palettized
    kernel, a float32 bias, a bf16 tensor."""
    rng = np.random.RandomState(1)
    jax_tree = {"big": {"kernel": rng.randn(64, 64).astype(np.float32)},
                "small": {"bias": rng.randn(8).astype(np.float32)},
                "half": {"scale": np.asarray(jnp.asarray(rng.randn(3, 5), jnp.bfloat16))}}
    jax_tree, _ = jax_pal.palettize_tree(jax_tree, nbits=4, min_size=1024)
    pt = jax_tree["big"]["kernel"]
    port_tree = {
        "big": {"kernel": pal.PalettizedTensor(torch.from_numpy(pt.indices),
                                               torch.from_numpy(pt.lut), pt.shape, pt.nbits)},
        "small": {"bias": torch.from_numpy(jax_tree["small"]["bias"])},
        "half": {"scale": torch.from_numpy(
            jax_tree["half"]["scale"].astype(np.float32)).to(torch.bfloat16)},
    }
    return jax_tree, port_tree


def _as_f32(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def _assert_same_tree(got, want):
    assert set(got) == set(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, dict):
            _assert_same_tree(g, w)
        elif isinstance(w, jax_pal.PalettizedTensor):
            assert isinstance(g, pal.PalettizedTensor) and g.nbits == w.nbits
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_array_equal(g.indices.numpy(), w.indices)
            np.testing.assert_array_equal(g.lut.numpy(), w.lut)
        elif isinstance(g, jax_pal.PalettizedTensor):
            assert isinstance(w, pal.PalettizedTensor)
            np.testing.assert_array_equal(g.indices, w.indices.numpy())
            np.testing.assert_array_equal(g.lut, w.lut.numpy())
        else:
            assert str(np.asarray(g).dtype if not isinstance(g, torch.Tensor) else
                       str(g.dtype).removeprefix("torch.")) == str(
                np.asarray(w).dtype if not isinstance(w, torch.Tensor) else
                str(w.dtype).removeprefix("torch."))
            np.testing.assert_array_equal(_as_f32(g), _as_f32(w))


def test_artifact_files_are_byte_identical(tmp_path):
    jax_tree, port_tree = _trees()
    jax_artifacts.save_module(tmp_path / "jax", jax_tree, JaxVAEConfig(), name="M")
    artifacts.save_module(tmp_path / "port", port_tree, VAEConfig(), name="M")
    assert ((tmp_path / "jax" / "M.safetensors").read_bytes()
            == (tmp_path / "port" / "M.safetensors").read_bytes())
    assert (json.loads((tmp_path / "jax" / "M.json").read_text())
            == json.loads((tmp_path / "port" / "M.json").read_text()))


def _write_raw(path, header: dict, data: bytes):
    blob = json.dumps(header).encode()
    path.write_bytes(len(blob).to_bytes(8, "little") + blob + data)


@pytest.mark.parametrize("header,data,match", [
    ({"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, b"\0" * 8, "out of bounds"),
    ({"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 12]}}, b"\0" * 12, "span"),
    ({"x": {"dtype": "Q9", "shape": [1], "data_offsets": [0, 1]}}, b"\0", "unknown dtype"),
    ({"x": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}}, b"\0\0", "8-bit floats"),
    (None, b"", "too small"),
])
def test_load_file_rejects_malformed(tmp_path, header, data, match):
    """The reader checks every byte span against the file, as the JAX
    package's reader does, and refuses what the port cannot represent."""
    path = tmp_path / "bad.safetensors"
    if header is None:
        path.write_bytes(b"\x01\x02")
    else:
        _write_raw(path, header, data)
    with pytest.raises(ValueError, match=match):
        native_io.load_file(path)


def test_load_file_metadata_and_escapes(tmp_path):
    """``__metadata__`` is skipped; escaped tensor names parse."""
    path = tmp_path / "m.safetensors"
    _write_raw(path, {"__metadata__": {"note": 'quo"te\\slash'},
                      'we/ird "name"é': {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]}},
               b"abc")
    out = native_io.load_file(path)
    assert list(out) == ['we/ird "name"é'] and bytes(out['we/ird "name"é'].numpy()) == b"abc"


@pytest.mark.parametrize("dequantize", [True, False])
def test_jax_artifact_loads_in_port(tmp_path, dequantize):
    jax_tree, _ = _trees()
    jax_artifacts.save_module(tmp_path, jax_tree, JaxVAEConfig(), name="M")
    want, want_manifest = jax_artifacts.load_module(tmp_path, name="M", dequantize=dequantize)
    got, manifest = artifacts.load_module(tmp_path, name="M", dequantize=dequantize,
                                           device="cpu")
    assert manifest == want_manifest
    _assert_same_tree(got, want)


def test_port_artifact_loads_in_jax(tmp_path):
    _, port_tree = _trees()
    artifacts.save_module(tmp_path, port_tree, VAEConfig(), name="M")
    for dequantize in (True, False):
        want, want_manifest = artifacts.load_module(tmp_path, name="M", dequantize=dequantize,
                                                    device="cpu")
        got, manifest = jax_artifacts.load_module(tmp_path, name="M", dequantize=dequantize)
        assert manifest == want_manifest
        _assert_same_tree(got, want)


# -- serving ---------------------------------------------------------------------------

def test_split_and_materialize_match_jax():
    """``split_palettized_tree``/``materialize_palettized`` on a flat tree
    with '/'-joined keys: the same side, meta and dense result as JAX
    (exact: the same LUT gather, then a cast)."""
    jax_tree, port_tree = _trees()
    flat = {f"{a}/{b}": v for a, leaves in port_tree.items() for b, v in leaves.items()}
    dense, side, meta = pal.split_palettized_tree(flat)
    jax_dense, jax_side, jax_meta = jax_pal.split_palettized_tree(jax_tree)
    assert meta == jax_meta and set(side) == set(jax_side) == {"big/kernel"}
    assert set(dense) == {"small/bias", "half/scale"}
    for key, arrs in side.items():
        assert arrs["idx"].dtype == torch.uint8 and arrs["lut"].dtype == torch.float32
        np.testing.assert_array_equal(arrs["idx"].numpy(), jax_side[key]["idx"])
        np.testing.assert_array_equal(arrs["lut"].numpy(), jax_side[key]["lut"])
    got = pal.materialize_palettized(dense, side, meta, torch.bfloat16)
    want = jax_pal.materialize_palettized(jax_dense, jax_side, jax_meta, jnp.bfloat16)
    assert got["big/kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["big/kernel"].float().numpy(),
                                  np.asarray(want["big"]["kernel"], np.float32))
    assert got["small/bias"] is flat["small/bias"]


@pytest.fixture(scope="module")
def palettized_generation(pair, jax_unet_tree):
    """(the JAX palettized UNet tree, and the JAX pipeline's install-mode
    latents)."""
    jax_pipe, _ = pair
    tree, _ = jax_unet_tree
    dense_params = jax_pipe.unet_params
    jax_pipe.install_palettized("unet", tree, dtype=jnp.float32)
    try:
        latents = jax_pipe.generate_images(JaxConfig(**GEN), image_hw=HW).latents
    finally:
        jax_pipe.unet_params = dense_params
        jax_pipe._programs.clear()
    return tree, latents


@pytest.mark.parametrize("mode", ["install", "program"])
def test_install_palettized_matches_jax(pair, palettized_generation, mode):
    _, port_pipe = pair
    tree, want = palettized_generation
    dense = {k: v.clone() for k, v in port_pipe.unet.state_dict().items()}
    try:
        port_pipe.install_palettized("unet", unet_state_dict(tree), dtype=torch.float32,
                                     mode=mode)
        if mode == "program":
            assert port_pipe.palettized_side["unet"][0]
            # between generations the palettized weights hold no dense copy
            assert port_pipe.unet.get_parameter("conv_in.weight").numel() == 0
        got = port_pipe.generate_images(PipelineConfiguration(**GEN), image_hw=HW)
        np.testing.assert_allclose(got.latents, want, atol=1e-3)
        assert port_pipe.unet.get_parameter("conv_in.weight").numel() == (
            0 if mode == "program" else 16 * 4 * 3 * 3)
    finally:
        port_pipe.install_palettized("unet", dense, mode="install")
    assert not port_pipe.palettized_side


def test_install_palettized_rounds_through_dtype(pair):
    """A float32 module installed at bf16 holds bf16-rounded values in
    float32, as a Flax float32 module promotes bf16 params."""
    _, port_pipe = pair
    te = port_pipe.text_encoder
    dense = {k: v.clone() for k, v in te.state_dict().items()}
    tree, _ = pal.palettize_tree(te, 4, min_size=1)
    try:
        port_pipe.install_palettized("text_encoder", tree, dtype=torch.bfloat16)
        w = te.get_parameter("text_model.encoder.layers.0.mlp.fc1.weight")
        assert w.dtype == torch.float32
        assert torch.equal(w, tree["text_model.encoder.layers.0.mlp.fc1.weight"]
                           .dequantize().to(torch.bfloat16).float())
        with pytest.raises(ValueError, match="unknown mode"):
            port_pipe.install_palettized("text_encoder", tree, mode="bogus")
    finally:
        te.load_state_dict(dense)


def _write_jax_bundle(root, jax_pipe, unet_tree):
    tiny_tokenizer(root)
    jax_artifacts.save_module(root, jax_pipe.text_encoder_params, jax_pipe.text_encoder.config,
                              name="TextEncoder")
    jax_artifacts.save_module(root, unet_tree, jax_pipe.unet.config, name="Unet")
    jax_artifacts.save_module(root, jax_pipe.vae_decoder_params, jax_pipe.vae_decoder.config,
                              name="VAEDecoder")
    (root / "bundle.json").write_text(json.dumps({
        "family": "StableDiffusionPipeline",
        "scheduler": {"beta_schedule": "scaled_linear", "beta_start": 0.00085,
                      "beta_end": 0.012, "prediction_type": "epsilon", "steps_offset": 1,
                      "timestep_spacing": "leading"}}))


def test_load_pipeline_from_jax_bundle(pair, palettized_generation, tmp_path):
    """A JAX-written tiny SD bundle with a palettized UNet: the port's
    loader and the JAX loader generate the same latents."""
    jax_pipe, _ = pair
    tree, _ = palettized_generation
    _write_jax_bundle(tmp_path, jax_pipe, tree)
    want = jax_load_pipeline_from_artifacts(tmp_path, compute_dtype=jnp.float32)
    want = want.generate_images(JaxConfig(**GEN), image_hw=HW).latents
    pipe = load_pipeline_from_artifacts(tmp_path, compute_dtype=torch.float32, device="cpu")
    assert not pipe.palettized_side  # install mode, as the JAX loader's code
    got = pipe.generate_images(PipelineConfiguration(**GEN), image_hw=HW).latents
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("extra,match", [
    ({"controlnets": ["ControlNet-x"]}, "ControlNet"),
    ({"family": "StableDiffusion3Pipeline"}, "T5"),
])
def test_load_pipeline_unported_modules_raise(pair, palettized_generation, tmp_path, extra,
                                              match):
    jax_pipe, _ = pair
    tree, _ = palettized_generation
    _write_jax_bundle(tmp_path, jax_pipe, tree)
    bundle = json.loads((tmp_path / "bundle.json").read_text())
    bundle.update(extra)
    (tmp_path / "bundle.json").write_text(json.dumps(bundle))
    (tmp_path / "TextEncoderT5.safetensors").write_bytes(b"")  # read by the SD3 branch only
    with pytest.raises(NotImplementedError, match=match):
        load_pipeline_from_artifacts(tmp_path, compute_dtype=torch.float32, device="cpu")
