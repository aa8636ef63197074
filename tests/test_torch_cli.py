"""The port's command line (``ml_stable_diffusion_torch/cli``) against the JAX
package's, on the CPU, over tests/torch_cli_helpers.py's tiny SD checkpoint
(tests/test_convert_load.py's layout and configurations).  Each command of
each package runs once, in a module-scoped fixture:

- ``generate``: the port's PNGs are the port pipeline's own images bit for
  bit and within one uint8 level of the JAX command's (read with Pillow,
  ``--rng numpy``; both pipelines in float32, as tests/test_torch_pipeline.py
  holds them), with the JAX command's file names, ``--save-every`` ones too;
  ``--rng jax`` and ``--mesh`` exit with their messages; input images at the
  output size read through ``utils/png.py`` are the JAX command's
  ``pil_to_tensor`` tensors bit for bit, a mask and a transparent
  ControlNet input among them;
- ``benchmark``: the JAX report's keys, the CLIP score within 1e-3 of the
  JAX score, and the same gates;
- ``convert``: the JAX command's file names and ``bundle.json``, every
  tensor equal to the JAX bundle's after ``convert/from_jax.py``, the
  palettized LUTs and indices too; the bundle loads to ``load_pipeline``'s
  latents bit for bit; ``--check-output-correctness`` passes, and trips on
  a port whose UNet loads with two transformer blocks swapped.

``compress`` is in tests/test_torch_cli_compress.py (palettize and the
mixed-bit commands) and tests/test_torch_cli_w8a8.py.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import json

import numpy as np
import pytest
import torch

from PIL import Image

import ml_stable_diffusion_torch.convert.load as port_load
from ml_stable_diffusion_tpu.cli import benchmark as jax_benchmark
from ml_stable_diffusion_tpu.cli import convert as jax_convert
from ml_stable_diffusion_tpu.cli import generate as jax_generate
from ml_stable_diffusion_tpu.utils.image import pil_to_tensor as jax_pil_to_tensor

from ml_stable_diffusion_torch.cli import benchmark, convert, generate
from ml_stable_diffusion_torch.convert import from_jax
from ml_stable_diffusion_torch.convert.artifacts import load_module
from ml_stable_diffusion_torch.pipelines import PipelineConfiguration
from ml_stable_diffusion_torch.utils import png

from torch_cli_helpers import (
    BENCH,
    GEN,
    MIN_SIZE,
    ckpt,  # noqa: F401  (fixture)
    float32,
    run,
    write_safety_checker,
    write_text_encoder,
    write_tokenizer,
)


# -- generate --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def generated(ckpt, tmp_path_factory):
    out = {}
    for name, module, extra in (("jax", jax_generate, []),
                                ("port", generate, ["--device", "cpu"])):
        d = tmp_path_factory.mktemp(f"gen-{name}")
        with float32():
            paths = run(module, GEN + ["-i", str(ckpt), "-o", str(d), "--save-every", "1"]
                          + extra)
        out[name] = (d, paths)
    return out


def test_generate_png_is_the_pipelines_image(generated, ckpt):
    _, paths = generated["port"]
    pipe = port_load.load_pipeline(ckpt, compute_dtype=torch.float32, device="cpu")
    res = pipe.generate_images(PipelineConfiguration(
        prompt="a cat", step_count=2, scheduler="DDIM", disable_safety=True, seed=7,
        rng="numpy"), image_hw=(64, 64))
    assert len(paths) == 1 and paths[0].name == "a_cat.7.0.png"
    np.testing.assert_array_equal(png.read_png(paths[0]), res.images[0])


def test_generate_names_and_pixels_match_jax(generated):
    (jd, jpaths), (pd, ppaths) = generated["jax"], generated["port"]
    names = sorted(p.name for p in pd.iterdir())
    assert names == sorted(p.name for p in jd.iterdir())
    assert names == ["a_cat.7.0.png", "a_cat.7.0.step1.png", "a_cat.7.0.step2.png"]
    assert [p.name for p in ppaths] == [p.name for p in jpaths]
    for name in names:
        with Image.open(jd / name) as im:
            want = np.asarray(im.convert("RGB")).astype(int)
        assert np.abs(png.read_png(pd / name).astype(int) - want).max() <= 1, name


def test_generate_rng_jax_and_mesh_exit(ckpt, tmp_path):
    with pytest.raises(ValueError, match="jax.random"):
        run(generate, GEN[:-2] + ["--rng", "jax", "-i", str(ckpt), "-o", str(tmp_path),
                                    "--device", "cpu"])
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        run(generate, GEN + ["-i", str(ckpt), "-o", str(tmp_path), "--mesh", "tp=2"])
    assert generate.parser_spec().parse_args(["-i", "x"]).device == "cuda"
    assert generate.parser_spec().parse_args(["-i", "x"]).rng == "numpy"
    args = generate.parser_spec().parse_args(["-i", "x", "--attention-implementation", "xla"])
    assert generate.ATTENTION[args.attention_implementation] == "plain"


def test_generate_inputs_equal_jax_pil_to_tensor(tmp_path):
    """An RGB starting image, an RGB mask and a half-transparent RGBA
    ControlNet input, at the output size: ``read_image`` through
    ``utils/png.py`` against the JAX command's reads; a 48x32 input goes
    through Pillow's resize in both."""
    rng = np.random.RandomState(0)
    Image.fromarray(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)).save(tmp_path / "i.png")
    Image.fromarray((rng.rand(64, 64, 3) > 0.5).astype(np.uint8) * 255).save(tmp_path / "m.png")
    rgba = rng.randint(0, 256, (64, 64, 4)).astype(np.uint8)
    rgba[::2, :, 3] = 0
    Image.fromarray(rgba, "RGBA").save(tmp_path / "c.png")
    Image.fromarray(rng.randint(0, 256, (48, 32, 3)).astype(np.uint8)).save(tmp_path / "s.png")
    for name, vr, grey in (("i", (-1.0, 1.0), False), ("m", (0.0, 1.0), True),
                           ("c", (0, 1), False), ("s", (-1.0, 1.0), False)):
        with Image.open(tmp_path / f"{name}.png") as im:
            want = jax_pil_to_tensor(im.convert("L") if grey else im, size=(64, 64),
                                     value_range=vr)
        got = generate.read_image(tmp_path / f"{name}.png", (64, 64), vr, grey=grey)
        assert got.dtype == want.dtype and got.shape == want.shape == (1, 64, 64, 3)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_generate_inpainting_flags(ckpt, tmp_path):
    """``--image``, ``--mask`` and ``--strength`` reach the pipeline: the
    PNG is the pipeline's own legacy inpainting generation from the same
    tensors, bit for bit."""
    rng = np.random.RandomState(1)
    Image.fromarray(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)).save(tmp_path / "i.png")
    mask = np.zeros((64, 64), np.uint8)
    mask[:, 32:] = 255
    Image.fromarray(mask).save(tmp_path / "m.png")
    with float32():
        (path,) = run(generate, GEN + ["-i", str(ckpt), "-o", str(tmp_path / "o"),
                                         "--device", "cpu", "--image", str(tmp_path / "i.png"),
                                         "--mask", str(tmp_path / "m.png"), "--strength", "0.5"])
    pipe = port_load.load_pipeline(ckpt, compute_dtype=torch.float32, device="cpu")
    res = pipe.generate_images(PipelineConfiguration(
        prompt="a cat", step_count=2, scheduler="DDIM", disable_safety=True, seed=7,
        rng="numpy", strength=0.5,
        starting_image=generate.read_image(tmp_path / "i.png", (64, 64)),
        mask_image=generate.read_image(tmp_path / "m.png", (64, 64), (0.0, 1.0), grey=True)),
        image_hw=(64, 64))
    np.testing.assert_array_equal(png.read_png(path), res.images[0])


# -- benchmark -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """A CLIP bundle whose text encoder projects into the vision tower's
    joint space (tests/test_cli.py's)."""
    d = tmp_path_factory.mktemp("clip")
    write_tokenizer(d / "tokenizer")
    write_text_encoder(d / "text_encoder", with_projection=True, projection_dim=32)
    write_safety_checker(d / "safety_checker")
    return d


@pytest.fixture(scope="module")
def benched(ckpt, clip_dir, tmp_path_factory):
    out = {}
    for name, module, extra in (("jax", jax_benchmark, []),
                                ("port", benchmark, ["--device", "cpu"])):
        path = tmp_path_factory.mktemp(f"bench-{name}") / "benchmark.json"
        with float32():
            report = run(module, ["-i", str(ckpt), "-o", str(path), "--clip-score",
                                    "--clip-checkpoint", str(clip_dir), "--min-clip-score",
                                    "-1.0"] + BENCH + extra)
        assert json.loads(path.read_text()) == report
        out[name] = report
    return out


def test_benchmark_report_matches_jax(benched):
    jr, pr = benched["jax"], benched["port"]
    assert set(pr) == set(jr)
    for key in ("size", "scheduler", "step_count", "repeats", "min_clip_score"):
        assert pr[key] == jr[key]
    assert pr["diffusion_iters_per_s"] > 0 and pr["e2e_latency_median_s"] > 0
    assert abs(pr["clip_score"] - jr["clip_score"]) <= 1e-3


@float32()
def test_benchmark_gates_and_projection_guard(ckpt, clip_dir, tmp_path):
    base = ["-i", str(ckpt), "-o", str(tmp_path / "b.json"), "--device", "cpu"] + BENCH
    with pytest.raises(SystemExit, match="quality gate"):
        run(benchmark, base + ["--clip-score", "--clip-checkpoint", str(clip_dir),
                                 "--min-clip-score", "1.1"])
    with pytest.raises(SystemExit, match="exceeds"):
        run(benchmark, base + ["--max-latency", "0"])
    # the SD1.x-style bundled encoder has no text_projection
    with pytest.raises(ValueError, match="text_projection"):
        run(benchmark, base + ["--clip-score", "--min-clip-score", "-1.0"])


# -- convert ---------------------------------------------------------------------------

#: artifact -> the from_jax converter of its JAX tree
FROM_JAX = {"Unet": from_jax.unet_state_dict, "TextEncoder": from_jax.clip_text_state_dict,
            "VAEDecoder": from_jax.vae_decoder_state_dict,
            "VAEEncoder": from_jax.vae_encoder_state_dict,
            "SafetyChecker": from_jax.safety_checker_state_dict}


@pytest.fixture(scope="module")
def converted(ckpt, tmp_path_factory):
    jd, pd = tmp_path_factory.mktemp("conv-jax"), tmp_path_factory.mktemp("conv-port")
    common = ["-i", str(ckpt), "--convert-all", "--bundle-resources-for-generation"]
    run(jax_convert, common + ["-o", str(jd)])
    report = run(convert, common + ["-o", str(pd), "--check-output-correctness", "--device",
                                      "cpu"])
    return jd, pd, report


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def test_convert_bundle_matches_jax(converted):
    jd, pd, _ = converted
    assert _files(pd) == _files(jd)
    assert json.loads((pd / "bundle.json").read_text()) == json.loads(
        (jd / "bundle.json").read_text())
    for name, to_port in FROM_JAX.items():
        got, manifest = load_module(pd, name=name, device="cpu")
        want = to_port(load_module(jd, name=name, device="cpu")[0])
        assert set(got) == set(want), name
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), (name, k)
        assert manifest["config_class"] == json.loads((jd / f"{name}.json").read_text())[
            "config_class"]


def test_convert_gates_pass(converted):
    _, _, report = converted
    assert set(report["psnr_db"]) == {"text_encoder", "unet", "vae_decoder", "vae_encoder",
                                      "safety_checker"}
    assert min(report["psnr_db"].values()) >= 35.0


def test_convert_bundle_loads_to_load_pipelines_latents(converted, ckpt):
    _, pd, _ = converted
    cfg = PipelineConfiguration(prompt="a cat", step_count=2, scheduler="DDIM", seed=3,
                                disable_safety=True)
    want = port_load.load_pipeline(ckpt, device="cpu").generate_images(cfg, image_hw=(64, 64))
    got = port_load.load_pipeline_from_artifacts(pd, device="cpu").generate_images(
        cfg, image_hw=(64, 64))
    np.testing.assert_array_equal(got.latents, want.latents)


def test_convert_quantized_luts_match_jax(ckpt, tmp_path):
    common = ["-i", str(ckpt), "--convert-unet", "--quantize-nbits", "6",
              "--palettize-min-size", str(MIN_SIZE)]
    run(jax_convert, common + ["-o", str(tmp_path / "j")])
    run(convert, common + ["-o", str(tmp_path / "p"), "--device", "cpu"])
    got, manifest = load_module(tmp_path / "p", name="Unet", dequantize=False, device="cpu")
    want = from_jax.unet_state_dict(load_module(tmp_path / "j", name="Unet", dequantize=False,
                                                device="cpu")[0])
    assert len(manifest["palettized"]) > 5 and set(manifest["palettized"]) <= set(got)
    for k in manifest["palettized"]:
        assert got[k].nbits == want[k].nbits == 6 and got[k].shape == want[k].shape
        assert torch.equal(got[k].lut, want[k].lut), k
        assert torch.equal(got[k].indices.to(torch.uint8), want[k].indices.to(torch.uint8)), k


def test_convert_check_trips_on_swapped_blocks(ckpt, tmp_path, monkeypatch):
    real = port_load.load_unet

    def swapped(*args, **kw):
        unet = real(*args, **kw)
        a, b = "up_blocks.1.attentions.0", "up_blocks.1.attentions.1"
        sd = unet.state_dict()
        unet.load_state_dict({(b + k[len(a):] if k.startswith(a + ".") else
                               a + k[len(b):] if k.startswith(b + ".") else k): v
                              for k, v in sd.items()})
        return unet

    monkeypatch.setattr(port_load, "load_unet", swapped)
    with pytest.raises(AssertionError, match="below the 35.0 dB gate"):
        run(convert, ["-i", str(ckpt), "-o", str(tmp_path), "--convert-unet",
                        "--check-output-correctness", "--device", "cpu"])
