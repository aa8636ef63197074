"""BENCHMARK.json and the files it names: every cell, configuration, family,
traffic mix and metric is found by name from a file of its own, the names
and units keep to the allowed characters, nothing under sdbench/ imports
JAX or the JAX package, the reference imports nothing of the program, and a
new cell, configuration, family, traffic mix and metric come in as new
files only."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import shutil

import pytest
from conftest import ROOT, tiny_config

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["sdbench"] and not BENCH["paths"][0].endswith("_torch")
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(len(w) <= 200 for w in BENCH["command"])
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(w["name"] for w in BENCH["workloads"])) == len(BENCH["workloads"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("sdbench/") and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["source"] in SOURCES
        e2e = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(e2e.get("workloads", m["workloads"]))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    from sdbench import run

    bench, w, cfg, mix = run.load_cell(cell)
    assert cfg["source"] == next(c["source"] for c in bench["configs"]
                                 if c["name"] == w["config"])
    assert cfg["reduced"] == [] and mix["loop"] in ("open", "closed")
    from sdbench.harness import build

    fam = build.family(cfg["family"])
    assert all(callable(getattr(fam, f)) for f in
               ("pipeline", "reference", "model_flops", "flash_calls"))
    e2e = run.metrics_of(bench, cell, False)
    assert {"setup_s"} < {m["name"] for m in e2e}
    assert run.metrics_of(bench, cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_finds_its_reader(metric):
    from sdbench import run

    spec = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"] if m["name"] == metric)
    mod = run.reader(metric)
    assert callable(mod.read) and mod.UNIT == spec["unit"]
    if "layer" in spec:
        assert (mod.LAYER, mod.MOVES) == (spec["layer"], spec["moves"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "sdbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere_and_no_program_in_the_reference(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "ml_stable_diffusion_tpu"}
    if "reference" in path.relative_to(ROOT / "sdbench").parts:
        assert "ml_stable_diffusion_torch" not in tops
        assert not [m for m in _imports(path) if m.startswith("sdbench.harness")]


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_configuration_and_metric_are_new_files_only(tmp_path):
    """A checkout with one more configuration of a new family, two traffic
    mixes (a closed loop of two-image requests, an open loop of bursts),
    two cells and a per-layer metric, added as files and entries: the
    harness runs the new cells and reports the new metric, and no file of
    sdbench/ changed."""
    from sdbench import run

    shutil.copytree(ROOT / "sdbench", tmp_path / "sdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "ml_stable_diffusion_torch", tmp_path / "ml_stable_diffusion_torch")
    before = _digest(tmp_path / "sdbench")
    cfg = dict(tiny_config("sd"), family="sd-tiny")
    (tmp_path / "sdbench/configs/tiny-new.json").write_text(json.dumps(cfg))
    (tmp_path / "sdbench/families/sd-tiny.py").write_text(
        '"""SD as the sd family builds it, under a name of its own."""\n\n'
        "from sdbench.harness import build\n\n"
        "_sd = build.family('sd')\n"
        "pipeline, reference = _sd.pipeline, _sd.reference\n"
        "model_flops, flash_calls = _sd.model_flops, _sd.flash_calls\n")
    (tmp_path / "sdbench/traffic/burst-single.json").write_text(json.dumps(
        {"loop": "open", "rate_per_s": 12.0, "schedule_seed": 5, "burst": [3, 6],
         "burst_span_s": 0.2, "image_count": 1, "prompt_tokens": [10, 20],
         "trace_slice_requests": 2}))
    (tmp_path / "sdbench/traffic/closed-double.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "image_count": 2, "prompt_tokens": [10, 20],
         "trace_slice_requests": 1}))
    (tmp_path / "sdbench/metrics/serve.calls.py").write_text(
        'LAYER = "serving (serving.py)"\nMOVES = "images_per_s"\nUNIT = "calls"\n\n'
        "def read(run):\n    return float(len(run.calls))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-new", "source": "https://example.org/tiny",
                             "file": "sdbench/configs/tiny-new.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny-double", "config": "tiny-new",
                               "traffic": "closed-double", "chips": 1, "why": "a test"})
    bench["workloads"].append({"name": "tiny-burst", "config": "tiny-new",
                               "traffic": "burst-single", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "serve.calls", "unit": "calls", "better": "higher",
                               "source": "program_span", "layer": "serving (serving.py)",
                               "moves": "images_per_s", "workloads": ["tiny-double"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = run.run_cell("tiny-double", 7, 1.0, True, root=tmp_path, device="cpu")
    assert result["correct"] and result["metrics"]["serve.calls"]["value"] >= 1
    result, _ = run.run_cell("tiny-burst", 7, 1.0, False, root=tmp_path, device="cpu")
    assert result["correct"] and result["attempted"] >= 6
    assert result["metrics"]["images_per_s"]["value"] > 0
    after = _digest(tmp_path / "sdbench")
    assert {k: v for k, v in after.items() if k in before} == before
