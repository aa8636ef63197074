"""Run one cell of the benchmark once, on the card this process finds.

    python3 sdbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, the
configuration's family, its traffic mix and every metric's reader are
found by name (``BENCHMARK.json``, ``sdbench/configs/``,
``sdbench/families/``, ``sdbench/traffic/``, ``sdbench/metrics/``).
Set-up builds the port's pipeline with weights from the seed, hands it to
``GenerationServer`` and precompiles the programs the traffic uses; the
window then sends the traffic for ``--seconds``; once it has closed and
the program is freed, the plain reference checks a sample of the images
(``sdbench/harness/check.py``).
The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
``--trace 1`` reports the per-layer metrics instead of the end-to-end
ones, with a profiler over a slice of whole requests.

Without a card, or with fewer than the cell asks for, it exits with 2 and
prints no result; with JAX or the JAX package loaded, with 3.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_stable_diffusion_tpu")


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock."""
    now = time.perf_counter()
    try:
        stat = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return now - (uptime - int(stat[19]) / ticks)
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()


def forbidden_modules() -> list[str]:
    """Top-level names of JAX and the JAX package in ``sys.modules``,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """-> (BENCHMARK.json, the cell, its configuration file, its traffic mix)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "sdbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, mix


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str, root: Path = ROOT):
    """The reader of a metric, end-to-end or per-layer:
    ``sdbench/metrics/<name>.py``, whose ``read(run)`` takes the run's
    ``RunRecord`` and returns the number, or None where it finds nothing
    to read."""
    path = root / "sdbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("sdbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _import_port(root: Path):
    """The port from the harness's own checkout, and nowhere else."""
    sys.path.insert(0, str(root))
    import ml_stable_diffusion_torch

    where = Path(ml_stable_diffusion_torch.__file__).resolve()
    if root.resolve() not in where.parents:
        raise RuntimeError(f"ml_stable_diffusion_torch comes from {where}, not this checkout")


def serve(pipe, cfg: dict, mix: dict):
    """The pipeline behind ``GenerationServer`` at its defaults, every
    program the traffic uses captured -> (the ``Recorder`` the server
    holds, the server, ``make_cfg(request)`` -> its configuration)."""
    from ml_stable_diffusion_torch.pipelines import PipelineConfiguration
    from ml_stable_diffusion_torch.serving import GenerationServer, ServeConfig

    from sdbench.harness import window

    rec = window.Recorder(pipe)
    sc = ServeConfig(image_hw=tuple(cfg["image_hw"]), step_count=cfg["step_count"],
                     scheduler=cfg["scheduler"], image_count=mix["image_count"],
                     guidance_scale=cfg["guidance_scale"])
    server = GenerationServer(rec, configs=[sc])
    # an open loop's requests merge into batches of 1 to max_batch
    server.precompile(batch_sizes=tuple(range(1, server.max_batch + 1))
                      if mix["loop"] == "open" else (1,))

    def make_cfg(req):
        return PipelineConfiguration(
            prompt=req.prompt, negative_prompt="", seed=req.seed,
            image_count=req.image_count, step_count=sc.step_count, scheduler=sc.scheduler,
            guidance_scale=sc.guidance_scale, disable_safety=True)

    return rec, server, make_cfg


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
             device: str = "cuda", loaded=None, after_build=None) -> tuple[dict, list[str]]:
    """Run the cell once -> (the result object, the check's lines).

    ``loaded``: (bench, cell, cfg, mix) in place of the files; ``after_build``:
    called with the pipeline before the server gets it (the control)."""
    import torch

    from sdbench.harness import build, check, trace as tr, window
    from sdbench.harness.record import RunRecord
    from sdbench.harness.traffic import Traffic

    bench, cell, cfg, mix = loaded or load_cell(workload, root)
    family = build.family(cfg["family"], root)
    _import_port(ROOT)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    cuda = torch.device(device).type == "cuda"
    marks = [("imports", time.perf_counter())]
    pipe = family.pipeline(cfg, seed, device)
    marks.append(("modules and weights", time.perf_counter()))
    if after_build is not None:
        after_build(pipe)
    rec, server, make_cfg = serve(pipe, cfg, mix)
    open_loop = mix["loop"] == "open"
    marks.append(("precompile", time.perf_counter()))
    tracer = None
    if trace:
        tracer = tr.Tracer()
        tracer.warm_up()
    if cuda:
        torch.cuda.synchronize()
    marks.append(("profiler and sync", time.perf_counter()))
    log("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                               in zip([("start", T_PROCESS)] + marks, marks)))

    setup_s = time.perf_counter() - T_PROCESS
    rec.recording = True
    start, done, late = window.drive(server, make_cfg, cfg["image_hw"], Traffic(mix, seed),
                                     seconds, tracer)
    rec.recording = False
    ends = [d.end for d in done if d.end is not None]
    if bad := forbidden_modules():
        raise ForbiddenModules(bad)
    peak = torch.cuda.max_memory_reserved() if cuda else 0
    run = RunRecord(cfg, mix, start, max(ends) if ends else start, done, list(rec.calls),
                    family, setup_s, peak, tracer.finish(rec.spans) if tracer else None,
                    tr.families(), sum(getattr(tracer, "cost_s", ())) if not open_loop else 0.0)
    failed = sum(1 for d in done if d.result is None)
    log(f"window: {len(done)} requests, {failed} failed, generator late by at most "
        f"{late:.6f} s, {len(run.calls)} pipeline calls, last completion "
        f"{run.window_end - start:.3f} s after the start"
        + (f"; the profiler's start and stop took {tracer.cost_s[0]:.3f} and "
           f"{tracer.cost_s[1]:.3f} s" if getattr(tracer, "cost_s", None) else ""))

    metrics = {}
    for m in metrics_of(bench, cell["name"], trace):
        value = reader(m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device,
           "kind": torch.cuda.get_device_name(0) if cuda else device,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": len(done), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        s = run.slice
        if s is None:
            raise RuntimeError("the window held no traced slice: too few requests")
        dev["busy_s"], dev["window_s"] = s.busy_s, s.window_s
        fams = s.device_time(run.families)
        gaps: dict[str, float] = {}
        for name, secs in s.idle_gaps():
            gaps[name] = gaps.get(name, 0.0) + secs
        result["breakdown"] = {
            "device_ops": sorted(fams.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10]}

    server.shutdown()
    del server, rec, pipe, run
    check.free_card()
    t0 = time.perf_counter()
    verdict = check.run(family, cfg, seed, done, device)
    limits = cfg["check"]["limits"]
    result["correct"] = check.verdict(verdict["numbers"], limits, failed)
    log(f"check: {verdict['images']} images against the reference in "
        f"{time.perf_counter() - t0:.1f} s; per image: "
        + json.dumps({k: [float(f"{x:.6g}") for x in v]
                      for k, v in verdict["per_image"].items()}))
    result["check"] = {n: {"value": v, "limit": limits.get(n)}
                       for n, v in verdict["numbers"].items()}
    result["check"]["failed_requests"] = {"value": failed, "limit": 0}
    lines = [f"check {n} {c['value']!r} limit {c['limit']!r}"
             for n, c in result["check"].items()]
    return result, lines


class ForbiddenModules(RuntimeError):
    pass


def _power_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / "build" / "sdbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    _bench, cell, _cfg, _mix = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"no result: the cell needs {cell['chips']} CUDA device(s); this host has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {_power_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    try:
        result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except ForbiddenModules as e:
        log(f"no result: loaded {e.args[0]} after the window")
        return 3
    except Exception:
        traceback.print_exc()
        log("no result: the run failed")
        return 1
    if bad := forbidden_modules():
        log(f"no result: loaded {bad} by the end of the run")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
