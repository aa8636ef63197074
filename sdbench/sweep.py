"""The knee of an open-loop cell: the highest offered rate that the system
completes without a backlog that grows through the window.  Run once, on
the card, to fix the rate of an open-loop traffic mix (the benchmark's own
runs offer that fixed rate and never search).

    python3 sdbench/sweep.py --workload sd21-serve --seed 1 --seconds 51 \\
        --rates 2.2,2.6,3.0,3.4

One set-up; then for each rate a window of the cell's traffic at that rate.
Each rate prints one JSON line: the offered and completed images a second,
the latency median and 90th percentile, the median latency of the
window's first and last quarter of requests, and the requests still
waiting to start when the window closed.  A rate sustains when no more
than one full batch waits at the close.  Every rate offers the mix's one
realised schedule (``schedule_seed``) stretched or shrunk in time, so the
rates differ in load and not in how the arrivals bunch.  (The quarters'
latencies are printed, not judged: they follow that one schedule's bunching
as much as the load.)
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sdbench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from sdbench.harness import build, window
    from sdbench.harness.traffic import Traffic, percentile

    _bench, _cell, cfg, mix = bench_run.load_cell(args.workload)
    bench_run._import_port(ROOT)
    pipe = build.family(cfg["family"]).pipeline(cfg, args.seed, "cuda")
    rec, server, make_cfg = bench_run.serve(pipe, cfg, mix)

    for rate in (float(r) for r in args.rates.split(",")):
        rec.calls.clear()
        rec.recording = True
        start, done, late = window.drive(server, make_cfg, cfg["image_hw"],
                                         Traffic(dict(mix, rate_per_s=rate), args.seed),
                                         args.seconds)
        rec.recording = False
        close = start + args.seconds
        lat = [d.end - d.t0 for d in done]
        q = max(1, len(done) // 4)
        started = sorted(c.start for c in rec.calls)
        waiting = sum(1 for d in done if d.t0 < close
                      and (c := next((c for c in rec.calls if d.request.seed in c.seeds),
                                     None)) is not None and c.start > close)
        images = sum(d.request.image_count for d in done if d.result is not None)
        completed = images / (max(d.end for d in done) - start)
        offered = sum(d.request.image_count for d in done) / args.seconds
        first, last = statistics.median(lat[:q]), statistics.median(lat[-q:])
        print(json.dumps({
            "rate_per_s": rate, "requests": len(done), "offered_images_per_s": offered,
            "completed_images_per_s": completed,
            "latency_p50_s": percentile(lat, 50), "latency_p90_s": percentile(lat, 90),
            "first_quarter_p50_s": first, "last_quarter_p50_s": last,
            "waiting_at_close": waiting, "generator_late_s": late,
            "batch_mean": len(done) / max(1, len(started)),
            "sustains": waiting <= server.max_batch}), flush=True)
    server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
