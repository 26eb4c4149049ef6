"""The serving cells' knee: one server, then a window at each of a list
of open-loop rates or closed-loop concurrencies, each with a fresh
client process.

    python3 h100_bench/knee.py --workload cub256-fp32-serve --seed 7 \
        --seconds 10 --rates 100,150,200,250
    python3 h100_bench/knee.py --workload cub256-fp32-serve --seed 7 \
        --seconds 10 --concurrency 16,32,48

Prints one JSON line per load: images served a second, p50 and p95
latency (ms), failures, how late the client sent, and the backlog's
trend (the median latency of the window's last quarter of requests over
its first quarter's). The knee is the highest rate whose p95 stays under
the limit with no growing backlog, or the load beyond which more
requests in flight serve no more images a second; a cell's traffic file
holds the load chosen from it. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from h100_bench import core, spec as spec_mod  # noqa: E402
from h100_bench.drivers import serve  # noqa: E402


def sweep(cell: str, seed: int, seconds: float, rates, device="cuda",
          spec=None, size=None, closed: bool = False):
    """Yields one dict of readings per rate (with `closed`, per number
    of requests in flight)."""
    spec = spec or spec_mod.Spec()
    size = size or {}
    entry = spec.cell(cell)
    cfg = core.merge(spec.config(entry["config"]), size.get("cfg"))
    mix = core.merge(spec.traffic(entry["traffic"]), size.get("mix"))
    workdir = tempfile.mkdtemp(prefix="h100_knee_",
                               dir=os.environ.get("TMPDIR"))
    ctx = core.Context(cell=cell, cfg=cfg, mix=mix,
                       cell_file=spec.cell_file(cell), seed=seed,
                       seconds=seconds, trace=False, device=device,
                       workdir=workdir, t_process=0.0)
    serving = serve.Serving(ctx)
    try:
        for rate in rates:
            res = serving.window(None if closed else rate, seconds,
                                 f"knee{rate:g}",
                                 concurrency=int(rate) if closed else None)
            lat = res["latency_s"]
            q = max(1, len(lat) // 4)
            trend = statistics.median(lat[-q:]) / statistics.median(lat[:q])
            yield {"concurrency" if closed else "rate_per_s": rate,
                   "requests": len(lat),
                   **serve.latency_stats(res, float(mix["timeout_s"])),
                   "backlog_trend": trend,
                   "dispatches": res["dispatches"],
                   "images_per_dispatch": res["metrics"].get(
                       "images_total", 0) / max(1, res["dispatches"])}
    finally:
        serving.close()
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    load = ap.add_mutually_exclusive_group(required=True)
    load.add_argument("--rates", help="comma-separated requests a second")
    load.add_argument("--concurrency",
                      help="comma-separated requests in flight")
    a = ap.parse_args(argv)
    for row in sweep(a.workload, a.seed, a.seconds,
                     [float(r) for r in (a.rates or a.concurrency)
                      .split(",")], closed=bool(a.concurrency)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
