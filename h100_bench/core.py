"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

A traffic driver (`drivers/<name>.py`, named by the cell's mix) does the
set-up and the window and returns a `Window`; this module picks the
metrics the cell reports from `BENCHMARK.json`, runs the per-layer
readers on a traced run, decides `correct` from the traffic driver's checks and
the cell's limits (`workloads/<cell>.json`), and refuses to print a
result when the process holds JAX or the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

from . import flops, spec as spec_mod
from .trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "gan_codes_tpu")


def process_start() -> float:
    """`time.time()` at which this process started (Linux /proc; else
    now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: `gan_codes_tpu_torch` is not `gan_codes_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def thirds(times, t0: float, seconds: float) -> list:
    """Units per second in each third of a window of `seconds` from `t0`,
    from the times at which the units ended."""
    third = seconds / 3
    n = [0, 0, 0]
    for t in times:
        n[min(max(int((t - t0) / third), 0), 2)] += 1
    return [k / third for k in n]


def merge(base: dict, over: Optional[dict]) -> dict:
    """`base` with `over`'s keys, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic mix,
    the run's seed, window length and trace switch, the device, a scratch
    directory under $TMPDIR, and `start_window()`, which the driver calls
    when the first timed unit of work begins."""
    cell: str
    cfg: dict
    mix: dict
    cell_file: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    workdir: str
    t_process: float
    window_at: Optional[float] = None
    log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr,
                                                   flush=True)
    host_at: Optional[dict] = None

    def start_window(self) -> None:
        self.window_at = time.time()
        self.host_at = host_load()

    def end_window(self) -> None:
        """Logs what the host's cores did over the window (`host_load`)."""
        if self.host_at is not None:
            self.log("[host] window: " + json.dumps(
                host_share(self.host_at, host_load())))


def host_load() -> dict:
    """The machine's CPU counters (/proc/stat, where there is one) and
    this process's and its waited children's CPU time and involuntary
    context switches."""
    import resource

    out = {"t": time.monotonic()}
    for who, name in ((resource.RUSAGE_SELF, "self"),
                      (resource.RUSAGE_CHILDREN, "children")):
        r = resource.getrusage(who)
        out[name] = (r.ru_utime + r.ru_stime, r.ru_nivcsw)
    try:
        with open("/proc/stat") as f:
            out["cpu"] = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        pass
    return out


def host_share(a: dict, b: dict) -> dict:
    """Between two `host_load` readings: the cores the machine kept busy
    and lost to steal (/proc/stat), the cores this process and its
    children used, and this process's involuntary context switches."""
    dt = max(b["t"] - a["t"], 1e-9)
    out = {"self_cores": (b["self"][0] - a["self"][0]) / dt,
           "children_cores": (b["children"][0] - a["children"][0]) / dt,
           "self_involuntary_switches": b["self"][1] - a["self"][1]}
    if "cpu" in a and "cpu" in b:
        d = [y - x for x, y in zip(a["cpu"], b["cpu"])]
        total = max(sum(d[:8]), 1)
        cores = os.cpu_count() or 1
        idle = d[3] + d[4]  # idle, iowait
        out["machine_busy_cores"] = cores * (total - idle - d[7]) / total
        out["steal_cores"] = cores * d[7] / total
    return out


@dataclasses.dataclass
class Window:
    """What a driver returns: the window's end-to-end values, its counts,
    the program's own counters over it, the traced block, the device's
    peak memory, and the numbers compared with the reference."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    program: Dict[str, float]
    trace: Optional[Trace]
    memory_peak_bytes: int
    checks: Dict[str, float]
    seconds: float


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads (`metrics/<name>.py`: `read(run)`)."""
    cell: str
    cfg: dict
    mix: dict
    window: Window
    flops: object = flops

    @property
    def trace(self) -> Optional[Trace]:
        return self.window.trace

    @property
    def program(self) -> Dict[str, float]:
        return self.window.program

    @property
    def e2e(self) -> Dict[str, float]:
        return self.window.e2e


def device_info(device: str, chips: int, peak: int) -> dict:
    import torch

    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak)}


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec: Optional[spec_mod.Spec] = None,
             size: Optional[dict] = None, t_process: Optional[float] = None
             ) -> dict:
    """Run `cell` once; returns the result line as a dict. `size`
    overrides the configuration's and the mix's keys
    (`{"cfg": {...}, "mix": {...}, "cell_file": {...}}`, tests only:
    the benchmark's runs take the files as they are)."""
    spec = spec or spec_mod.Spec()
    size = size or {}
    entry = spec.cell(cell)
    cfg = merge(spec.config(entry["config"]), size.get("cfg"))
    mix = merge(spec.traffic(entry["traffic"]), size.get("mix"))
    cell_file = merge(spec.cell_file(cell), size.get("cell_file"))
    driver = importlib.import_module(f"h100_bench.drivers.{mix['driver']}")
    workdir = tempfile.mkdtemp(prefix="h100_bench_",
                               dir=os.environ.get("TMPDIR"))
    ctx = Context(cell=cell, cfg=cfg, mix=mix, cell_file=cell_file,
                  seed=seed, seconds=seconds, trace=trace, device=device,
                  workdir=workdir,
                  t_process=t_process if t_process is not None
                  else time.time())
    try:
        win = driver.run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        gc.collect()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the process holds {', '.join(found)} after the "
                         "window: no result")

    if trace:
        run = Run(cell, cfg, mix, win)
        metrics = {}
        for m in spec.per_layer(cell):
            value = spec.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(win.e2e, setup_s=ctx.window_at - ctx.t_process)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(cell)}
    dev = device_info(device, entry["chips"], win.memory_peak_bytes)
    if trace and win.trace is not None:
        dev.update(busy_s=win.trace.busy_s, window_s=win.trace.window_s)
    limits = cell_file["limits"]
    checks = {k: {"value": win.checks[k], "limit": limits[k]}
              for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {"correct": correct, "attempted": win.attempted,
           "failed": win.failed, "metrics": metrics, "device": dev}
    if trace and win.trace is not None and win.trace.breakdown:
        out["breakdown"] = win.trace.breakdown
    out["checks"] = checks
    return out


def report(result: dict) -> None:
    """The checks as the last lines on standard error, then the result as
    the last line on standard output."""
    for name, c in result["checks"].items():
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
