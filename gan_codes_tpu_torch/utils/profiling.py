"""Tracing and timing (the port of `gan_codes_tpu/utils/profiling.py`).

`trace` captures a `torch.profiler` trace around a block; `StepTimer`
times steps, with CUDA events on a card (the device's time, read after a
sync the caller already makes, so timing adds no host sync per step) and
the host clock on the CPU; `MetricsLogger` is the structured JSONL
metrics log.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace of the CPU and, when a card is
    present, the device; writes `<log_dir>/trace.json` (chrome://tracing
    or Perfetto) on exit and yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Step timing with warmup discard and simple stats.

    `device` "cuda" (or a CUDA device) records a pair of CUDA events around
    each step and reads them in `resolve` (called by `total` and
    `summary`), which waits for the device: the times are the device
    stream's, from the step's start event to its end event. Otherwise the
    host clock times each step."""

    def __init__(self, skip_first: int = 2,
                 device: Optional[str | torch.device] = None):
        self.skip_first = skip_first
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.times: List[float] = []
        self._events: List[tuple] = []
        self._t0: Optional[float] = None
        self._start = None
        self._count = 0

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._count += 1
        keep = self._count > self.skip_first
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            if keep:
                self._events.append((self._start, end))
        elif keep:
            self.times.append(time.perf_counter() - self._t0)

    def resolve(self) -> None:
        """Turn the recorded event pairs into seconds and release them
        (waits for them; free after a device sync)."""
        for start, end in self._events:
            end.synchronize()
            self.times.append(start.elapsed_time(end) / 1e3)
        self._events = []

    def total(self) -> float:
        """Seconds over all kept steps."""
        self.resolve()
        return sum(self.times)

    def summary(self) -> Dict[str, float]:
        self.resolve()
        if not self.times:
            return {"steps": 0}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p95_s": ts[int(n * 0.95)],
            "max_s": ts[-1],
        }


class MetricsLogger:
    """Structured JSONL metrics log (the reference wrote ad-hoc CSVs it then
    gitignored, `metrics_log.csv`)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a")

    def log(self, step: int, **scalars) -> None:
        from .jsonio import sanitize_nonfinite

        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            # Strings pass through (row tags like kind="step"); numbers are
            # floated, with non-finite values stringified (the FID inf
            # sentinel): bare `Infinity` tokens are invalid JSON.
            rec[k] = v if isinstance(v, str) else sanitize_nonfinite(float(v))
        self._fh.write(json.dumps(rec, allow_nan=False) + "\n")
        self._fh.flush()

    def truncate_from(self, epoch: float) -> None:
        """Drop rows with rec['epoch'] >= epoch.

        A resumed run replays the epochs after the last checkpoint (with
        `checkpoint_every_epochs > 1` up to k-1 of them); their old rows
        would otherwise duplicate and break one-row-per-epoch consumers.
        The rewrite goes through a temp file + atomic rename so a crash
        mid-truncate cannot lose the whole log."""
        self._fh.close()
        kept = []
        if os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("epoch", -1) < epoch:
                        kept.append(line)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(kept)
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a")

    def close(self) -> None:
        self._fh.close()
