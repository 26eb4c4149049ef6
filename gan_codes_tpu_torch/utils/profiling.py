"""Tracing and timing (the port of `gan_codes_tpu/utils/profiling.py`).

`trace` captures a `torch.profiler` trace around a block; `StepTimer`
times steps, with CUDA events on a card (the device's time, read after a
sync the caller already makes, so timing adds no host sync per step) and
the host clock on the CPU; `MetricsLogger` is the structured JSONL
metrics log.

`span` marks a layer of the program: the train step's phases, the
trainer's staging, the Sampler's launch, copy and assembly, serving's
queue and encode. A span records only while a torch profiler records in
its thread (`trace`, the benchmark's `--trace 1`, any
`torch.profiler.profile`); otherwise it costs one check of the
profiler's flag. Recorded, it is a `record_function` range on the
profiler's clock, beside the kernels it launched, and an entry of the
span registry: `span_summary` sums the entries by name, `idle_by_span`
names the device's idle time by the span the host was in, and
`reset_spans` empties the registry.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace of the CPU and, when a card is
    present, the device; on exit writes `<log_dir>/trace.json`
    (chrome://tracing or Perfetto) and `<log_dir>/spans.json` (the block's
    `span_summary()` and `idle_by_span`), and yields the profiler. The
    span registry is emptied on entry, so spans.json covers the block."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    reset_spans()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"spans": span_summary(),
                   "idle_by_span": idle_by_span(prof)}, f, indent=1)


def profiler_enabled() -> bool:
    """Whether a torch profiler records in this thread (torch keeps the
    flag per thread: a profiler records the thread that started it)."""
    return torch.autograd._profiler_enabled()


def _cuda_event() -> torch.cuda.Event:
    """A timing event recorded now on the current CUDA stream."""
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _elapsed_s(start: torch.cuda.Event, end: torch.cuda.Event) -> float:
    """Device seconds from `start` to `end` (waits for `end`)."""
    end.synchronize()
    return start.elapsed_time(end) / 1e3


_NOOP = contextlib.nullcontext()
_records: List["_Span"] = []     # every span entered under a profiler
_names: set = set()             # their names, kept across reset_spans
_open = threading.local()       # each thread's stack of open spans


class _Span:
    """One recorded span: name, parent (the innermost span open in its
    thread when it began), thread, and its start and end on
    `time.perf_counter_ns`; with a CUDA device also a pair of events on
    the current stream, resolved to seconds when first summed."""

    __slots__ = ("name", "parent", "thread", "start_ns", "end_ns", "_cuda",
                 "_timed", "_events", "_device_s", "_range")

    def __init__(self, name: str, device):
        self.name = name
        self._timed = device is not None
        self._cuda = self._timed and torch.device(device).type == "cuda"
        self.end_ns = None
        self._events = None
        self._device_s = None

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self._cuda:
            self._events = (_cuda_event(),)
        stack.append(self)
        _records.append(self)
        _names.add(self.name)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._cuda:
            self._events += (_cuda_event(),)
        _open.stack.pop()
        self._range.__exit__(*exc)

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def device_s(self) -> Optional[float]:
        """The device's seconds: the events' (once, then released), the
        host's where the device is the CPU, None for a host-only span."""
        if self._events is not None:
            self._device_s = _elapsed_s(*self._events)
            self._events = None
        if self._device_s is None and self._timed and not self._cuda:
            self._device_s = self.host_s
        return self._device_s


def span(name: str, device=None):
    """A context manager that marks a layer of the program as `name`.

    While no torch profiler records in this thread it does nothing (one
    check of the profiler's flag, a shared no-op context). Under one it
    enters `torch.profiler.record_function(name)` and records the span
    (`span_summary`). `device`, where given, also times the span on the
    device: a CUDA device records an event pair on the current stream, the
    CPU takes the host clock, as `StepTimer` does."""
    if not profiler_enabled():
        return _NOOP
    return _Span(name, device)


def span_summary() -> Dict[str, Dict[str, Optional[float]]]:
    """The spans ended since the last `reset_spans`, by name: `count`,
    `host_s` (summed wall time of the thread), `self_s` (`host_s` less
    the time its child spans cover) and `device_s` (None for a host-only
    span). Waits for the spans' CUDA events: call it after a sync."""
    done = [r for r in list(_records) if r.end_ns is not None]
    children: Dict[int, float] = {}
    for r in done:
        if r.parent is not None:
            children[id(r.parent)] = children.get(id(r.parent), 0.0) \
                + r.host_s
    out: Dict[str, Dict[str, Optional[float]]] = {}
    for r in done:
        s = out.setdefault(r.name, {"count": 0, "host_s": 0.0,
                                    "self_s": 0.0, "device_s": None})
        s["count"] += 1
        s["host_s"] += r.host_s
        s["self_s"] += r.host_s - children.get(id(r), 0.0)
        d = r.device_s()
        if d is not None:
            s["device_s"] = (s["device_s"] or 0.0) + d
    return out


def reset_spans() -> None:
    """Forget every recorded span."""
    _records.clear()


def idle_by_span(prof) -> Dict[str, float]:
    """The device's idle seconds in a finished `torch.profiler.profile`,
    by the innermost span (`span`) open in the host at each gap's middle,
    and "(none)" where none was. The seconds sum to the device's idle time:
    the window from the first recorded event to the last, less the union
    of the device's operations (the benchmark's `idle_pct` window)."""
    cuda = torch.autograd.DeviceType.CUDA
    busy, spans, bounds = [], [], []
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        if getattr(e, "is_user_annotation", False):
            if e.device_type != cuda and e.name in _names:
                spans.append((e.name, s, t))
            continue
        bounds += (s, t)
        if e.device_type == cuda:
            busy.append((s, t))
    if not bounds:
        return {"(none)": 0.0}
    # the profiler's clock is in microseconds
    return {name: us / 1e6 for name, us in _gaps_by_span(
        busy, spans, min(bounds), max(bounds)).items()}


def _gaps_by_span(busy, spans, lo: float, hi: float) -> Dict[str, float]:
    """The gaps of `busy` ((start, end) intervals) inside [lo, hi], summed
    by the shortest of `spans` ((name, start, end)) that holds each gap's
    middle, or "(none)"."""
    gaps, edge = [], lo
    for s, t in sorted(busy):
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    if hi > edge:
        gaps.append((edge, hi))
    out = {"(none)": 0.0}
    if spans:
        names = [n for n, _, _ in spans]
        ss = np.array([s for _, s, _ in spans])
        ts = np.array([t for _, _, t in spans])
    for s, t in gaps:
        name = "(none)"
        if spans:
            mid = (s + t) / 2
            inside = np.nonzero((ss <= mid) & (ts >= mid))[0]
            if inside.size:
                name = names[inside[np.argmin((ts - ss)[inside])]]
        out[name] = out.get(name, 0.0) + (t - s)
    return out


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
            self._start = _cuda_event()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._count += 1
        keep = self._count > self.skip_first
        if self.cuda:
            end = _cuda_event()
            if keep:
                self._events.append((self._start, end))
        elif keep:
            self.times.append(time.perf_counter() - self._t0)

    def resolve(self) -> None:
        """Turn the recorded event pairs into seconds and release them
        (waits for them; free after a device sync)."""
        self.times += [_elapsed_s(*pair) for pair in self._events]
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
