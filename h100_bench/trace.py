"""The device trace of a run's traced window: `torch.profiler` (CUPTI)
around a block of the window, reduced to what the per-layer readers and
the result's `device` and `breakdown` keys take.

`group()` and the reduction follow `chip_smoke.py`'s `_group` and
`_profile` (copied, so that a change to the program's tools does not move
the yardstick).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def group(name: str) -> str:
    """The kernel group of a device event's name."""
    low = name.lower()
    if "nccl" in low:
        return "NCCL collectives"
    if "fused_modconv3x3" in name:  # the conv, its weight pack, split K
        return "K2 fused_modconv3x3"
    if "fused_affine_fwd_kernel" in name:
        return "K1 fused_double_affine_leaky"
    if "fused_affine_bwd" in name:
        return "K1 bwd fused_double_affine_leaky_bwd"
    if "lstm" in low or "rnn" in low:
        return "LSTM (text encoder)"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer (foreach Adam, clip, EMA)"
    if "dgrad" in low:
        return "cuDNN conv dgrad"
    if "wgrad" in low:
        return "cuDNN conv wgrad"
    if "fprop" in low or "conv" in low:
        return "cuDNN conv fwd"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "copies"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "GEMM (affine MLPs, linear_in)"
    if "copy" in low or "memset" in low or "memcpy" in low:
        return "copies"
    return "other elementwise"


class Trace:
    """What one traced block ran on the device.

    `units`: the units of work (steps, calls) the block holds whole;
    `busy_s`: seconds in which a device operation ran (the union of their
    intervals); `window_s`: from the block's first recorded event, host or
    device, to its last; `by_group` and `by_name`: device seconds;
    `breakdown`: the result line's `breakdown` (at most 10 of each)."""

    def __init__(self, prof, units: int):
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in prof.events():
            if getattr(e, "is_user_annotation", False):
                continue
            rec = (e.name, float(e.time_range.start), float(e.time_range.end))
            (dev if e.device_type == cuda else host).append(rec)
        self.units = units
        self.events = len(dev)
        self.by_name: Dict[str, float] = {}
        self.by_group: Dict[str, float] = {}
        for name, s, t in dev:
            self.by_name[name] = self.by_name.get(name, 0.0) + (t - s) / 1e6
            self.by_group[group(name)] = (self.by_group.get(group(name), 0.0)
                                          + (t - s) / 1e6)
        ends = [t for _, _, t in dev + host]
        starts = [s for _, s, _ in dev + host]
        if not dev:
            self.busy_s, self.window_s = 0.0, 0.0
            self.breakdown = None
            return
        lo, hi = min(starts), max(ends)
        self.window_s = (hi - lo) / 1e6
        merged = []
        for _, s, t in sorted(dev, key=lambda r: r[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_s = sum(t - s for s, t in merged) / 1e6
        gaps = [(lo, merged[0][0])] + [(a[1], b[0]) for a, b in
                                       zip(merged, merged[1:])] \
            + [(merged[-1][1], hi)]
        self.breakdown = {
            "device_ops": [[n, s] for n, s in sorted(
                self.by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": _name_gaps(gaps, host)}

    def seconds(self, *groups: str) -> float:
        return sum(self.by_group.get(g, 0.0) for g in groups)

    def seconds_named(self, part: str) -> float:
        """Device seconds of the events whose name holds `part`."""
        return sum(s for n, s in self.by_name.items() if part in n)


def _name_gaps(gaps: List[Tuple[float, float]],
               host: List[Tuple[str, float, float]], longest: int = 200
               ) -> List[list]:
    """The device's idle seconds by what the host was doing: each of the
    `longest` longest gaps is named by the innermost host operation
    running at its middle ("host: no profiled op" where none was), and
    the seconds are summed by name; the 10 largest sums."""
    gaps = sorted(((t - s, s, t) for s, t in gaps if t > s),
                  reverse=True)[:longest]
    if host:
        names = [n for n, _, _ in host]
        hs = np.array([s for _, s, _ in host])
        ht = np.array([t for _, _, t in host])
    sums: Dict[str, float] = {}
    for dur, s, t in gaps:
        name = "host: no profiled op"
        if host:
            mid = (s + t) / 2
            inside = np.nonzero((hs <= mid) & (ht >= mid))[0]
            if inside.size:
                name = names[inside[np.argmin((ht - hs)[inside])]]
        sums[name] = sums.get(name, 0.0) + dur / 1e6
    return [[n, s] for n, s in sorted(sums.items(),
                                      key=lambda kv: -kv[1])[:10]]


def profiler():
    """A `torch.profiler.profile` of the host and, with a card, the
    device, not started. It records the host operations of the thread
    that starts it, and the device work they launch: start and stop it in
    the thread that launches the kernels. Its stop waits for the device.
    Reduce it (`Trace`) once the window has closed: the reduction holds
    the interpreter lock for seconds."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def warm_profiler() -> None:
    """Start and stop a profiler once around a device op, so that CUPTI's
    first start (seconds) falls in set-up and not in a traced window."""
    prof = profiler()
    prof.start()
    if torch.cuda.is_available():
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    prof.stop()
