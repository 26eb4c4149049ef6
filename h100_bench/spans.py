"""The program's spans for the per-layer readers: a span's seconds a
unit, from `gan_codes_tpu_torch.utils.profiling.span_summary()` (the
spans the process recorded under the traced block's profiler).

A run without a traced block, a program without the span registry, or a
run that recorded no such span gives None, and the reader's metric is
left out of the line.
"""
from __future__ import annotations

from typing import Optional


def ms_per(run, name: str, key: str, unit: Optional[str] = None
           ) -> Optional[float]:
    """Span `name`'s `key` seconds ("host_s" or "device_s") in ms, over
    the count of span `unit` (default: its own count), in a traced run."""
    if run is None or run.trace is None:
        return None
    try:
        from gan_codes_tpu_torch.utils.profiling import span_summary
    except ImportError:
        return None
    spans = span_summary()
    seconds = spans.get(name, {}).get(key)
    count = spans.get(unit or name, {}).get("count")
    if seconds is None or not count:
        return None
    return 1e3 * seconds / count
