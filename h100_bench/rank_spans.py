"""A data-parallel cell's spans for the per-layer readers: rank 0 records
them in its own process and sends their summary back in
`run.program["spans"]` (`drivers/train_dp.py`), where `spans.ms_per`
reads the harness's own process.

A run without a traced block, a program without the span, or a span
with no device time gives None, and the reader's metric is left out of
the line.
"""
from __future__ import annotations

from typing import Optional


def ms_per(run, name: str, unit: Optional[str] = None) -> Optional[float]:
    """Span `name`'s device seconds on rank 0 in ms, over the count of
    span `unit` (default: its own count), in a traced run."""
    spans = run.program.get("spans") if run is not None else None
    if not spans:
        return None
    seconds = spans.get(name, {}).get("device_s")
    count = spans.get(unit or name, {}).get("count")
    if seconds is None or not count:
        return None
    return 1e3 * seconds / count
