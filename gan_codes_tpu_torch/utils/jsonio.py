"""RFC 8259-safe JSON round-tripping for metric payloads (the port's own
copy of the JAX package's `utils/jsonio.py`).

Python's `json` emits bare `Infinity` / `NaN` tokens for non-finite floats
— invalid JSON per RFC 8259, so strict consumers (jq, JavaScript's
`JSON.parse`, pandas.read_json) reject the whole document. The FID failure
sentinel is `float('inf')` (reference `src/evaluation/metrics.py:113-118`),
which lands in histories.json and metrics_log.jsonl whenever inception
weights are absent. These helpers round-trip non-finite floats through the
strings "Infinity" / "-Infinity" / "NaN" so every file stays standard JSON.
"""
from __future__ import annotations

import math
from typing import Any

_DEC = {"Infinity": float("inf"), "-Infinity": float("-inf"),
        "NaN": float("nan")}


def sanitize_nonfinite(obj: Any) -> Any:
    """Recursively replace non-finite floats with their string spellings
    (use with `json.dump(..., allow_nan=False)` to enforce the invariant)."""
    if isinstance(obj, float):
        if math.isnan(obj):
            return "NaN"
        if math.isinf(obj):
            return "Infinity" if obj > 0 else "-Infinity"
        return obj
    if isinstance(obj, dict):
        return {k: sanitize_nonfinite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_nonfinite(v) for v in obj]
    return obj


def restore_nonfinite(obj: Any) -> Any:
    """Inverse of `sanitize_nonfinite` (string spellings -> floats)."""
    if isinstance(obj, str) and obj in _DEC:
        return _DEC[obj]
    if isinstance(obj, dict):
        return {k: restore_nonfinite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [restore_nonfinite(v) for v in obj]
    return obj
