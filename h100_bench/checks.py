"""The numbers that decide `correct`: how far the program's outputs lie
from the plain reference's, each a single number held to a limit in the
cell's file.

Training compares norms by leaf: the gap between the program's norm of
a leaf and the reference's, over the reference's norm of that leaf or of
the module's median leaf, whichever is larger (`leaf_gaps`); a cell
holds the worst leaf's gap or the median leaf's (`drivers/train.py`).
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional

import numpy as np


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's |prog - ref| / max(ref, median ref); a leaf missing
    from `prog` reads its reference norm as the gap (1)."""
    names = list(ref if keep is None else keep)
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def loss_gap(prog: Dict[str, list], ref: Dict[str, list]) -> float:
    """max over losses and steps of |prog - ref| / max(|ref|, the median
    |ref| of that loss over the steps)."""
    worst = 0.0
    for k, r in ref.items():
        med = statistics.median(abs(x) for x in r)
        for p, x in zip(prog[k], r):
            worst = max(worst, abs(p - x) / max(abs(x), med, 1e-30))
    return worst


def image_gaps(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """Float images in [-1, 1]: the widest and the root-mean-square
    difference."""
    d = prog.astype(np.float64) - ref.astype(np.float64)
    return {"img_max_abs": float(np.abs(d).max()),
            "img_rms": float(np.sqrt(np.mean(d * d)))}


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] -> uint8 as the reference repository writes its PNGs:
    (x + 1) * 127.5, clipped, truncated."""
    return np.clip((img.astype(np.float32) + 1.0) * 127.5, 0,
                   255).astype(np.uint8)


def pixel_gaps(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """uint8 images: the share of values that differ, and the widest
    difference in levels."""
    d = np.abs(prog.astype(np.int16) - ref.astype(np.int16))
    return {"px_diff_share": float((d > 0).mean()),
            "px_max_diff": float(d.max())}
