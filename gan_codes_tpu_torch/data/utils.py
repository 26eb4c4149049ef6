"""Batch preparation helpers (the port of `gan_codes_tpu/data/utils.py`).

API parity with the reference's `prepare_data` (`src/objects/utils.py:7-17`),
which sorted every batch by caption length (descending) because PyTorch's
pack_padded_sequence demanded it. The port packs with
`enforce_sorted=False` and does NOT need sorting — `sort_batch_by_length`
exists for users porting reference code and for bit-matching its
mismatch-pair ordering; the trainer doesn't call it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .loader import Batch


def sort_batch_by_length(batch: Batch) -> Batch:
    """Sort a loader Batch by caption length, descending (stable)."""
    order = np.argsort(-batch["cap_lens"], kind="stable")
    return Batch(
        images=batch["images"][order],
        captions=batch["captions"][order],
        cap_lens=batch["cap_lens"][order],
        file_names=[batch["file_names"][i] for i in order],
    )


def normalize_images_np(images_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1] on host (the trainer normalizes on
    the device; this mirrors the reference's ToTensor+Normalize)."""
    return images_u8.astype(np.float32) / 127.5 - 1.0
