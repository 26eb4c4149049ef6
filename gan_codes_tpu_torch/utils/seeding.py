"""Seeding (reference `src/utils.py:27-35`, seed 123321).

Seeds Python's and numpy's global generators for host-side code and
returns an explicit `torch.Generator` for the device: the port draws its
random numbers from generators it passes around, never from torch's global
one."""
from __future__ import annotations

import random

import numpy as np
import torch

DEFAULT_SEED = 123321


def fix_seed(seed: int = DEFAULT_SEED,
             device: str | torch.device = "cpu") -> torch.Generator:
    """Seed python/numpy and return a torch.Generator on `device`."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def fold_seed(seed: int, epoch: int) -> int:
    """A torch seed derived from (seed, epoch) alone, the counterpart of
    JAX's `fold_in(PRNGKey(seed), epoch)`: the trainer's per-epoch eval
    noise, and the stream an imported run restarts from."""
    return int(np.random.SeedSequence([seed, epoch])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))
