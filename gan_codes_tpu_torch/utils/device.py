"""Device selection for the port's entry points.

Entry points run on CUDA by default and raise when no card is present;
they run on the CPU only when the caller passes `device="cpu"`.

The float32 product precision is the process's, as JAX's
`jax_default_matmul_precision` is: `set_matmul_precision` takes JAX's
choices. Absent or "highest", fp32 is fp32 (TF32 off for cuDNN and cuBLAS;
K2 and K3 run 3xTF32, about fp32's accuracy); "high" and "default" run one
TF32 product (10 mantissa bits, rounded to nearest) in cuDNN, cuBLAS and
K2 and K3. This module holds the setting: torch's two TF32 flags follow
it, and K2, K3 and their plain versions ask `one_pass_tf32` at each call,
never torch's flags, which a library may set behind it. On the TPU the
same choices trade fp32 multiplies for bf16 passes, and the absent flag
means one bf16 pass; here the absent flag keeps the reference's CUDA
fp32.
"""
from __future__ import annotations

from typing import Optional

import torch

MATMUL_PRECISIONS = ("default", "high", "highest")
_ONE_PASS = ("default", "high")   # one TF32 product
# the process's precision, as set by `set_matmul_precision` (None: never)
_precision: Optional[str] = None


def _set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def set_matmul_precision(precision: Optional[str]) -> Optional[str]:
    """Set the process's float32 product precision (the module docstring;
    None or "highest": TF32 off, "high" or "default": on) and in torch's
    two TF32 flags; K2 and K3 read it at each launch (`one_pass_tf32`).
    Later `serving_device` calls keep it. Returns the precision it
    replaces, for a caller that restores it."""
    global _precision
    if precision is not None and precision not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul precision {precision!r} is not one of "
                         f"{MATMUL_PRECISIONS}")
    previous, _precision = _precision, precision
    _set_tf32(precision in _ONE_PASS)
    return previous


def one_pass_tf32() -> bool:
    """Whether fp32 products run one TF32 pass (precision "high" or
    "default") in place of fp32 (K2 and K3: 3xTF32)."""
    return _precision in _ONE_PASS


def serving_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve `device`, raising when CUDA is asked for but absent.

    On CUDA it also sets torch's TF32 flags to the process's precision:
    off unless `set_matmul_precision` asked for one TF32 pass
    (`torch.backends.cudnn.allow_tf32` defaults to True, which would run
    fp32 convs in TF32 without anyone asking), so fp32 serving is fp32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        _set_tf32(_precision in _ONE_PASS)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def local_device(device: str | torch.device, local_rank: int
                 ) -> torch.device:
    """The device of one data-parallel process: `serving_device(device)`,
    and on CUDA the card `local_rank` of its node, made the current card
    (the kernels launch on the current card's stream) unless `device`
    names its card itself."""
    dev = serving_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    return dev
