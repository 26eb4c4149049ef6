"""Device selection for the port's entry points.

Entry points run on CUDA by default and raise when no card is present;
they run on the CPU only when the caller passes `device="cpu"`.
"""
from __future__ import annotations

import torch


def serving_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve `device`, raising when CUDA is asked for but absent.

    On CUDA it also turns TF32 off for float32 convolutions and matmuls
    (`torch.backends.cudnn.allow_tf32` defaults to True, which would run
    fp32 convs in TF32 without anyone asking), so fp32 serving is fp32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
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
