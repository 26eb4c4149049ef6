"""NHWC primitives on tensors (the port of `gan_codes_tpu/ops/nn.py`).

Activations are NHWC at every public function, as in the JAX package;
weights keep PyTorch's layouts (Linear [out, in], Conv2d OIHW), the ones
the reference's state_dicts carry. Weights are cast to the activation's
dtype at use, like the JAX package's `dense`/`conv2d`, so a bfloat16 model
fed a float32 input computes in float32.

A NHWC tensor permuted to NCHW is already channels-last in memory, so the
torch conv takes it without a copy and returns a channels-last result,
which permutes back to a contiguous NHWC tensor.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T + bias with a torch Linear weight [out, in]."""
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """NHWC x OIHW -> NHWC convolution, contiguous NHWC out.

    The bias is added after the conv, as the JAX package adds it."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), stride=stride,
                 padding=padding)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y.contiguous()


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def avg_pool2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """F.avg_pool2d(x, window) (stride = window, VALID) on NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window).permute(
        0, 2, 3, 1).contiguous()


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate(scale_factor=2) (mode 'nearest') on NHWC."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)
