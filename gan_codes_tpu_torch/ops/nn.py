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

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

NEG_SLOPE = 0.2


@functools.lru_cache(maxsize=None)
def _zeros(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A cached zero vector, made outside inference mode (as
    `neg_slope`)."""
    with torch.inference_mode(False):
        return torch.zeros(n, dtype=dtype, device=device)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T + bias with a torch Linear weight [out, in].

    The product is rounded to x's dtype before the bias is added, as the
    JAX package's `dense` rounds: `F.linear(x, w, b)` would add the bias
    inside the product's one rounding, which in bf16 moves outputs by an
    ulp. The product goes through `F.linear` with a zero bias, which
    rounds it unchanged: on CUDA that keeps cuBLAS on the kernels it picks
    for a bias epilogue, faster for the generator's small fp32 matmuls than
    the ones it picks for a plain product (the served batch's GEMM time in
    chip_smoke.py's profile)."""
    w = weight.to(x.dtype)
    if bias is None:
        return F.linear(x, w)
    return F.linear(x, w, _zeros(w.shape[0], x.dtype, x.device)) \
        + bias.to(x.dtype)


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


@functools.lru_cache(maxsize=None)
def neg_slope(dtype: torch.dtype) -> torch.Tensor:
    """NEG_SLOPE rounded to `dtype`, as a 0-d CPU tensor: JAX multiplies by
    a weak-typed Python scalar, which takes the array's dtype, so its bf16
    slope is bf16(0.2) = 0.2001953125. A bf16 tensor times this 0-d bf16
    tensor is JAX's bf16 product (the exact fp32 product rounded once);
    times the Python float 0.2 it would be the fp32 product by 0.2f
    rounded, another number in about one negative input in five. In fp32
    both are 0.2f. Made outside inference mode, so that autograd may use
    it wherever it was first asked for (a bf16 Sampler, then a bf16 train
    step, in one process)."""
    with torch.inference_mode(False):
        return torch.tensor(NEG_SLOPE, dtype=dtype)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """jnp.where(x >= 0, x, x * 0.2) in x's dtype, as the JAX package's
    `leaky_relu`: the slope rounded to x's dtype (`neg_slope`), and a
    gradient of 1 at x == 0, where `F.leaky_relu`'s gives 0.2."""
    return torch.where(x >= 0, x, x * neg_slope(x.dtype))


class LeakyReLU(nn.Module):
    """`leaky_relu` as a module without parameters, in the `Sequential`s
    that keep the reference's state_dict indexes."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x)


def avg_pool2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """F.avg_pool2d(x, window) (stride = window, VALID) on NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window).permute(
        0, 2, 3, 1).contiguous()


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate(scale_factor=2) (mode 'nearest') on NHWC."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)
