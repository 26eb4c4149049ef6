"""NHWC primitives on tensors (the port of `gan_codes_tpu/ops/nn.py`).

Activations are NHWC at every public function, as in the JAX package;
weights keep PyTorch's layouts (Linear [out, in], Conv2d OIHW), the ones
the reference's state_dicts carry. Weights are cast to the activation's
dtype at use, like the JAX package's `dense`/`conv2d`, so a bfloat16 model
fed a float32 input computes in float32.

A NHWC tensor permuted to NCHW is already channels-last in memory, so the
torch conv takes it without a copy and returns a channels-last result,
which permutes back to a contiguous NHWC tensor.

The initializers draw PyTorch's default distributions (the JAX package's
`torch_linear_init`, `xavier_normal_linear_init`, `torch_conv_init`) from
an explicit `torch.Generator`, and return `{"weight", "bias"}` dicts in
torch's layouts, which `load_state_dict` takes into an `nn.Linear` or
`nn.Conv2d`. JAX's PRNG stream cannot be reproduced, so the draws are the
same distributions, not the same numbers.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

NEG_SLOPE = 0.2
Params = Dict[str, torch.Tensor]


def _uniform(generator: torch.Generator, shape, bound: float,
             dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype).uniform_(-bound, bound,
                                                    generator=generator)


def torch_linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                      bias: bool = True, dtype=torch.float32) -> Params:
    """nn.Linear's default init: weight [out, in] and bias [out], both
    U(+-sqrt(1/in_dim)) (kaiming_uniform(a=sqrt(5)) for the weight)."""
    bound = math.sqrt(1.0 / in_dim)
    p = {"weight": _uniform(generator, (out_dim, in_dim), bound, dtype)}
    if bias:
        p["bias"] = _uniform(generator, (out_dim,), bound, dtype)
    return p


def xavier_normal_linear_init(generator: torch.Generator, in_dim: int,
                              out_dim: int, dtype=torch.float32) -> Params:
    """xavier_normal_ weight [out, in] and a zero bias (the reference
    AffineBlock MLPs, `src/generator/fusion_block.py:22-31`)."""
    std = math.sqrt(2.0 / (in_dim + out_dim))
    w = torch.randn((out_dim, in_dim), generator=generator, dtype=dtype)
    return {"weight": w * std, "bias": torch.zeros(out_dim, dtype=dtype)}


def torch_conv_init(generator: torch.Generator, kh: int, kw: int,
                    in_ch: int, out_ch: int, bias: bool = True,
                    dtype=torch.float32) -> Params:
    """nn.Conv2d's default init: weight OIHW [out, in, kh, kw] and bias
    [out], both U(+-sqrt(1/fan_in)), fan_in = in_ch * kh * kw."""
    bound = math.sqrt(1.0 / (in_ch * kh * kw))
    p = {"weight": _uniform(generator, (out_ch, in_ch, kh, kw), bound, dtype)}
    if bias:
        p["bias"] = _uniform(generator, (out_ch,), bound, dtype)
    return p


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


def conv3x3_on_upsampled(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """== conv2d(upsample_nearest_2x(x), weight, bias, padding=1), up to
    the order of the tap sums; x NHWC, weight OIHW [Cout, Cin, 3, 3].

    A measured negative on the TPU, kept as a tested reference and on no
    path (the JAX package's `conv3x3_on_upsampled`: 2.25x fewer MACs, yet
    slower end to end there; `res_block_g_up` upsamples and runs the plain
    conv instead).

    Nearest upsampling duplicates pixels, so for each output sub-pixel
    phase (per axis) the three taps of the 3x3 kernel fold onto two
    original-pixel offsets: phase 0 reads offsets (-1, 0) with weights
    (w0, w1 + w2), phase 1 reads (0, +1) with (w0 + w1, w2). Both axes
    folded give one 2x2 stride-1 conv with 4 * Cout outputs (the four
    phases) over x padded by one, then a sub-pixel interleave."""
    w = weight.to(x.dtype)
    cout = w.shape[0]
    # fold the rows (kernel dim 2): r0 = phase 0, r1 = phase 1
    r0 = torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], dim=2)
    r1 = torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2)

    def fold_cols(r):
        return (torch.stack([r[..., 0], r[..., 1] + r[..., 2]], dim=-1),
                torch.stack([r[..., 0] + r[..., 1], r[..., 2]], dim=-1))

    k00, k01 = fold_cols(r0)
    k10, k11 = fold_cols(r1)
    wf = torch.cat([k00, k01, k10, k11], dim=0)        # [4*Cout, Cin, 2, 2]
    z = conv2d(F.pad(x, (0, 0, 1, 1, 1, 1)), wf)       # [B, H+1, W+1, 4*Cout]
    n, h1, w1, _ = z.shape
    h, wd = h1 - 1, w1 - 1
    phases = [z[:, py:py + h, px:px + wd, p * cout:(p + 1) * cout]
              for p, (py, px) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)])]
    y = torch.stack(phases, dim=-2).reshape(n, h, wd, 2, 2, cout)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * wd, cout)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def global_mean_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial dims: NHWC -> NC."""
    return x.mean(dim=(1, 2))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """F.normalize semantics: x / max(||x||_2, eps) along `dim`."""
    return F.normalize(x, p=2.0, dim=dim, eps=eps)


def resize_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """F.interpolate(size=(size, size)) (mode 'nearest') on NHWC: output
    pixel i reads input pixel floor(i * in / out), as PyTorch's nearest
    picks it (GALIP's G_Blocks resize 7 -> 8 and 64 -> 224)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode="nearest")
    return y.permute(0, 2, 3, 1).contiguous()
