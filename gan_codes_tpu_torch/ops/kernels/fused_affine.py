"""Kernel K1: fused double affine modulation + LeakyReLU, forward and
backward.

    out = lrelu(g2 * lrelu(g1 * x + b1) + b2)      slope 0.2
    x [B, H, W, C] NHWC; g1, b1, g2, b2 [B, C]; float32 or bfloat16.

The hot elementwise chain of every generator DFBlock
(`src/generator/residual_block.py:35-47`). It replaces the Pallas TPU kernels
of `gan_codes_tpu/ops/pallas/fused_affine.py`: the forward `_fwd` and the
backward `_bwd_call` of its custom VJP, which gives dx and the per-sample
dg1, db1, dg2, db2 summed over H x W in one pass.

The CUDA kernels are in `csrc/fused_affine.cu`; both are bound by bytes
(forward: read x, write out; backward: read x and dy, write dx). The
backward splits the H x W sum over blocks into fp32 partials per (sample,
pixel tile) and adds them in a second, ordered pass, so its result repeats
bit for bit. `fused_double_affine_leaky` is a `torch.autograd.Function`:
forward K1, backward K1 bwd. A CPU tensor takes the plain PyTorch versions
below (`reference_double_affine_leaky`, `reference_double_affine_leaky_bwd`);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

NEG_SLOPE = 0.2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reference_double_affine_leaky(x: torch.Tensor, g1: torch.Tensor,
                                  b1: torch.Tensor, g2: torch.Tensor,
                                  b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in x's dtype (the math of the JAX package's
    `reference_double_affine_leaky`)."""
    y1 = g1[:, None, None, :] * x + b1[:, None, None, :]
    h = torch.where(y1 >= 0, y1, y1 * NEG_SLOPE)
    y2 = g2[:, None, None, :] * h + b2[:, None, None, :]
    return torch.where(y2 >= 0, y2, y2 * NEG_SLOPE)


def reference_double_affine_leaky_bwd(
        x: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
        g2: torch.Tensor, b2: torch.Tensor, dy: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward (the math of the JAX package's
    `_bwd_kernel`): (dx, dg1, db1, dg2, db2).

    Every elementwise op is in x's dtype; the slope is 1 where y >= 0, so
    at y == 0 exactly (where `F.leaky_relu`'s backward gives 0.2). The four
    [B, C] gradients add the products over H x W in fp32 and round once to
    x's dtype (the TPU kernel adds its tile sums in x's dtype)."""
    y1 = g1[:, None, None, :] * x + b1[:, None, None, :]
    pos1 = y1 >= 0
    h = torch.where(pos1, y1, y1 * NEG_SLOPE)
    y2 = g2[:, None, None, :] * h + b2[:, None, None, :]
    dy2 = torch.where(y2 >= 0, dy, dy * NEG_SLOPE)
    dh = dy2 * g2[:, None, None, :]
    dy1 = torch.where(pos1, dh, dh * NEG_SLOPE)
    dx = dy1 * g1[:, None, None, :]

    def hw_sum(t):
        return t.float().sum(dim=(1, 2)).to(x.dtype)

    return dx, hw_sum(dy1 * x), hw_sum(dy1), hw_sum(dy2 * h), hw_sum(dy2)


def _lib() -> ctypes.CDLL:
    lib = _build.load()
    fwd = lib.gct_fused_affine_fwd
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                            ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.gct_fused_affine_bwd
    bwd.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    lib.gct_fused_affine_bwd_tile.argtypes = [ctypes.c_int]
    lib.gct_fused_affine_bwd_tile.restype = ctypes.c_int
    return lib


def _check(x, vecs, dy=None) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    want = (x.shape[0], x.shape[3])
    for name, v in zip(("g1", "b1", "g2", "b2"), vecs):
        if tuple(v.shape) != want:
            raise ValueError(f"{name} must be [B, C] = {want}, "
                             f"got {tuple(v.shape)}")
        if v.dtype != x.dtype:
            raise TypeError(f"{name} dtype {v.dtype} != x dtype {x.dtype}")
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, x on {x.device}")
    if dy is not None:
        if dy.shape != x.shape:
            raise ValueError(f"dy must be {tuple(x.shape)}, "
                             f"got {tuple(dy.shape)}")
        if dy.dtype != x.dtype:
            raise TypeError(f"dy dtype {dy.dtype} != x dtype {x.dtype}")
        if dy.device != x.device:
            raise ValueError(f"dy on {dy.device}, x on {x.device}")


def _on_cuda(names, tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"unsupported device {tensors[0].device}")
    for name, t in zip(names, tensors):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _forward(x, g1, b1, g2, b2) -> torch.Tensor:
    """K1 forward: the plain version for a CPU tensor, else the kernel."""
    if x.device.type == "cpu":
        return reference_double_affine_leaky(x, g1, b1, g2, b2)
    _on_cuda(("x", "g1", "b1", "g2", "b2"), (x, g1, b1, g2, b2))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, h, w, c = x.shape
    with torch.cuda.device(x.device):
        rc = _lib().gct_fused_affine_fwd(
            x.data_ptr(), g1.data_ptr(), b1.data_ptr(), g2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), b, h * w, c, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_double_affine_leaky: CUDA error {rc} "
                           f"at launch (x {tuple(x.shape)}, {x.dtype})")
    fused_double_affine_leaky.launches += 1
    return out


def fused_double_affine_leaky_bwd(
        x: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
        g2: torch.Tensor, b2: torch.Tensor, dy: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """(dx, dg1, db1, dg2, db2) of `fused_double_affine_leaky` for the
    output gradient dy [B, H, W, C], all in x's dtype.

    CPU tensors run the plain version; CUDA tensors must be contiguous and
    run the kernel (each launch adds one to `fused_double_affine_leaky_bwd.
    launches`)."""
    vecs = (g1, b1, g2, b2)
    _check(x, vecs, dy)
    if x.device.type == "cpu":
        return reference_double_affine_leaky_bwd(x, g1, b1, g2, b2, dy)
    _on_cuda(("x", "g1", "b1", "g2", "b2", "dy"), (x,) + vecs + (dy,))
    b, h, w, c = x.shape
    dx = torch.empty_like(x)
    if x.numel() == 0:  # no pixels: the sums over H x W are zeros
        return (dx,) + tuple(torch.zeros_like(v) for v in vecs)
    grads = [torch.empty_like(v) for v in vecs]
    lib = _lib()
    tile = lib.gct_fused_affine_bwd_tile(c)
    partial = torch.empty((b, -(-(h * w) // tile), 4, c),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.gct_fused_affine_bwd(
            x.data_ptr(), g1.data_ptr(), b1.data_ptr(), g2.data_ptr(),
            b2.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            *(t.data_ptr() for t in grads), partial.data_ptr(), b, h * w, c,
            tile, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_double_affine_leaky_bwd: CUDA error {rc} "
                           f"at launch (x {tuple(x.shape)}, {x.dtype})")
    fused_double_affine_leaky_bwd.launches += 1
    return (dx,) + tuple(grads)


fused_double_affine_leaky_bwd.launches = 0


class _FusedDoubleAffineLeaky(torch.autograd.Function):
    """Forward K1, backward K1 bwd (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, x, g1, b1, g2, b2):
        ctx.save_for_backward(x, g1, b1, g2, b2)
        return _forward(x, g1, b1, g2, b2)

    @staticmethod
    def backward(ctx, dy):
        return fused_double_affine_leaky_bwd(*ctx.saved_tensors,
                                             dy.contiguous())


def fused_double_affine_leaky(x: torch.Tensor, g1: torch.Tensor,
                              b1: torch.Tensor, g2: torch.Tensor,
                              b2: torch.Tensor) -> torch.Tensor:
    """lrelu(g2 * lrelu(g1 * x + b1) + b2); x [B,H,W,C], params [B,C].

    Differentiable in all five inputs (backward: K1 bwd). CPU tensors run
    the plain versions; CUDA tensors must be contiguous and run the kernels
    (each forward launch adds one to `fused_double_affine_leaky.launches`).
    """
    _check(x, (g1, b1, g2, b2))
    return _FusedDoubleAffineLeaky.apply(x, g1, b1, g2, b2)


fused_double_affine_leaky.launches = 0
