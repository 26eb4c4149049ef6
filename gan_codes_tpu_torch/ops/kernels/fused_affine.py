"""Kernel K1: fused double affine modulation + LeakyReLU, forward.

    out = lrelu(g2 * lrelu(g1 * x + b1) + b2)      slope 0.2
    x [B, H, W, C] NHWC; g1, b1, g2, b2 [B, C]; float32 or bfloat16.

The hot elementwise chain of every generator DFBlock
(`src/generator/residual_block.py:35-47`). It replaces the Pallas TPU kernel
`gan_codes_tpu/ops/pallas/fused_affine.py::fused_double_affine_leaky`
(forward only; the backward belongs to training and is not ported yet).

The CUDA kernel is `csrc/fused_affine.cu`: one pass over x with 16-byte
vector loads along C; it is bound by bytes (read x, write out). A CPU tensor
takes the plain PyTorch version below, `reference_double_affine_leaky`; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

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


def _lib() -> ctypes.CDLL:
    lib = _build.load()
    fn = lib.gct_fused_affine_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                           ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(x, vecs) -> None:
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


def fused_double_affine_leaky(x: torch.Tensor, g1: torch.Tensor,
                              b1: torch.Tensor, g2: torch.Tensor,
                              b2: torch.Tensor) -> torch.Tensor:
    """lrelu(g2 * lrelu(g1 * x + b1) + b2); x [B,H,W,C], params [B,C].

    CPU tensors run the plain version; CUDA tensors must be contiguous and
    run the kernel (each launch adds one to `fused_double_affine_leaky.
    launches`)."""
    vecs = (g1, b1, g2, b2)
    _check(x, vecs)
    if x.device.type == "cpu":
        return reference_double_affine_leaky(x, g1, b1, g2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in zip(("x", "g1", "b1", "g2", "b2"), (x,) + vecs):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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


fused_double_affine_leaky.launches = 0
