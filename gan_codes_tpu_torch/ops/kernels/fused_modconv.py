"""Kernel K2: fused double affine modulation + LeakyReLU -> SAME 3x3 conv.

    h   = lrelu(g2 * lrelu(g1 * x + b1) + b2)
    out = conv3x3_same(h, w) + bias            (fp32 accumulation)
    x [B, H, W, Cin] NHWC; g*, b* [B, Cin]; w [3, 3, Cin, Cout] HWIO;
    bias [Cout]; float32 or bfloat16.

The whole DFBlock (`src/generator/residual_block.py:35-40`) with h kept out
of device memory. It replaces the Pallas TPU kernel
`gan_codes_tpu/ops/pallas/fused_modconv.py::fused_modconv3x3` (forward; the
JAX package's backward is the plain composition, `fused_modconv.py:192-203`,
and needs no kernel of its own).

The CUDA kernel is `csrc/fused_modconv.cu`, a direct convolution on the fp32
CUDA cores that modulates each halo tile in shared memory. A CPU tensor
takes the plain PyTorch version below, `reference_modconv3x3`; a CUDA tensor
launches the kernel or raises.

`fused_modconv3x3` is a `torch.autograd.Function`. Its backward keeps K2's
design of never writing h to memory in the forward: it saves x, recomputes
h with K1's forward, takes dh, dw and dbias from the convolution's gradient
(`torch.nn.grad`, as the JAX backward is XLA's), then dx, dg1, db1, dg2 and
db2 from K1's backward kernel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from . import fused_affine
from .fused_affine import _DTYPES, _on_cuda, reference_double_affine_leaky

COUT_TILE = 64  # output channels per CUDA block (csrc/fused_modconv.cu: CO)


def reference_modconv3x3(x: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
                         g2: torch.Tensor, b2: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in x's dtype (the math of the JAX package's
    `_xla_composition`): modulation, then a torch conv, then `+ bias`."""
    h = reference_double_affine_leaky(x, g1, b1, g2, b2)
    y = F.conv2d(h.permute(0, 3, 1, 2), w.to(h.dtype).permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1) + bias.to(h.dtype)


def _supported(w: torch.Tensor) -> bool:
    """Whether the kernel takes this DFBlock: it tiles COUT_TILE output
    channels per block, so Cout must be a multiple of 64. Any batch, H, W
    and Cin are taken (the kernel masks its edges, and its 1-D grid has no
    65535 cap). The check depends on shapes only, so CPU and CUDA tensors
    dispatch alike."""
    return w.shape[-1] % COUT_TILE == 0


def _lib() -> ctypes.CDLL:
    lib = _build.load()
    fn = lib.gct_fused_modconv3x3_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(x, g1, b1, g2, b2, w, bias) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, Cin], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    b, _, _, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be [3, 3, {cin}, Cout], "
                         f"got {tuple(w.shape)}")
    if tuple(bias.shape) != (w.shape[3],):
        raise ValueError(f"bias must be [{w.shape[3]}], "
                         f"got {tuple(bias.shape)}")
    for name, v in zip(("g1", "b1", "g2", "b2"), (g1, b1, g2, b2)):
        if tuple(v.shape) != (b, cin):
            raise ValueError(f"{name} must be [B, Cin] = {(b, cin)}, "
                             f"got {tuple(v.shape)}")
    for name, v in zip(("g1", "b1", "g2", "b2", "w", "bias"),
                       (g1, b1, g2, b2, w, bias)):
        if v.dtype != x.dtype:
            raise TypeError(f"{name} dtype {v.dtype} != x dtype {x.dtype}")
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, x on {x.device}")


def _forward(x, g1, b1, g2, b2, w, bias) -> torch.Tensor:
    """K2 forward: the plain version for a CPU tensor, else the kernel."""
    if x.device.type == "cpu":
        return reference_modconv3x3(x, g1, b1, g2, b2, w, bias)
    _on_cuda(("x", "g1", "b1", "g2", "b2", "w", "bias"),
             (x, g1, b1, g2, b2, w, bias))
    if not _supported(w):
        raise ValueError(f"fused_modconv3x3 takes Cout % {COUT_TILE} == 0, "
                         f"got w {tuple(w.shape)}")
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _lib().gct_fused_modconv3x3_fwd(
            x.data_ptr(), g1.data_ptr(), b1.data_ptr(), g2.data_ptr(),
            b2.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, h, wd, cin, cout, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_modconv3x3: CUDA error {rc} at launch "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)}, "
                           f"{x.dtype})")
    fused_modconv3x3.launches += 1
    return out


class _FusedModConv3x3(torch.autograd.Function):
    """Forward K2; backward K1 fwd (recompute h), the conv gradient, K1
    bwd."""

    @staticmethod
    def forward(ctx, x, g1, b1, g2, b2, w, bias):
        ctx.save_for_backward(x, g1, b1, g2, b2, w)
        return _forward(x, g1, b1, g2, b2, w, bias)

    @staticmethod
    def backward(ctx, dy):
        x, g1, b1, g2, b2, w = ctx.saved_tensors
        dy = dy.contiguous()
        h = fused_affine._forward(x, g1, b1, g2, b2)
        w_oihw = w.permute(3, 2, 0, 1)
        dy_nchw = dy.permute(0, 3, 1, 2)
        dh = torch.nn.grad.conv2d_input(
            (x.shape[0], x.shape[3], x.shape[1], x.shape[2]), w_oihw,
            dy_nchw, padding=1).permute(0, 2, 3, 1).contiguous()
        dw = dbias = None
        if ctx.needs_input_grad[5]:
            dw = torch.nn.grad.conv2d_weight(
                h.permute(0, 3, 1, 2), w_oihw.shape, dy_nchw,
                padding=1).permute(2, 3, 1, 0)
        if ctx.needs_input_grad[6]:
            dbias = dy.sum(dim=(0, 1, 2))
        dx, dg1, db1, dg2, db2 = fused_affine.fused_double_affine_leaky_bwd(
            x, g1, b1, g2, b2, dh)
        return dx, dg1, db1, dg2, db2, dw, dbias


def fused_modconv3x3(x: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
                     g2: torch.Tensor, b2: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """conv3x3_same(lrelu(g2 * lrelu(g1 * x + b1) + b2), w) + bias.

    Differentiable in all seven inputs. CPU tensors run the plain versions;
    CUDA tensors must be contiguous and `_supported`, and run the kernels
    (each forward launch adds one to `fused_modconv3x3.launches`; the
    backward launches K1 and K1 bwd, and counts on their counters)."""
    _check(x, g1, b1, g2, b2, w, bias)
    return _FusedModConv3x3.apply(x, g1, b1, g2, b2, w, bias)


fused_modconv3x3.launches = 0
