"""Kernel K3: the whole generator residual block in one pass.

    h1  = conv3x3_same(lrelu(g2 * lrelu(g1 * x + b1) + b2), w1) + c1
    h2  = conv3x3_same(lrelu(g4 * lrelu(g3 * h1 + b3) + b4), w2) + c2
    out = shortcut(x) + gamma * h2
    x [B, H, W, Cin] NHWC; g1, b1, g2, b2 [B, Cin]; w1 [3, 3, Cin, Cout];
    c1 [Cout]; g3, b3, g4, b4 [B, Cout]; w2 [3, 3, Cout, Cout]; c2 [Cout];
    gamma one element; ws [1, 1, Cin, Cout] and cs [Cout] (the 1x1
    shortcut), or both None (identity, Cin == Cout); float32 or bfloat16.

The reference ResidualBlockG (`src/generator/residual_block.py:9-59`) with
h1 kept out of device memory. It replaces the Pallas TPU kernel
`gan_codes_tpu/ops/pallas/fused_resblock.py::fused_resblock_g` (forward;
the JAX package's backward is the VJP of the plain composition,
`fused_resblock.py:265-274`). As in the JAX package, no model path calls
it: `ops/blocks.py::res_block_g` computes the block as two DFBlocks (K2,
or K1 and a torch conv) and a shortcut.

The CUDA kernel is `csrc/fused_resblock.cu`, direct convolutions on the
fp32 CUDA cores with the modulated h1 of each output tile (and its halo)
resident in shared memory. A CPU tensor takes the plain PyTorch version
below, `reference_resblock_g`; a CUDA tensor launches the kernel or raises.
Unlike the JAX op, which falls back to the composition for a shape its
kernel declines, a CUDA tensor of a shape K3 does not take raises.

`fused_resblock_g` is a `torch.autograd.Function`, differentiable in all
16 inputs. Its backward recomputes the block through the port's own
DFBlock ops (K2's Function where `fused_modconv._supported` holds, else K1
and a torch conv; the shortcut and gamma as torch ops) and takes their
autograd gradient, so on the card it runs K2, K1 and K1 bwd.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from . import fused_affine, fused_modconv
from .. import nn as ops_nn
from .fused_affine import _DTYPES, _on_cuda
from .fused_modconv import reference_modconv3x3

COUT_TILE = 32   # output channels per chunk at the least (csrc: CO 32 or 64)
MAX_COUT = 256   # the modulated h1 tile of all Cout channels fits in 227 KB
_NAMES = ("x", "g1", "b1", "g2", "b2", "w1", "c1", "g3", "b3", "g4", "b4",
          "w2", "c2", "gamma", "ws", "cs")


def reference_resblock_g(x, g1, b1, g2, b2, w1, c1, g3, b3, g4, b4, w2, c2,
                         gamma, ws=None, cs=None) -> torch.Tensor:
    """Plain PyTorch version, in x's dtype (the math of the JAX package's
    `_xla_composition`): two modulation + conv + bias DFBlocks, the
    shortcut, then `shortcut + gamma * h2`."""
    h1 = reference_modconv3x3(x, g1, b1, g2, b2, w1, c1)
    h2 = reference_modconv3x3(h1, g3, b3, g4, b4, w2, c2)
    shortcut = x
    if ws is not None:
        y = F.conv2d(x.permute(0, 3, 1, 2), ws.to(x.dtype).permute(3, 2, 0, 1))
        shortcut = y.permute(0, 2, 3, 1) + cs.to(x.dtype)
    return shortcut + gamma.to(x.dtype) * h2


def _supported(w1: torch.Tensor) -> bool:
    """Whether the kernel takes this block: Cout a multiple of 32 and at
    most 256 (the modulated h1 of a tile, all Cout channels in fp32, must
    fit in shared memory). Any batch, H, W and Cin are taken. The check
    depends on shapes only, so CPU and CUDA tensors dispatch alike; every
    block of the 32-256px generators at n_channels 32 is taken."""
    cout = w1.shape[-1]
    return cout % COUT_TILE == 0 and cout <= MAX_COUT


def _lib() -> ctypes.CDLL:
    lib = _build.load()
    fn = lib.gct_fused_resblock_g_fwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(x, g1, b1, g2, b2, w1, c1, g3, b3, g4, b4, w2, c2, gamma, ws,
           cs) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, Cin], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    b, _, _, cin = x.shape
    if w1.dim() != 4 or tuple(w1.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w1 must be [3, 3, {cin}, Cout], "
                         f"got {tuple(w1.shape)}")
    cout = w1.shape[3]
    want = {"g1": (b, cin), "b1": (b, cin), "g2": (b, cin), "b2": (b, cin),
            "c1": (cout,), "g3": (b, cout), "b3": (b, cout),
            "g4": (b, cout), "b4": (b, cout), "w2": (3, 3, cout, cout),
            "c2": (cout,)}
    if (ws is None) != (cs is None):
        raise ValueError("ws and cs go together: both or neither")
    if ws is None:
        if cin != cout:
            raise ValueError(f"an identity shortcut needs Cin == Cout, got "
                             f"{cin} -> {cout}; pass ws and cs")
    else:
        want.update(ws=(1, 1, cin, cout), cs=(cout,))
    args = dict(zip(_NAMES, (x, g1, b1, g2, b2, w1, c1, g3, b3, g4, b4, w2,
                             c2, gamma, ws, cs)))
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, "
                             f"got {tuple(args[name].shape)}")
    if gamma.numel() != 1:
        raise ValueError(f"gamma must hold one element, got "
                         f"{tuple(gamma.shape)}")
    if not gamma.is_floating_point():
        raise TypeError(f"gamma dtype {gamma.dtype} is not a float")
    for name, v in args.items():
        if v is None or name == "x":
            continue
        if name != "gamma" and v.dtype != x.dtype:
            raise TypeError(f"{name} dtype {v.dtype} != x dtype {x.dtype}")
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, x on {x.device}")


def _forward(*args) -> torch.Tensor:
    """K3 forward: the plain version for a CPU tensor, else the kernel.
    `args` are the 16 inputs with gamma already of shape [1] in x's
    dtype."""
    x, w1, ws = args[0], args[5], args[14]
    if x.device.type == "cpu":
        return reference_resblock_g(*args)
    present = [(n, t) for n, t in zip(_NAMES, args) if t is not None]
    _on_cuda(*zip(*present))
    if not _supported(w1):
        raise ValueError(f"fused_resblock_g takes Cout % {COUT_TILE} == 0 "
                         f"and Cout <= {MAX_COUT}, got w1 {tuple(w1.shape)}")
    b, h, w, cin = x.shape
    cout = w1.shape[3]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    ptrs = [0 if t is None else t.data_ptr() for t in args]
    with torch.cuda.device(x.device):
        rc = _lib().gct_fused_resblock_g_fwd(
            *ptrs, out.data_ptr(), b, h, w, cin, cout, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_resblock_g: CUDA error {rc} at launch "
                           f"(x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                           f"shortcut {ws is not None}, {x.dtype})")
    fused_resblock_g.launches += 1
    return out


def _df_block(x, ga, ba, gb, bb, w, c) -> torch.Tensor:
    """One DFBlock through the port's kernels, as `ops/blocks.py` runs it:
    K2 where it takes the shape, else K1 and a torch conv."""
    if fused_modconv._supported(w):
        return fused_modconv.fused_modconv3x3(x, ga, ba, gb, bb, w, c)
    h = fused_affine.fused_double_affine_leaky(x, ga, ba, gb, bb)
    return ops_nn.conv2d(h, w.permute(3, 2, 0, 1), c, padding=1)


def _composition(x, g1, b1, g2, b2, w1, c1, g3, b3, g4, b4, w2, c2, gamma,
                 ws, cs) -> torch.Tensor:
    """The block through the DFBlock kernels (the backward's recompute)."""
    h1 = _df_block(x, g1, b1, g2, b2, w1, c1)
    h2 = _df_block(h1, g3, b3, g4, b4, w2, c2)
    shortcut = x
    if ws is not None:
        shortcut = ops_nn.conv2d(x, ws.permute(3, 2, 0, 1), cs)
    return shortcut + gamma * h2


class _FusedResBlockG(torch.autograd.Function):
    """Forward K3; backward the autograd of the DFBlock-kernel composition
    (the JAX package's VJP of `_xla_composition`)."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _forward(*args)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else
                      t.detach().requires_grad_(bool(need))
                      for t, need in zip(saved, ctx.needs_input_grad)]
            out = _composition(*leaves)
            wanted = [i for i, t in enumerate(leaves)
                      if t is not None and t.requires_grad]
            grads = torch.autograd.grad(out, [leaves[i] for i in wanted],
                                        dy.contiguous(), allow_unused=True)
        result = [None] * len(saved)
        for i, g in zip(wanted, grads):
            result[i] = torch.zeros_like(saved[i]) if g is None else g
        return tuple(result)


def fused_resblock_g(x: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
                     g2: torch.Tensor, b2: torch.Tensor, w1: torch.Tensor,
                     c1: torch.Tensor, g3: torch.Tensor, b3: torch.Tensor,
                     g4: torch.Tensor, b4: torch.Tensor, w2: torch.Tensor,
                     c2: torch.Tensor, gamma: torch.Tensor,
                     ws: Optional[torch.Tensor] = None,
                     cs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """shortcut(x) + gamma * h2 of one ResidualBlockG (module docstring).

    Differentiable in all 16 inputs. CPU tensors run the plain versions;
    CUDA tensors must be contiguous and `_supported`, and run the kernels
    (each forward launch adds one to `fused_resblock_g.launches`; the
    backward launches K2, K1 and K1 bwd and counts on their counters)."""
    _check(x, g1, b1, g2, b2, w1, c1, g3, b3, g4, b4, w2, c2, gamma, ws, cs)
    return _FusedResBlockG.apply(x, g1, b1, g2, b2, w1, c1, g3, b3, g4, b4,
                                 w2, c2, gamma.reshape(1).to(x.dtype), ws,
                                 cs)


fused_resblock_g.launches = 0
