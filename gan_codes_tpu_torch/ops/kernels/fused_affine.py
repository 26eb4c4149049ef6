"""Kernel K1: fused double affine modulation + LeakyReLU, forward and
backward.

    out = lrelu(g2 * lrelu(g1 * x + b1) + b2)      slope 0.2 rounded to x's
                                                   dtype (`nn.neg_slope`)
    x [B, H, W, C] NHWC; g1, b1, g2, b2 [B, C]; float32 or bfloat16.

The hot elementwise chain of every generator DFBlock
(`src/generator/residual_block.py:35-47`). It replaces the Pallas TPU kernels
of `gan_codes_tpu/ops/pallas/fused_affine.py`: the forward `_fwd` and the
backward `_bwd_call` of its custom VJP, which gives dx and the per-sample
dg1, db1, dg2, db2 summed over H x W in one pass.

The CUDA kernels are in `csrc/fused_affine.cu`; both are bound by bytes
(forward: read x, write out; backward: read x and dy, write dx, and z, the
forward's output, where the caller asks for it). Both stream one layout,
`_plan`'s: each thread owns one 16-byte channel vector of one sample and
walks its pixels; the grid is (sample x channel chunk) x pixel split. The
backward is one launch: the blocks of one (sample, chunk) form a thread-
block cluster, and the cluster's rank 0 adds their sums over H x W (fp64 in
shared memory) in rank order through distributed shared memory, so the
result repeats bit for bit with no scratch tensor.
`fused_double_affine_leaky` is a `torch.autograd.Function`: forward K1,
backward K1 bwd. A CPU tensor takes the plain PyTorch versions below
(`reference_double_affine_leaky`, `reference_double_affine_leaky_bwd`); a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import _build
from ..nn import neg_slope
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# threads of a block (csrc: kMaxThreads), two blocks an SM: bf16's fp32
# sums of 8 channels a thread need twice the registers of fp32's 4
MAX_THREADS = {torch.float32: 512, torch.bfloat16: 256}
MAX_LANES = 16      # channel vectors of a block row: 256 contiguous bytes
MAX_SPLIT = 16      # blocks of one cluster: the non-portable cluster size
FILL_BLOCKS = 128   # blocks the grid has at least, where the map allows
PIXELS_PER_THREAD = 16  # what a thread walks on a large map


def reference_double_affine_leaky(x: torch.Tensor, g1: torch.Tensor,
                                  b1: torch.Tensor, g2: torch.Tensor,
                                  b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in x's dtype (the math of the JAX package's
    `reference_double_affine_leaky`)."""
    s = neg_slope(x.dtype)
    y1 = g1[:, None, None, :] * x + b1[:, None, None, :]
    h = torch.where(y1 >= 0, y1, y1 * s)
    y2 = g2[:, None, None, :] * h + b2[:, None, None, :]
    return torch.where(y2 >= 0, y2, y2 * s)


def reference_double_affine_leaky_bwd(
        x: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
        g2: torch.Tensor, b2: torch.Tensor, dy: torch.Tensor,
        want_z: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward (the math of the JAX package's
    `_bwd_kernel`): (dx, dg1, db1, dg2, db2), and with `want_z` also z, the
    forward's output, from the y2 the backward forms (equal to
    `reference_double_affine_leaky` bit for bit).

    Every elementwise op is in x's dtype; the slope is 1 where y >= 0, so
    at y == 0 exactly (where `F.leaky_relu`'s backward gives 0.2). The four
    [B, C] gradients add the products over H x W in fp32 and round once to
    x's dtype (the TPU kernel adds its tile sums in x's dtype)."""
    s = neg_slope(x.dtype)
    y1 = g1[:, None, None, :] * x + b1[:, None, None, :]
    pos1 = y1 >= 0
    h = torch.where(pos1, y1, y1 * s)
    y2 = g2[:, None, None, :] * h + b2[:, None, None, :]
    dy2 = torch.where(y2 >= 0, dy, dy * s)
    dh = dy2 * g2[:, None, None, :]
    dy1 = torch.where(pos1, dh, dh * s)
    dx = dy1 * g1[:, None, None, :]

    def hw_sum(t):
        return t.float().sum(dim=(1, 2)).to(x.dtype)

    grads = (dx, hw_sum(dy1 * x), hw_sum(dy1), hw_sum(dy2 * h), hw_sum(dy2))
    if want_z:
        return grads + (torch.where(y2 >= 0, y2, y2 * s),)
    return grads


class Plan(NamedTuple):
    """How both K1 kernels cut x [b, hw, c] (see csrc/fused_affine.cu):
    thread t of block (sample * chunks + chunk) * split + s owns channel
    vector chunk * lanes + t % lanes (`vec` channels from vec times that)
    and the pixels s * ppb + t // lanes + k * rows of its block's range
    [s * ppb, min((s + 1) * ppb, hw))."""
    vec: int      # channels a thread moves per access: 16 bytes, or 1
    lanes: int    # channel vectors of a block: a power of two <= 16
    rows: int     # pixels a block walks side by side: a power of two
    chunks: int   # channel chunks of `lanes` vectors, ceil(c / vec / lanes)
    split: int    # blocks along the pixels per (sample, chunk): a cluster
    ppb: int      # pixels per block

    @property
    def threads(self) -> int:
        return self.lanes * self.rows

    def blocks(self, b: int) -> int:
        return b * self.chunks * self.split


@functools.lru_cache(maxsize=1024)
def _plan(b: int, hw: int, c: int, dtype: torch.dtype,
          aligned: bool = True) -> Plan:
    """The tiling of x [b, hw, c] for both K1 kernels. 16-byte channel
    vectors where c allows it and every pointer is `aligned`, else single
    elements; up to MAX_LANES vectors a block row, so a warp reads whole
    runs of 128-256 bytes; blocks of MAX_THREADS threads, two on an SM.
    The pixels of a (sample, chunk) are split between up to MAX_SPLIT
    blocks (one cluster): enough for FILL_BLOCKS blocks in all, and on a
    large map enough that a thread walks about PIXELS_PER_THREAD pixels. A
    block has as many pixel rows as its range has pixels, so no thread of
    a full block is without one."""
    vec = 16 // dtype.itemsize
    if not aligned or c % vec:
        vec = 1
    nvc = c // vec
    lanes = min(MAX_LANES, 1 << (nvc.bit_length() - 1))
    chunks = -(-nvc // lanes)
    full_rows = MAX_THREADS[dtype] // lanes
    split = min(MAX_SPLIT, hw, max(
        -(-FILL_BLOCKS // (b * chunks)),
        hw // (full_rows * PIXELS_PER_THREAD)))
    ppb = -(-hw // split)
    split = -(-hw // ppb)
    rows = max(min(full_rows, 1 << (ppb.bit_length() - 1)), 32 // lanes)
    return Plan(vec, lanes, rows, chunks, split, ppb)


_fns = None


def _lib():
    """(forward, backward): the kernel library's K1 entry points, typed
    once."""
    global _fns
    if _fns is None:
        lib = _build.load()
        fwd, bwd = lib.gct_fused_affine_fwd, lib.gct_fused_affine_bwd
        fwd.argtypes = ([ctypes.c_void_p] * 6
                        + [ctypes.c_longlong, ctypes.c_longlong]
                        + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        bwd.argtypes = ([ctypes.c_void_p] * 9
                        + [ctypes.c_longlong, ctypes.c_longlong]
                        + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fwd.restype = bwd.restype = ctypes.c_int
        _fns = fwd, bwd
    return _fns


def max_active_clusters(plan: Plan, dtype: torch.dtype) -> int:
    """How many clusters of `plan.split` backward blocks the current card
    holds at once (cudaOccupancyMaxActiveClusters; vector path)."""
    fn = _build.load().gct_fused_affine_bwd_max_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    rc = fn(plan.split, plan.threads, _DTYPES[dtype], ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error {rc}"
                           f" ({plan}, {dtype})")
    return out.value


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


def _launch_plan(x, ptrs):
    """(device context, plan, stream) of a launch on x's card: the
    context only where x is not on the current device; 16-byte vectors only
    where every pointer is 16-byte aligned."""
    b, h, w, c = x.shape
    aligned = all(p % 16 == 0 for p in ptrs)
    plan = _plan(b, h * w, c, x.dtype, aligned)
    index = x.device.index
    ctx = (torch.cuda.device(index) if index != torch.cuda.current_device()
           else contextlib.nullcontext())
    return ctx, plan, torch.cuda.current_stream(x.device).cuda_stream


def _forward(x, g1, b1, g2, b2) -> torch.Tensor:
    """K1 forward: the plain version for a CPU tensor, else the kernel."""
    if x.device.type == "cpu":
        return reference_double_affine_leaky(x, g1, b1, g2, b2)
    _on_cuda(("x", "g1", "b1", "g2", "b2"), (x, g1, b1, g2, b2))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, h, w, c = x.shape
    ptrs = [t.data_ptr() for t in (x, g1, b1, g2, b2, out)]
    ctx, plan, stream = _launch_plan(x, ptrs)
    with ctx:
        rc = _lib()[0](*ptrs, b, h * w, c, *plan, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fused_double_affine_leaky: CUDA error {rc} "
                           f"at launch (x {tuple(x.shape)}, {x.dtype}, "
                           f"{plan})")
    fused_double_affine_leaky.launches += 1
    return out


def fused_double_affine_leaky_bwd(
        x: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
        g2: torch.Tensor, b2: torch.Tensor, dy: torch.Tensor,
        want_z: bool = False) -> Tuple[torch.Tensor, ...]:
    """(dx, dg1, db1, dg2, db2) of `fused_double_affine_leaky` for the
    output gradient dy [B, H, W, C], all in x's dtype; with `want_z` also
    z, the forward's output (bit for bit), written in the same pass.

    CPU tensors run the plain version; CUDA tensors must be contiguous and
    run the kernel, one launch and no scratch (each launch adds one to
    `fused_double_affine_leaky_bwd.launches`). The four [B, C] gradients
    are views of one [4, B, C] tensor."""
    vecs = (g1, b1, g2, b2)
    _check(x, vecs, dy)
    if x.device.type == "cpu":
        return reference_double_affine_leaky_bwd(x, g1, b1, g2, b2, dy,
                                                 want_z)
    _on_cuda(("x", "g1", "b1", "g2", "b2", "dy"), (x,) + vecs + (dy,))
    b, h, w, c = x.shape
    dx = torch.empty_like(x)
    z = torch.empty_like(x) if want_z else None
    grads = torch.empty((4, b, c), dtype=x.dtype, device=x.device)
    if x.numel() == 0:  # no pixels: the sums over H x W are zeros
        grads.zero_()
    else:
        ptrs = [t.data_ptr() for t in (x, g1, b1, g2, b2, dy, dx)]
        ctx, plan, stream = _launch_plan(
            x, ptrs + ([z.data_ptr()] if want_z else []))
        with ctx:
            rc = _lib()[1](*ptrs, z.data_ptr() if want_z else None,
                           grads.data_ptr(), b, h * w, c, *plan,
                           _DTYPES[x.dtype], stream)
        if rc != 0:
            raise RuntimeError(
                f"fused_double_affine_leaky_bwd: CUDA error {rc} at launch "
                f"(x {tuple(x.shape)}, {x.dtype}, {plan})")
        fused_double_affine_leaky_bwd.launches += 1
    return (dx, *grads.unbind(0)) + ((z,) if want_z else ())


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
