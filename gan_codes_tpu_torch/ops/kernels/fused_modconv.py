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

The CUDA kernel is `csrc/fused_modconv.cu`, an implicit GEMM on the tensor
cores (`wgmma`: bf16, and 3xTF32 for fp32) that modulates each halo chunk
once in shared memory and streams the weights through a ring of stages.
fp32 runs one TF32 product per product in place of three where the
process's fp32 precision is below "highest" (`utils/device.py::
one_pass_tf32`, read at each call and passed to the kernel);
the plain version then rounds both operands to TF32 as the kernel does.
Each forward first packs w, read at its own strides, into the order and
core-matrix layout the kernel copies stage by stage, with the tf32 hi/lo
split (`tf32_split`) for fp32: a pack kernel, whose plain version is
`_pack_weights`. `_plan` picks the N tile and the K chunk, and splits the
chunks between blocks where the output tiles are too few to fill the card.
A CPU tensor takes the plain PyTorch version below, `reference_modconv3x3`;
a CUDA tensor launches the kernels or raises.

`fused_modconv3x3` is a `torch.autograd.Function`. Its backward keeps K2's
design of never writing h to memory in the forward: it saves x, takes dh
from the convolution's input gradient (`torch.nn.grad`, as the JAX
backward is XLA's), then dx, dg1, db1, dg2 and db2 from one launch of K1's
backward kernel, which also writes h (its z) from the chain it rebuilds,
and last dw from the convolution's weight gradient of that h, and dbias.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from . import fused_affine
from .fused_affine import _DTYPES, _on_cuda, reference_double_affine_leaky
from ...utils.device import one_pass_tf32

COUT_STEP = 32     # Cout granularity: one wgmma n32 instruction
# output channels of one block: the largest wgmma N in bf16; in fp32 half of
# it, as each K chunk's sums are added into a second set of registers
MAX_N_TILE = {torch.bfloat16: 256, torch.float32: 128}
TARGET_BLOCKS = 264  # two resident blocks on each of the H100's 132 SMs


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 v rounded to TF32 (10 mantissa bits; its 13 low bits 0), to
    nearest with ties away from zero as `cvt.rna.tf32.f32` rounds."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def reference_modconv3x3(x: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
                         g2: torch.Tensor, b2: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor, tf32: bool = False
                         ) -> torch.Tensor:
    """Plain PyTorch version, in x's dtype (the math of the JAX package's
    `_xla_composition`): modulation, then a torch conv, then `+ bias`.
    `tf32` (fp32): the one-pass kernel's math, both conv operands rounded
    to TF32 first (their products are exact in fp32, the sums fp32)."""
    h = reference_double_affine_leaky(x, g1, b1, g2, b2)
    w = w.to(h.dtype)
    if tf32 and h.dtype == torch.float32:
        h, w = tf32_round(h), tf32_round(w)
    y = F.conv2d(h.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1) + bias.to(h.dtype)


def _supported(w: torch.Tensor) -> bool:
    """Whether the kernel takes this DFBlock: Cout a multiple of 32 (one
    wgmma n32 instruction per 32 channels). Any batch, H, W and Cin are
    taken (the kernel masks its edges and zero-fills a Cin tail, and its
    1-D grid has no 65535 cap). The check depends on shapes only, so CPU
    and CUDA tensors dispatch alike; every DFBlock of the 32-256px
    generators at n_channels 32 is taken."""
    return w.shape[-1] % COUT_STEP == 0


class Plan(NamedTuple):
    """How the kernel cuts one call (see csrc/fused_modconv.cu)."""
    kc: int        # input channels per wgmma k step: 16 (bf16), 8 (fp32)
    ks: int        # k steps per K chunk
    chunks: int    # K chunks, ceil(Cin / (ks * kc))
    nt: int        # N tile of nt * 32 channels: 1, 2, 4 (8 in bf16)
    n_tiles: int   # N tiles of nt * 32 channels
    cps: int       # K chunks per split
    splits: int    # blocks that share one output tile (split K)
    m_tiles: int   # 8 x 8 output tiles of the stacked image

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits

    def scratch_bytes(self, pixels: int, cout: int, dtype) -> int:
        """The kernel's workspace: the packed weights, rounded up to 256
        bytes, then for split K the fp32 partial sums."""
        pack = (self.n_tiles * self.chunks * 9 * self.ks * self.kc
                * self.nt * COUT_STEP * (8 if dtype == torch.float32 else 2))
        partial = self.splits * pixels * cout * 4 if self.splits > 1 else 0
        return -(-pack // 256) * 256 + partial


@functools.lru_cache(maxsize=256)
def _plan(b: int, h: int, w: int, cin: int, cout: int,
          dtype: torch.dtype) -> Plan:
    """The kernel's tiling of x [b, h, w, cin] -> cout. M tiles cover the
    stacked image (the b samples one under another, one zero row between
    neighbours); where M x N tiles are fewer than TARGET_BLOCKS, the Cin
    chunks are split between blocks, no split holding less than one."""
    kc, parts = (16, 1) if dtype == torch.bfloat16 else (8, 2)
    nt = 1
    while nt * COUT_STEP < min(cout, MAX_N_TILE[dtype]):
        nt *= 2
    # csrc: ks_of, a chunk's halo within 12.8 KB, a weight stage within
    # 8 KB, and one k step a chunk for N = 32
    ks = 1 if nt == 1 else max(1, min(4 // parts, 8 // (parts * nt)))
    chunks = -(-cin // (ks * kc))
    n_tiles = -(-cout // (nt * COUT_STEP))
    m_tiles = -(-(b * (h + 1) - 1) // 8) * -(-w // 8)
    want = -(-TARGET_BLOCKS // (m_tiles * n_tiles))
    cps = -(-chunks // max(1, min(chunks, want)))
    return Plan(kc, ks, chunks, nt, n_tiles, cps, -(-chunks // cps), m_tiles)


def tf32_split(v: torch.Tensor):
    """(hi, lo) float32 with hi = tf32(v) and lo = tf32(v - hi), both
    `tf32_round`ed: hi + lo is v to about 2^-22 relative. The operand
    split of the kernel's 3xTF32."""
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def _packed_shape(plan: Plan, parts: int, taps: int = 9):
    ntile = plan.nt * COUT_STEP
    return (plan.n_tiles, plan.chunks, taps, plan.ks, parts, ntile // 8, 2,
            8, plan.kc // 2)


def _pack_weights(w: torch.Tensor, plan: Plan,
                  one_pass: bool = False) -> torch.Tensor:
    """w [3, 3, Cin, Cout] HWIO, or a 1x1 [1, 1, Cin, Cout] (any strides)
    -> the kernels' weight stages, zero-padded to chunks * ks * kc input
    and n_tiles * nt * 32 output channels: [n tile][chunk][tap][k step]
    [part][N / 8][2][8][kc / 2], part = (w,) in bf16 and (hi, lo) in fp32
    (`one_pass`: hi and zeros; the pack kernel leaves lo unwritten, and
    the one-pass kernels read hi alone).
    One stage (chunk, tap) holds the B operands of ks wgmma k steps: 8-row
    core matrices of 16 bytes (8 output channels x kc / 2 input channels),
    the two K columns 128 bytes apart and the 8-row groups 256 bytes
    apart."""
    kh, kw, cin, cout = w.shape
    kt = plan.kc // 2
    ntile = plan.nt * COUT_STEP
    cin_p = plan.chunks * plan.ks * plan.kc
    cout_p = plan.n_tiles * ntile
    if (cin_p, cout_p) != (cin, cout):
        padded = w.new_zeros((kh, kw, cin_p, cout_p))
        padded[:, :, :cin, :cout] = w
        w = padded
    w = w.reshape(kh * kw, plan.chunks, plan.ks, 2, kt, plan.n_tiles,
                  ntile // 8, 8)
    if w.dtype != torch.float32:
        parts = (w,)
    elif one_pass:
        parts = (tf32_round(w), torch.zeros_like(w))
    else:
        parts = tf32_split(w)
    packed = w.new_empty(_packed_shape(plan, len(parts), kh * kw))
    for i, part in enumerate(parts):
        # (tap, chunk, ks, kb, kt, ntile, nb, r)
        #   -> (ntile, chunk, tap, ks, nb, kb, r, kt)
        packed[:, :, :, :, i].copy_(part.permute(5, 1, 0, 2, 6, 3, 7, 4))
    return packed


_fns = None


def _lib():
    """(pack, forward): the kernel library's two entry points, typed once."""
    global _fns
    if _fns is None:
        lib = _build.load()
        pack, fwd = lib.gct_fused_modconv3x3_pack, lib.gct_fused_modconv3x3_fwd
        pack.argtypes = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                          ctypes.c_void_p] + [ctypes.c_int] * 8
                         + [ctypes.c_void_p])
        fwd.argtypes = ([ctypes.c_void_p] * 6
                        + [ctypes.POINTER(ctypes.c_longlong)]
                        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
                        + [ctypes.c_void_p])
        pack.restype = fwd.restype = ctypes.c_int
        _fns = pack, fwd
    return _fns


def pack_weights(w: torch.Tensor, plan: Plan,
                 one_pass: bool = False) -> torch.Tensor:
    """`_pack_weights` for the kernel: its plain version on a CPU tensor,
    on a CUDA tensor the pack kernel (one launch, reading w at its own
    strides, so the HWIO view of a torch OIHW weight is not copied first;
    with `one_pass` the lo plane is left unwritten)."""
    one_pass = one_pass and w.dtype == torch.float32
    if w.device.type == "cpu":
        return _pack_weights(w, plan, one_pass)
    parts = 2 if w.dtype == torch.float32 else 1
    taps = w.shape[0] * w.shape[1]
    packed = torch.empty(_packed_shape(plan, parts, taps), dtype=w.dtype,
                         device=w.device)
    strides = (ctypes.c_longlong * 4)(*w.stride())
    with torch.cuda.device(w.device):
        rc = _lib()[0](w.data_ptr(), strides, packed.data_ptr(), taps,
                       w.shape[2], w.shape[3], plan.nt, plan.ks,
                       plan.n_tiles, _DTYPES[w.dtype], int(one_pass),
                       torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_modconv3x3 weight pack: CUDA error {rc} "
                           f"(w {tuple(w.shape)}, {w.dtype}, {plan})")
    return packed


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
    """K2 forward: the plain version for a CPU tensor, else the kernel, in
    fp32 one TF32 pass or three as `one_pass_tf32` says now."""
    one_pass = x.dtype == torch.float32 and one_pass_tf32()
    if x.device.type == "cpu":
        return reference_modconv3x3(x, g1, b1, g2, b2, w, bias, one_pass)
    # w may be any strided HWIO view: the pack reads it once
    _on_cuda(("x", "g1", "b1", "g2", "b2", "bias"), (x, g1, b1, g2, b2, bias))
    if not _supported(w):
        raise ValueError(f"fused_modconv3x3 takes Cout % {COUT_STEP} == 0, "
                         f"got w {tuple(w.shape)}")
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = _plan(b, h, wd, cin, cout, x.dtype)
    # one allocation for the packed weights and the split-K partial sums;
    # one call packs, convolves and adds the splits
    scratch = torch.empty(plan.scratch_bytes(b * h * wd, cout, x.dtype),
                          dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib()[1](
            x.data_ptr(), g1.data_ptr(), b1.data_ptr(), g2.data_ptr(),
            b2.data_ptr(), w.data_ptr(), (ctypes.c_longlong * 4)(*w.stride()),
            bias.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, h, wd,
            cin, cout, plan.nt, plan.n_tiles, plan.cps, plan.splits,
            _DTYPES[x.dtype], int(one_pass),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_modconv3x3: CUDA error {rc} at launch "
                           f"(x {tuple(x.shape)}, w {tuple(w.shape)}, "
                           f"{x.dtype}, one_pass {one_pass}, {plan})")
    fused_modconv3x3.launches += 1
    return out


class _FusedModConv3x3(torch.autograd.Function):
    """Forward K2; backward the conv's input gradient, then K1 bwd, which
    also gives h for the conv's weight gradient."""

    @staticmethod
    def forward(ctx, x, g1, b1, g2, b2, w, bias):
        ctx.save_for_backward(x, g1, b1, g2, b2, w)
        return _forward(x, g1, b1, g2, b2, w, bias)

    @staticmethod
    def backward(ctx, dy):
        x, g1, b1, g2, b2, w = ctx.saved_tensors
        dy = dy.contiguous()
        w_oihw = w.permute(3, 2, 0, 1)
        dy_nchw = dy.permute(0, 3, 1, 2)
        dh = torch.nn.grad.conv2d_input(
            (x.shape[0], x.shape[3], x.shape[1], x.shape[2]), w_oihw,
            dy_nchw, padding=1).permute(0, 2, 3, 1).contiguous()
        want_dw = ctx.needs_input_grad[5]
        grads = fused_affine.fused_double_affine_leaky_bwd(
            x, g1, b1, g2, b2, dh, want_z=want_dw)
        del dh
        dw = dbias = None
        if want_dw:  # grads[5] is h
            dw = torch.nn.grad.conv2d_weight(
                grads[5].permute(0, 3, 1, 2), w_oihw.shape, dy_nchw,
                padding=1).permute(2, 3, 1, 0)
        if ctx.needs_input_grad[6]:
            dbias = dy.sum(dim=(0, 1, 2))
        return (*grads[:5], dw, dbias)


def fused_modconv3x3(x: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
                     g2: torch.Tensor, b2: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """conv3x3_same(lrelu(g2 * lrelu(g1 * x + b1) + b2), w) + bias.

    Differentiable in all seven inputs. CPU tensors run the plain versions;
    CUDA tensors must be `_supported` and contiguous (w may be any strided
    view: it is packed once per forward), and run the kernels. fp32 runs
    one TF32 pass where `one_pass_tf32()`, else 3xTF32
    (each forward launch adds one to `fused_modconv3x3.launches`; the
    backward launches K1 bwd, with h, and counts on its counter)."""
    _check(x, g1, b1, g2, b2, w, bias)
    return _FusedModConv3x3.apply(x, g1, b1, g2, b2, w, bias)


fused_modconv3x3.launches = 0
