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

The CUDA kernel is `csrc/fused_resblock.cu`: both 3x3 convs and the 1x1
shortcut as implicit GEMMs on the tensor cores (`wgmma`: bf16, and 3xTF32
for fp32, K2's machinery in `csrc/wgmma.cuh`), the raw h1 of each output
tile and its halo kept in shared memory and modulated chunk by chunk as
conv2's A operand. `_plan` picks the output tile (any height and width of
the stacked image: the kernel's M rows are a flattened pitch grid), the N
tile and the weight ring per shape, within the card's shared memory. Each
forward packs w1, w2 and ws with K2's pack kernel into one scratch buffer
and launches the kernel once. fp32 runs one TF32 product per product in
place of three as K2 does (`utils/device.py::one_pass_tf32`). A CPU
tensor takes the plain PyTorch version below, `reference_resblock_g`; a
CUDA tensor launches the kernel or raises. Unlike the JAX op, which falls
back to the composition for a shape its kernel declines, a CUDA tensor of
a shape K3 does not take raises.

`fused_resblock_g` is a `torch.autograd.Function`, differentiable in all
16 inputs. Its backward recomputes the block as the JAX package's VJP
recomputes `_xla_composition`: each DFBlock as K1 and a torch conv (the
shortcut and gamma as torch ops), then takes their autograd gradient, so
on the card it runs K1, cuDNN and K1 bwd. K1 equals its plain version bit
for bit, so the recomputed h1 is the plain composition's and the LeakyReLU
masks of the second DFBlock are too; recomputed through K2, whose sums
round otherwise, an h1 near a mask's kink can flip it and move a gradient
by about 1e-3 of its largest element.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build
from . import fused_affine, fused_modconv
from .. import nn as ops_nn
from .fused_affine import _DTYPES, _on_cuda
from .fused_modconv import (COUT_STEP, one_pass_tf32, reference_modconv3x3,
                            tf32_round)

MAX_COUT = 256   # the widest wgmma N, and raw h1 of a tile in shared memory
SMEM_LIMIT = 232448   # the H100's opt-in shared memory a block (csrc)
MAX_STAGES = 18       # weight ring: two chunks of 9 taps (csrc kMaxStages)
BAR_BYTES = 512       # csrc kBarBytes
SMS = 132             # the H100's SMs: one block each
MAX_TILE = 64         # tile rows and columns the plan tries
CONV1_SHARE = 1.5625  # conv1 M rows a output pixel of the direct-conv K3
# N tile caps (in 32s): fp32 sums each chunk apart (acc + sum registers);
# the 1x1 shortcut keeps its own sums beside conv2's
MAX_NT = {(torch.bfloat16, False): 8, (torch.float32, False): 4,
          (torch.bfloat16, True): 4, (torch.float32, True): 2}
# _plan's time model (`_seconds`), fitted to runs of K3 on an H100 at the
# 7 blocks of the 256px generator over 9-14 tilings each (PERF.md §6;
# tools/k3_plan_sweep.py), per dtype: the tensor cores' share of their
# dense peak, a K chunk's fixed cost, a round of A-build items, a tap, and
# an epilogue's N tile of 32 channels (seconds).
MODEL = {torch.bfloat16: dict(eff=0.3, chunk=0.5e-6, build=3e-6, tap=0.0,
                              epi=2e-6),
         torch.float32: dict(eff=0.3, chunk=0.5e-6, build=4e-6, tap=0.1e-6,
                             epi=0.0)}
_NAMES = ("x", "g1", "b1", "g2", "b2", "w1", "c1", "g3", "b3", "g4", "b4",
          "w2", "c2", "gamma", "ws", "cs")


def reference_resblock_g(x, g1, b1, g2, b2, w1, c1, g3, b3, g4, b4, w2, c2,
                         gamma, ws=None, cs=None, tf32: bool = False
                         ) -> torch.Tensor:
    """Plain PyTorch version, in x's dtype (the math of the JAX package's
    `_xla_composition`): two modulation + conv + bias DFBlocks, the
    shortcut, then `shortcut + gamma * h2`. `tf32` (fp32): the one-pass
    kernel's math, every conv's operands rounded to TF32 first."""
    h1 = reference_modconv3x3(x, g1, b1, g2, b2, w1, c1, tf32)
    h2 = reference_modconv3x3(h1, g3, b3, g4, b4, w2, c2, tf32)
    shortcut = x
    if ws is not None:
        xs, ws = x, ws.to(x.dtype)
        if tf32 and x.dtype == torch.float32:
            xs, ws = tf32_round(xs), tf32_round(ws)
        y = F.conv2d(xs.permute(0, 3, 1, 2), ws.permute(3, 2, 0, 1))
        shortcut = y.permute(0, 2, 3, 1) + cs.to(x.dtype)
    return shortcut + gamma.to(x.dtype) * h2


def _supported(w1: torch.Tensor) -> bool:
    """Whether the kernel takes this block: Cout a multiple of 32 (one
    wgmma n32 instruction per 32 channels) and at most 256 (raw h1 of a
    tile, all Cout channels, must fit in shared memory beside the weight
    ring; `_plan` finds a tiling for every such Cout and any batch, H, W
    and Cin). The check
    depends on shapes only, so CPU and CUDA tensors dispatch alike; every
    block of the 32-256px generators at n_channels 32 is taken."""
    cout = w1.shape[-1]
    return cout % COUT_STEP == 0 and cout <= MAX_COUT


class Plan(NamedTuple):
    """How the kernel cuts one call (see csrc/fused_resblock.cu)."""
    kc: int        # input channels per wgmma k step: 16 (bf16), 8 (fp32)
    ks: int        # k steps per K chunk (csrc: ks3_of)
    nt: int        # N tile of nt * 32 channels
    n_tiles: int   # N passes, Cout / (nt * 32)
    th: int        # output tile rows of the stacked image
    tw: int        # output tile columns
    tiles_h: int
    tiles_w: int
    m1: int        # conv1's m64 tiles: (th + 1) * p1 + tw + 2 rows
    m2: int        # conv2's m64 tiles: (th - 1) * p2 + tw rows
    ch1: int       # K chunks of Cin (conv1, the 1x1 shortcut)
    ch2: int       # K chunks of Cout (conv2)
    stages: int    # weight ring stages, 9-18
    smem: int      # dynamic shared memory bytes
    scratch_bytes: int  # the packed w1, w2, ws, each rounded to 256 bytes
    conv1_share: float  # conv1 M rows over the output pixels

    @property
    def blocks(self) -> int:
        return self.tiles_h * self.tiles_w


def _geometry(th: int, tw: int):
    """(p1, p2, m1, m2, apix, hpix) of a th x tw tile: the pitches of the x
    halo and h1 grids, the m64 tiles of conv1 (h1 on (th + 2) x (tw + 2))
    and conv2, the pixels of an A buffer (a pass's two m64 tiles plus the
    largest tap shift, 2 * p1 + 2), and raw h1's pixels."""
    p1, p2 = tw + 4, tw + 2
    m1 = -(-((th + 1) * p1 + tw + 2) // 64)
    m2 = -(-((th - 1) * p2 + tw) // 64)
    return p1, p2, m1, m2, 128 + 2 * p1 + 2, (th + 2) * p2


def _seconds(p: Plan, sc: bool, dtype: torch.dtype,
             c: Optional[dict] = None) -> float:
    """The model's time of a call under plan p (1x1 shortcut if sc), with
    the constants c (MODEL's by default): waves of blocks, one a SM; in a
    block, each K chunk of each m64 pass (two warpgroups share each weight
    stage) and N tile takes the larger of its products on the tensor cores
    and its fixed cost plus its A build (the pass's pixels, 4 items a
    thread a round, 2 at N 256), and each pass's epilogue its N tiles."""
    c = MODEL[dtype] if c is None else c
    fp32 = dtype == torch.float32
    tc = (495e12 if fp32 else 989e12) / SMS * c["eff"]
    per_round = (2 if p.nt == 8 else 4) * 256
    t = 0.0
    for m, gemms in ((p.m1, [(p.ch1, 9, p.tw + 4)]),
                     (p.m2, [(p.ch2, 9, p.tw + 2)]
                      + ([(p.ch1, 1, p.tw + 2)] if sc else []))):
        for i in range(-(-m // 2)):
            rows = 128 if 2 * i + 1 < m else 64
            for ch, taps, pitch in gemms:
                mma = (2.0 * rows * taps * p.ks * p.kc * p.nt * COUT_STEP
                       * (3 if fp32 else 1) / tc)
                rounds = -(-p.ks * 2 * (130 + 2 * pitch) // per_round)
                t += p.n_tiles * ch * max(
                    mma, c["chunk"] + c["build"] * rounds + c["tap"] * taps)
            t += p.n_tiles * p.nt * c["epi"]
    return t * -(-p.blocks // SMS)


def _candidates(b: int, h: int, w: int, cin: int, cout: int,
                dtype: torch.dtype, sc: bool):
    """[(estimated seconds, Plan)] of every tiling `_plan` weighs."""
    fp32 = dtype == torch.float32
    parts, kc, esize = (2, 8, 4) if fp32 else (1, 16, 2)
    rs = b * (h + 1) - 1
    pixels = b * h * w
    found = []
    nt = 1
    while nt <= MAX_NT[(dtype, sc)]:
        if cout % (nt * COUT_STEP):
            break
        ks = max(1, min(4, 8 // (parts * nt)))  # csrc: ks3_of
        ck = ks * kc
        stage = ks * parts * nt * COUT_STEP * 32
        ch1, ch2 = -(-cin // ck), -(-cout // ck)
        n_tiles = cout // (nt * COUT_STEP)
        wbytes = ck * cout * esize * parts  # one tap of one K chunk
        w1, w2, ws = 9 * ch1 * wbytes, 9 * ch2 * wbytes, ch1 * wbytes
        for th in range(1, min(rs, MAX_TILE) + 1):
            for tw in range(1, min(w, MAX_TILE) + 1):
                p1, p2, m1, m2, apix, hpix = _geometry(th, tw)
                base = (BAR_BYTES + 2 * ks * parts * 32 * apix
                        + hpix * ch2 * ck * esize)
                if base + 9 * stage > SMEM_LIMIT:
                    continue
                stages = min(MAX_STAGES, (SMEM_LIMIT - base) // stage)
                tiles_h, tiles_w = -(-rs // th), -(-w // tw)
                blocks = tiles_h * tiles_w
                scratch = sum(-(-x // 256) * 256
                              for x in (w1, w2, ws if sc else 0))
                plan = Plan(kc, ks, nt, n_tiles, th, tw, tiles_h, tiles_w,
                            m1, m2, ch1, ch2, stages, base + stages * stage,
                            scratch, blocks * m1 * 64 / pixels)
                found.append((_seconds(plan, sc, dtype), plan))
        nt *= 2
    return found


@functools.lru_cache(maxsize=256)
def _plan(b: int, h: int, w: int, cin: int, cout: int, dtype: torch.dtype,
          sc: bool) -> Plan:
    """The kernel's tiling of a block x [b, h, w, cin] -> cout, with the 1x1
    shortcut where sc (which Cin == Cout may have too). Tries every
    N tile and every tile of up to MAX_TILE rows and columns of the stacked
    image (b samples one under another, a zero row between neighbours)
    whose shared memory fits with at least 9 ring stages, and estimates its
    time with `_seconds`. Among the tilings within 25% of the fastest, it
    takes the fastest whose conv1 share is at most CONV1_SHARE, else the
    fastest. Raises where no tiling fits."""
    found = _candidates(b, h, w, cin, cout, dtype, sc)
    if not found:
        raise ValueError(f"fused_resblock_g: no tiling of Cin {cin} -> "
                         f"Cout {cout} ({dtype}) fits in {SMEM_LIMIT} bytes "
                         "of shared memory")
    best = min(t for t, _ in found)
    near = [(t, p) for t, p in found
            if t <= 1.25 * best and p.conv1_share <= CONV1_SHARE]
    # ties (to the ns) go to the wider N tile: fewer epilogues and A builds
    return min(near or found, key=lambda tp: (round(tp[0], 9), -tp[1].nt))[1]


_fn = None


def _lib():
    """The kernel library's K3 entry point, typed once."""
    global _fn
    if _fn is None:
        fn = _build.load().gct_fused_resblock_g_fwd
        strides = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [strides]
                       + [ctypes.c_void_p] * 6 + [strides]
                       + [ctypes.c_void_p] * 3 + [strides]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    """K3 forward: the plain version for a CPU tensor, else the kernel, in
    fp32 one TF32 pass or three as `one_pass_tf32` says now. `args` are
    the 16 inputs with gamma already of shape [1] in x's dtype."""
    (x, g1, b1, g2, b2, w1, c1, g3, b3, g4, b4, w2, c2, gamma, ws,
     cs) = args
    one_pass = x.dtype == torch.float32 and one_pass_tf32()
    if x.device.type == "cpu":
        return reference_resblock_g(*args, tf32=one_pass)
    present = [(n, t) for n, t in zip(_NAMES, args) if t is not None]
    _on_cuda(*zip(*present))
    if not _supported(w1):
        raise ValueError(f"fused_resblock_g takes Cout % {COUT_STEP} == 0 "
                         f"and Cout <= {MAX_COUT}, got w1 {tuple(w1.shape)}")
    b, h, w, cin = x.shape
    cout = w1.shape[3]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = _plan(b, h, w, cin, cout, x.dtype, ws is not None)
    # the packed w1, w2 and ws: one allocation, packed inside the call
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    def strides(t):
        return (ctypes.c_longlong * 4)(*(t.stride() if t is not None
                                          else (0, 0, 0, 0)))

    with torch.cuda.device(x.device):
        rc = _lib()(
            ptr(x), ptr(g1), ptr(b1), ptr(g2), ptr(b2), ptr(w1), strides(w1),
            ptr(c1), ptr(g3), ptr(b3), ptr(g4), ptr(b4), ptr(w2),
            strides(w2), ptr(c2), ptr(gamma), ptr(ws), strides(ws),
            ptr(cs), out.data_ptr(), scratch.data_ptr(), b, h, w, cin, cout,
            plan.nt, plan.th, plan.tw, plan.stages, _DTYPES[x.dtype],
            int(one_pass), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_resblock_g: CUDA error {rc} at launch "
                           f"(x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                           f"shortcut {ws is not None}, {x.dtype}, "
                           f"one_pass {one_pass}, {plan})")
    fused_resblock_g.launches += 1
    return out


def _df_block(x, ga, ba, gb, bb, w, c, fused: bool) -> torch.Tensor:
    """One DFBlock through the port's kernels: K2 where `fused` and it
    takes the shape (as `ops/blocks.py` runs it), else K1 and a torch
    conv."""
    if fused and fused_modconv._supported(w):
        return fused_modconv.fused_modconv3x3(x, ga, ba, gb, bb, w, c)
    h = fused_affine.fused_double_affine_leaky(x, ga, ba, gb, bb)
    return ops_nn.conv2d(h, w.permute(3, 2, 0, 1), c, padding=1)


def _composition(x, g1, b1, g2, b2, w1, c1, g3, b3, g4, b4, w2, c2, gamma,
                 ws, cs, fused: bool = True) -> torch.Tensor:
    """The block through the DFBlock kernels: with `fused`, as the model
    path computes it; without, K1 and torch convs (the backward's
    recompute)."""
    h1 = _df_block(x, g1, b1, g2, b2, w1, c1, fused)
    h2 = _df_block(h1, g3, b3, g4, b4, w2, c2, fused)
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
            out = _composition(*leaves, fused=False)
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
    (fp32 one TF32 pass where `one_pass_tf32()`, else 3xTF32)
    (each forward launch adds one to `fused_resblock_g.launches`; the
    backward launches K1 and K1 bwd and counts on their counters)."""
    _check(x, g1, b1, g2, b2, w1, c1, g3, b3, g4, b4, w2, c2, gamma, ws, cs)
    return _FusedResBlockG.apply(x, g1, b1, g2, b2, w1, c1, g3, b3, g4, b4,
                                 w2, c2, gamma.reshape(1).to(x.dtype), ws,
                                 cs)


fused_resblock_g.launches = 0
