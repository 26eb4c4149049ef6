"""The port's kernel modules (gan_codes_tpu_torch/ops/kernels) held against
the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version; those run here
against the Pallas kernel (interpret mode, as tests/test_pallas.py runs it)
and against the JAX package's own plain reference, on the same numpy
inputs. The CUDA kernels themselves run only on a card:
tests/test_torch_port_cuda.py holds them against these plain versions.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_codes_tpu.ops import nn as jnn
from gan_codes_tpu.ops.pallas.fused_affine import (
    NEG_SLOPE as jax_k1_neg_slope, _fwd as jax_k1_fwd,
    _vjp_bwd as jax_k1_vjp_bwd, fused_double_affine_leaky as jax_k1,
    reference_double_affine_leaky as jax_k1_ref)
from gan_codes_tpu.ops.pallas.fused_modconv import (
    _xla_composition as jax_k2_ref, fused_modconv3x3 as jax_k2)
from gan_codes_tpu_torch.config import GeneratorConfig
from gan_codes_tpu_torch.models.generator import Generator
from gan_codes_tpu_torch.ops import blocks
from gan_codes_tpu_torch.ops import nn as pnn
from gan_codes_tpu_torch.ops.kernels import fused_affine, fused_modconv
from torch_port_env import one_thread_children  # noqa: E402,F401


def _k1_inputs(shape, seed=0):
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    vecs = [rng.standard_normal((b, c)).astype(np.float32) for _ in range(4)]
    return [x] + vecs


def _k2_inputs(b, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    vecs = [rng.standard_normal((b, cin)).astype(np.float32)
            for _ in range(4)]
    bound = (9 * cin) ** -0.5
    wt = rng.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32)
    bias = rng.uniform(-bound, bound, (cout,)).astype(np.float32)
    return [x] + vecs + [wt, bias]


class TestK1Plain:
    @pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 4, 4, 32),
                                       (3, 16, 16, 8)])
    def test_matches_jax_kernel_and_reference(self, shape):
        # same elementwise ops on both sides; only rounding may differ
        args = _k1_inputs(shape)
        got = fused_affine.fused_double_affine_leaky(
            *map(torch.from_numpy, args)).numpy()
        want_kernel = np.asarray(jax_k1(*map(jnp.asarray, args)))
        want_ref = np.asarray(jax_k1_ref(*map(jnp.asarray, args)))
        np.testing.assert_allclose(got, want_kernel, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got, want_ref, atol=1e-6, rtol=0)

    def test_cpu_wrapper_is_the_plain_version_and_counts_nothing(self):
        args = list(map(torch.from_numpy, _k1_inputs((2, 4, 4, 8), seed=1)))
        before = fused_affine.fused_double_affine_leaky.launches
        got = fused_affine.fused_double_affine_leaky(*args)
        assert torch.equal(
            got, fused_affine.reference_double_affine_leaky(*args))
        assert fused_affine.fused_double_affine_leaky.launches == before

    def test_rejects_bad_inputs(self):
        x, g1, b1, g2, b2 = map(torch.from_numpy, _k1_inputs((2, 4, 4, 8)))
        with pytest.raises(ValueError, match="g1"):
            fused_affine.fused_double_affine_leaky(x, g1[:1], b1, g2, b2)
        with pytest.raises(TypeError, match="dtype"):
            fused_affine.fused_double_affine_leaky(x, g1.double(), b1, g2, b2)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fused_affine.fused_double_affine_leaky(
                x.double(), *(v.double() for v in (g1, b1, g2, b2)))
        with pytest.raises(ValueError, match=r"\[B, H, W, C\]"):
            fused_affine.fused_double_affine_leaky(x[0], g1, b1, g2, b2)


# (H = W, C) of the DFBlock inputs of the 256px generator (n_channels 32):
# its 14 DFBlocks have these 10 distinct shapes
K1_SHAPES = [(4, 256), (8, 256), (16, 256), (32, 256), (64, 256), (64, 128),
             (128, 128), (128, 64), (256, 64), (256, 32)]


def _k1_coverage(plan, b, hw, c):
    """How often the kernels' index map (csrc/fused_affine.cu, `plan_walk`)
    visits each (pixel, channel) of sample 0, and how many threads of the
    grid have at least one pixel. Blocks are (sample * chunks + chunk) *
    split + s; thread t takes channel vector chunk * lanes + t % lanes and
    pixels s * ppb + t // lanes + k * rows below min((s + 1) * ppb, hw)."""
    nvc = c // plan.vec
    counts = np.zeros((hw, nvc), np.int64)
    busy = 0
    blocks = np.arange(plan.blocks(b))
    s_of, grp = blocks % plan.split, blocks // plan.split
    sample, chunk = grp // plan.chunks, grp % plan.chunks
    # every (sample, chunk) has `split` blocks, s = 0 .. split - 1
    pairs = np.stack([sample, chunk, s_of], 1)
    assert len(np.unique(pairs, axis=0)) == len(blocks)
    assert sample.max() == b - 1 and chunk.max() == plan.chunks - 1
    t = np.arange(plan.threads)
    lane, row = t % plan.lanes, t // plan.lanes
    for blk in blocks[sample == 0]:
        s, ch = s_of[blk], chunk[blk]
        cv = ch * plan.lanes + lane
        p0 = s * plan.ppb + row
        p1 = min((s + 1) * plan.ppb, hw)
        n = np.where((cv < nvc) & (p0 < p1), -(-(p1 - p0) // plan.rows), 0)
        busy += int((n > 0).sum())
        for k in range(int(n.max()) if n.size else 0):
            take = n > k
            np.add.at(counts, (p0[take] + k * plan.rows, cv[take]), 1)
    return counts, busy * b


class TestK1Layout:
    """The host side of the CUDA kernels: `_plan`, the streaming layout both
    K1 kernels walk."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("batch", [8, 24])
    @pytest.mark.parametrize("h,w,c", [(s, s, c) for s, c in K1_SHAPES]
                             + [(5, 7, 6), (5, 7, 2048), (5, 7, 32),
                                (1, 2, 6), (16, 16, 2048)])
    def test_plan_covers_each_pixel_and_channel_once(self, dtype, batch, h,
                                                     w, c):
        """Every (pixel, channel vector) of a sample exactly once, the grid
        decoding to every (sample, chunk, split rank) once; 16-byte vectors
        where C allows them (all 10 shapes), single elements otherwise
        (C = 6); at most 16 blocks per cluster, 32-1024 threads a block."""
        hw = h * w
        plan = fused_affine._plan(batch, hw, c, dtype)
        itemsize = torch.empty((), dtype=dtype).element_size()
        assert plan.vec == (16 // itemsize if c % (16 // itemsize) == 0
                            else 1)
        assert 1 <= plan.split <= fused_affine.MAX_SPLIT
        assert 32 <= plan.threads <= fused_affine.MAX_THREADS[dtype]
        assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= 32
        assert plan.rows & (plan.rows - 1) == 0
        counts, _ = _k1_coverage(plan, batch, hw, c)
        assert counts.shape == (hw, c // plan.vec)
        assert (counts == 1).all()

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("batch", [8, 24])
    def test_plan_fills_the_card_where_the_map_has_the_work(self, dtype,
                                                            batch):
        """At every DFBlock input of the 256px generator: where the map has
        at least FILL_BLOCKS x MAX_THREADS (128 x 512 in fp32, 128 x 256 in
        bf16) 16-byte vectors, at least 128 blocks of MAX_THREADS, every
        thread with pixels of its own; on the large maps a thread walks at
        least 16 pixels (4096 pixels and more) and every cluster has 16
        blocks (16384 and more); on any map, no thread of a full block is
        without a pixel."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        threads = fused_affine.MAX_THREADS[dtype]
        fill = fused_affine.FILL_BLOCKS * threads
        for hw, c in K1_SHAPES:
            plan = fused_affine._plan(batch, hw * hw, c, dtype)
            work = batch * hw * hw * c * itemsize // 16
            _, busy = _k1_coverage(plan, batch, hw * hw, c)
            assert plan.rows <= plan.ppb
            if work >= fill:
                assert plan.threads == threads, (hw, c)
                assert plan.blocks(batch) >= fused_affine.FILL_BLOCKS
                assert busy == plan.blocks(batch) * plan.threads, (hw, c)
            if hw * hw >= 4096:
                assert plan.ppb // plan.rows >= 16, (hw, c, plan)
            if hw * hw >= 16384:
                assert plan.split == 16, (hw, c, plan)

    def test_unaligned_pointers_take_single_elements(self):
        plan = fused_affine._plan(8, 64, 256, torch.float32, aligned=False)
        assert plan.vec == 1
        counts, _ = _k1_coverage(plan, 8, 64, 256)
        assert (counts == 1).all()


class TestK1BackwardWithZ:
    """The plain backward's z: the forward's output, from the backward's
    own y2."""

    @pytest.mark.parametrize("shape", [(2, 8, 8, 16), (3, 5, 7, 6),
                                       (1, 4, 4, 32)])
    def test_z_equals_the_forward_and_the_jax_kernel(self, shape):
        """z == `reference_double_affine_leaky` bit for bit (fp32 and
        bf16), and the JAX `_fwd` Pallas kernel (interpret mode) within
        1e-6 as TestK1Plain holds the forward; the five gradients are the
        ones the backward gives without z."""
        args = _k1_inputs(shape, seed=2)
        dy = np.random.default_rng(3).standard_normal(shape).astype(
            np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            ts = [torch.from_numpy(a).to(dtype) for a in args + [dy]]
            got = fused_affine.fused_double_affine_leaky_bwd(*ts,
                                                             want_z=True)
            assert len(got) == 6
            fwd = fused_affine.reference_double_affine_leaky(*ts[:5])
            assert torch.equal(got[5], fwd)
            plain = fused_affine.reference_double_affine_leaky_bwd(*ts)
            assert len(plain) == 5
            for g, w in zip(got[:5], plain):
                assert torch.equal(g, w)
        b, h, w, c = shape
        want = np.asarray(jax_k1_fwd(
            jnp.asarray(args[0]).reshape(b, h * w, c),
            *map(jnp.asarray, args[1:]))).reshape(shape)
        z = fused_affine.fused_double_affine_leaky_bwd(
            *map(torch.from_numpy, args + [dy]), want_z=True)[5]
        np.testing.assert_allclose(z.numpy(), want, atol=1e-6, rtol=0)


class TestK2Plain:
    @pytest.mark.parametrize("dims", [
        (2, 16, 16, 8, 16),   # tests/test_pallas.py's forward shape
        (1, 128, 8, 4, 4),    # two row tiles of the Pallas kernel
        (2, 5, 7, 3, 64),     # odd spatial dims, a Cout the CUDA kernel takes
        (2, 8, 8, 16, 32),    # Cout 32: one wgmma n32 tile of the CUDA kernel
    ])
    def test_matches_jax_kernel_and_composition(self, dims):
        # conv sums are reordered across frameworks: atol/rtol 1e-4
        args = _k2_inputs(*dims)
        got = fused_modconv.fused_modconv3x3(
            *map(torch.from_numpy, args)).numpy()
        want_kernel = np.asarray(jax_k2(*map(jnp.asarray, args)))
        want_ref = np.asarray(jax_k2_ref(*map(jnp.asarray, args)))
        np.testing.assert_allclose(got, want_kernel, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got, want_ref, atol=1e-4, rtol=1e-4)

    def test_padding_stays_zero(self):
        """g * 0 + b != 0: the SAME padding must not be modulated. With
        zero input, unit gains and a large shift, an unmasked border would
        leak the shift through the edge taps."""
        b, h, w, c = 1, 4, 4, 2
        x = torch.zeros(b, h, w, c)
        g = torch.ones(b, c)
        shift = torch.full((b, c), 3.0)
        wt = torch.ones(3, 3, c, 64)
        out = fused_modconv.fused_modconv3x3(x, g, shift, g, shift, wt,
                                             torch.zeros(64))
        # h = lrelu(1 * lrelu(0 + 3) + 3) = 6 inside, 0 in the padding
        taps = torch.tensor([[4, 6, 6, 4], [6, 9, 9, 6], [6, 9, 9, 6],
                             [4, 6, 6, 4]], dtype=torch.float32)
        assert torch.equal(out[0, :, :, 0], taps * 6.0 * c)

    def test_supported_follows_the_cuda_kernel_limits(self):
        # Cout % 32 only: no limit on batch, H, W or Cin to pass here
        assert fused_modconv._supported(torch.empty(3, 3, 32, 64))
        assert fused_modconv._supported(torch.empty(3, 3, 3, 256))
        assert fused_modconv._supported(torch.empty(3, 3, 64, 32))
        assert fused_modconv._supported(torch.empty(3, 3, 5, 544))
        for cout in (16, 48, 100):
            assert not fused_modconv._supported(torch.empty(3, 3, 32, cout))

    def test_every_dfblock_of_the_32px_generator_dispatches_to_k2(self):
        """n_channels 32: Cout 256, 128, 64 and 32, all K2's; K1's plain
        DFBlock path is never taken."""
        cfg = GeneratorConfig(image_size=32)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            gen = Generator(cfg)
            noise, sent = torch.randn(1, cfg.latent_dim), torch.randn(1, 256)
        with mock.patch.object(blocks, "fused_modconv3x3",
                               wraps=blocks.fused_modconv3x3) as k2, \
                mock.patch.object(blocks.fusion, "double_affine_leaky",
                                  wraps=blocks.fusion.double_affine_leaky
                                  ) as k1, torch.no_grad():
            out = gen(noise, sent)
        assert out.shape == (1, 32, 32, 3)
        assert k2.call_count == 2 * len(cfg.block_channels) == 8
        assert k1.call_count == 0
        assert sorted({c.args[5].shape[3] for c in k2.call_args_list}) == [
            32, 64, 128, 256]

    def test_rejects_bad_inputs(self):
        args = list(map(torch.from_numpy, _k2_inputs(2, 4, 4, 8, 64)))
        bad_w = args[:5] + [args[5][:, :, :4], args[6]]
        with pytest.raises(ValueError, match="w must be"):
            fused_modconv.fused_modconv3x3(*bad_w)
        bad_bias = args[:6] + [args[6][:3]]
        with pytest.raises(ValueError, match="bias"):
            fused_modconv.fused_modconv3x3(*bad_bias)
        with pytest.raises(TypeError, match="dtype"):
            fused_modconv.fused_modconv3x3(*args[:6], args[6].double())


class TestK2Layout:
    """The host side of the CUDA kernel: the tf32 operand split, the weight
    pack (the plain version of the pack kernel) and the tiling plan."""

    def test_tf32_split_rounds_as_cvt_rna(self):
        """hi = tf32(v) rounded to nearest, ties away from zero (10 mantissa
        bits, the 13 low bits 0); lo = tf32(v - hi); hi + lo is v within
        2^-22 relative."""
        rng = np.random.default_rng(4)
        v = (rng.standard_normal(4096)
             * 2.0 ** rng.integers(-20, 20, 4096)).astype(np.float32)
        ties = np.float32([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                           1 + 2 ** -11 - 2 ** -23, 0.0])
        v = np.concatenate([v, ties])
        hi, lo = fused_modconv.tf32_split(torch.from_numpy(v))
        hi, lo = hi.numpy(), lo.numpy()
        assert not (hi.view(np.uint32) & 0x1FFF).any()
        assert not (lo.view(np.uint32) & 0x1FFF).any()
        # the reference: 11 significant bits, half away from zero
        m, e = np.frexp(v.astype(np.float64))
        want = np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5)
                        / 2 ** 11, e)
        np.testing.assert_array_equal(hi, want.astype(np.float32))
        np.testing.assert_array_equal(
            hi[-5:], np.float32([1 + 2 ** -10, -(1 + 2 ** -10),
                                 1 + 2 ** -9, 1, 0]))
        err = np.abs(hi.astype(np.float64) + lo - v)
        assert (err <= 2.0 ** -22 * np.abs(v)).all()

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("dims", [(2, 8, 8, 20, 96), (8, 4, 4, 64, 288)])
    def test_pack_holds_each_weight_where_the_layout_says(self, dtype, dims):
        """[n tile][chunk][tap][k step][part][N / 8][2][8][kc / 2]: w of
        input channel (chunk * ks + k step) * kc + K column * kc / 2 + k and
        output channel n tile * N + 8 * (N / 8 index) + row; 0 past Cin and
        Cout; in fp32 the parts are the tf32 (hi, lo) split of w."""
        b, h, w, cin, cout = dims
        plan = fused_modconv._plan(b, h, w, cin, cout, dtype)
        wt = torch.from_numpy(_k2_inputs(1, 1, 1, cin, cout)[5]).to(dtype)
        # the HWIO view of an OIHW weight, as ops/blocks.py passes it
        wt = wt.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
        packed = fused_modconv.pack_weights(wt, plan)
        parts = (fused_modconv.tf32_split(wt) if dtype == torch.float32
                 else (wt,))
        assert packed.shape == (plan.n_tiles, plan.chunks, 9, plan.ks,
                                len(parts), plan.nt * 4, 2, 8, plan.kc // 2)
        idx = np.indices(packed.shape).reshape(9, -1)
        nt, ch, tap, q, p, nb, kb, r, k = idx
        ci = (ch * plan.ks + q) * plan.kc + kb * (plan.kc // 2) + k
        co = nt * plan.nt * 32 + nb * 8 + r
        inside = (ci < cin) & (co < cout)
        got = packed.reshape(-1)
        assert not got[torch.from_numpy(~inside)].any()
        want = torch.stack(parts)[p[inside], tap[inside] // 3,
                                  tap[inside] % 3, ci[inside], co[inside]]
        assert torch.equal(got[torch.from_numpy(inside)], want)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_plan_covers_k_and_n_and_fills_the_card(self, dtype):
        """At every DFBlock of the 256px generator, batch 8: the N tiles
        cover Cout, the splits cover the K chunks with none empty, and the
        grid has at least 132 blocks (one per SM) unless every chunk is a
        split of its own."""
        cfg = GeneratorConfig()
        for i, (cin, cout) in enumerate(cfg.block_channels):
            hw = cfg.base_size * 2 ** i
            for c in (cin, cout):
                p = fused_modconv._plan(8, hw, hw, c, cout, dtype)
                ntile = p.nt * fused_modconv.COUT_STEP
                assert p.n_tiles * ntile >= cout > (p.n_tiles - 1) * ntile
                assert p.chunks * p.ks * p.kc >= c
                assert p.splits * p.cps >= p.chunks > (p.splits - 1) * p.cps
                assert p.blocks >= 132 or p.cps == 1


def _jnp_bwd_math(x, g1, b1, g2, b2, dy):
    """dx and the forward's output by the math of the JAX package's
    `_vjp_bwd` (`_bwd_kernel`), op by op in jnp: the masks are 1 or
    NEG_SLOPE cast to x's dtype, so in bf16 the slope is bf16(0.2)."""
    g1, b1, g2, b2 = (v[:, None, None, :] for v in (g1, b1, g2, b2))
    y1 = g1 * x + b1
    m1 = jnp.where(y1.astype(jnp.float32) >= 0, 1.0,
                   jax_k1_neg_slope).astype(x.dtype)
    h = y1 * m1
    y2 = g2 * h + b2
    m2 = jnp.where(y2.astype(jnp.float32) >= 0, 1.0,
                   jax_k1_neg_slope).astype(x.dtype)
    dx = dy * m2 * g2 * m1 * g1
    return dx, y2 * m2


class TestSlope:
    """The LeakyReLU slope is 0.2 rounded to the compute dtype, as JAX
    rounds its weak-typed scalar: in bf16 0.2001953125. Held bit for bit
    against the jnp references in bf16 (the interpret-mode Pallas op rounds
    otherwise), and in fp32, where both slopes are 0.2f."""

    @pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
    def test_k1_forward_equals_the_jnp_reference(self, dtype):
        args = _k1_inputs((2, 8, 8, 64), seed=11)
        tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
        got = fused_affine.reference_double_affine_leaky(
            *(torch.from_numpy(a).to(tdt) for a in args))
        want = jax_k1_ref(*(jnp.asarray(a).astype(dtype) for a in args))
        assert torch.equal(got.float(),
                           torch.from_numpy(np.asarray(want, np.float32)))

    @pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
    def test_k1_backward_dx_and_z_equal_the_vjp_math(self, dtype):
        """dx and z bit for bit; the four [B, C] sums within 2^-6 max|ref|
        (bf16; fp32 1e-5): the port sums in fp32 and fp64, the TPU kernel
        in x's dtype."""
        args = _k1_inputs((2, 8, 8, 64), seed=12)
        dy = np.random.default_rng(13).standard_normal(
            (2, 8, 8, 64)).astype(np.float32)
        tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
        got = fused_affine.reference_double_affine_leaky_bwd(
            *(torch.from_numpy(a).to(tdt) for a in args + [dy]),
            want_z=True)
        jargs = [jnp.asarray(a).astype(dtype) for a in args + [dy]]
        dx, z = _jnp_bwd_math(*jargs)
        for g, w in ((got[0], dx), (got[5], z)):
            assert torch.equal(g.float(),
                               torch.from_numpy(np.array(w, np.float32)))
        want = jax_k1_vjp_bwd(tuple(jargs[:5]), jargs[5])
        for g, w in zip(got[1:5], want[1:]):
            w = np.array(w, np.float32)
            tol = (2.0 ** -6 * np.abs(w).max() if dtype == jnp.bfloat16
                   else 1e-5)
            np.testing.assert_allclose(g.float().numpy(), w, atol=tol,
                                       rtol=0)

    @pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
    def test_leaky_relu_and_its_gradient_equal_jax(self, dtype):
        """ops/nn.py::leaky_relu against gan_codes_tpu.ops.nn.leaky_relu and
        its jax.grad, bit for bit, inputs exactly 0 among them (slope 1
        there, where F.leaky_relu's gradient is 0.2)."""
        rng = np.random.default_rng(14)
        x = rng.standard_normal((4, 6, 6, 32)).astype(np.float32)
        x[0, 0, :, :8] = 0.0
        x[1, 2, :, :8] = -0.0
        r = rng.standard_normal(x.shape).astype(np.float32)
        tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
        xt = torch.from_numpy(x).to(tdt).requires_grad_()
        got = pnn.leaky_relu(xt)
        (got * torch.from_numpy(r).to(tdt)).sum().backward()
        jx, jr = jnp.asarray(x).astype(dtype), jnp.asarray(r).astype(dtype)
        want = jnn.leaky_relu(jx)
        want_grad = jax.grad(lambda v: jnp.sum(jnn.leaky_relu(v) * jr))(jx)
        for g, w in ((got, want), (xt.grad, want_grad)):
            assert torch.equal(g.detach().float(),
                               torch.from_numpy(np.array(w, np.float32)))
        assert torch.equal(xt.grad[0, 0, :, :8].float(),
                           torch.from_numpy(r[0, 0, :, :8]).to(tdt).float())

    def test_the_modules_in_sequentials_are_the_same_function(self):
        """The reference's nn.LeakyReLU(0.2) slots (state_dict indexes kept)
        hold ops/nn.py's LeakyReLU."""
        from gan_codes_tpu_torch.config import DiscriminatorConfig
        from gan_codes_tpu_torch.models.discriminator import Discriminator
        g = Generator(GeneratorConfig(n_channels=4, image_size=32))
        d = Discriminator(DiscriminatorConfig(n_channels=4, image_size=32))
        mods = [g.conv_out[0], d.img_sentence_forward[1]]
        for block in d.img_forward[1:]:
            mods += [block.residual_conv[1], block.residual_conv[3]]
        x = torch.randn(2, 3, 3, 5).bfloat16()
        for m in mods:
            assert isinstance(m, pnn.LeakyReLU)
            assert torch.equal(m(x), pnn.leaky_relu(x))
        assert "conv_out.1.weight" in g.state_dict()
        assert "img_sentence_forward.2.weight" in d.state_dict()
