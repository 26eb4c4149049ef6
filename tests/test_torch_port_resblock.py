"""The port's K3 module (gan_codes_tpu_torch/ops/kernels/fused_resblock.py)
held against the JAX package's Pallas `fused_resblock_g`.

On the CPU the wrapper takes its plain PyTorch version and its backward
recomputes through the DFBlock ops' plain versions; both run here against
the Pallas kernel (interpret mode, as tests/test_pallas.py::
TestFusedResBlock runs it) and the JAX package's `_xla_composition`, on the
same numpy inputs. The CUDA kernel runs only on a card:
tests/test_torch_port_cuda.py holds it against the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_codes_tpu.ops.pallas import fused_resblock as jfr
from gan_codes_tpu_torch.config import GeneratorConfig
from gan_codes_tpu_torch.ops import blocks
from gan_codes_tpu_torch.ops.fusion import affine_params
from gan_codes_tpu_torch.ops.kernels import fused_resblock as fr
from torch_port_env import one_thread_children  # noqa: E402,F401

# tests/test_pallas.py::TestFusedResBlock's three forward cases
CASES = [dict(h=8, w=8, cin=16, cout=16, shortcut=False),
         dict(h=16, w=16, cin=32, cout=16, shortcut=True),
         dict(h=8, w=12, cin=16, cout=8, shortcut=True)]


def _inputs(b=2, h=8, w=8, cin=16, cout=16, shortcut=False, seed=3):
    """The 16 inputs as float32 numpy arrays (ws, cs None without a
    shortcut), at TestFusedResBlock's scales."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = n(b, h, w, cin)
    vin = [n(b, cin, scale=0.5) for _ in range(4)]
    w1, c1 = n(3, 3, cin, cout, scale=0.05), n(cout, scale=0.1)
    vout = [n(b, cout, scale=0.5) for _ in range(4)]
    w2, c2 = n(3, 3, cout, cout, scale=0.05), n(cout, scale=0.1)
    gamma = np.asarray(0.7, np.float32)
    ws = n(1, 1, cin, cout, scale=0.1) if shortcut else None
    cs = n(cout, scale=0.1) if shortcut else None
    return [x, *vin, w1, c1, *vout, w2, c2, gamma, ws, cs]


def _torch(args, grad=False):
    return [None if a is None else
            torch.from_numpy(np.array(a)).requires_grad_(grad) for a in args]


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


class TestForward:
    @pytest.mark.parametrize("case", CASES)
    def test_matches_jax_kernel_and_composition(self, case):
        args = _inputs(**case)
        want_kernel = np.asarray(jfr.fused_resblock_g(*_jax(args)))
        want_xla = np.asarray(jfr._xla_composition(*_jax(args)))
        got_ref = fr.reference_resblock_g(*_torch(args)).numpy()
        got = fr.fused_resblock_g(*_torch(args)).numpy()
        assert got.shape == want_kernel.shape
        for want in (want_kernel, want_xla):
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
            np.testing.assert_allclose(got_ref, want, atol=2e-4, rtol=0)

    def test_cpu_wrapper_is_the_plain_version_and_counts_nothing(self):
        args = _torch(_inputs(**CASES[1], seed=4))
        before = fr.fused_resblock_g.launches
        got = fr.fused_resblock_g(*args)
        assert torch.equal(got, fr.reference_resblock_g(*args))
        assert fr.fused_resblock_g.launches == before

    def test_gamma_zero_gives_the_shortcut(self):
        args = _torch(_inputs(**CASES[1], seed=5))
        args[13] = torch.zeros(1)
        x, ws, cs = args[0], args[14], args[15]
        want = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), ws.permute(3, 2, 0, 1)).permute(
                0, 2, 3, 1) + cs
        torch.testing.assert_close(fr.fused_resblock_g(*args), want,
                                   atol=1e-6, rtol=0)


class TestGradients:
    @pytest.mark.parametrize("shortcut", [False, True])
    def test_all_16_inputs_match_jax_grad_of_the_pallas_op(self, shortcut):
        """d/d(all inputs) of sum(out * r) against jax.grad of the Pallas
        op (whose VJP is the composition's): rtol 1e-4, atol 1e-4."""
        case = dict(h=8, w=8, cin=16, cout=16 if not shortcut else 8,
                    shortcut=shortcut)
        args = _inputs(**case, seed=6)
        r = np.random.default_rng(7).standard_normal(
            (2, 8, 8, case["cout"])).astype(np.float32)
        argnums = tuple(i for i, a in enumerate(args) if a is not None)

        def loss(*a):
            return jnp.sum(jfr.fused_resblock_g(*a) * r)

        want = jax.grad(loss, argnums)(*_jax(args))
        ins = _torch(args, grad=True)
        out = fr.fused_resblock_g(*ins)
        (out * torch.from_numpy(r)).sum().backward()
        assert len(want) == (16 if shortcut else 14)
        for i, w in zip(argnums, want):
            got = ins[i].grad
            assert got is not None and got.shape == ins[i].shape, i
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       atol=1e-4, rtol=1e-4,
                                       err_msg=fr._NAMES[i])

    def test_backward_runs_the_dfblock_ops(self, monkeypatch):
        """The backward recomputes every DFBlock through K1 + a torch conv,
        whether or not K2 takes it (the JAX VJP's plain composition)."""
        calls = []
        real_k2 = fr.fused_modconv.fused_modconv3x3
        real_k1 = fr.fused_affine.fused_double_affine_leaky
        monkeypatch.setattr(fr.fused_modconv, "fused_modconv3x3",
                            lambda *a: calls.append("k2") or real_k2(*a))
        monkeypatch.setattr(fr.fused_affine, "fused_double_affine_leaky",
                            lambda *a: calls.append("k1") or real_k1(*a))
        args = _inputs(b=1, h=4, w=4, cin=64, cout=48, shortcut=True, seed=8)
        ins = _torch(args, grad=True)
        fr.fused_resblock_g(*ins).sum().backward()
        # conv1 64 -> 48 and conv2 48 -> 48: Cout 48 is not K2's
        assert calls == ["k1", "k1"]
        for cout in (32, 64):  # Cout % 32 == 0: K2's, not in the backward
            calls.clear()
            args = _inputs(b=1, h=4, w=4, cin=64, cout=cout,
                           shortcut=cout != 64, seed=8)
            ins = _torch(args, grad=True)
            fr.fused_resblock_g(*ins).sum().backward()
            assert calls == ["k1", "k1"]


class TestAgainstResidualBlockG:
    @pytest.mark.parametrize("cin,cout", [(16, 8), (16, 16)])
    def test_equals_res_block_g(self, cin, cout):
        """Fed a ResidualBlockG's parameters, K3 computes the port's
        res_block_g (the counterpart of TestFusedResBlock::
        test_equals_res_block_g_op)."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(5)
            block = blocks.ResidualBlockG(cin, cout, sentence_dim=12,
                                          affine_hidden=10)
        with torch.no_grad():
            block.gamma.fill_(0.6)
        rng = np.random.default_rng(9)
        x = torch.from_numpy(rng.standard_normal((2, 8, 8, cin)).astype(
            np.float32))
        sent = torch.from_numpy(rng.standard_normal((2, 12)).astype(
            np.float32))
        with torch.no_grad():
            want = blocks.res_block_g(block, x, sent)
            vecs = [v for fb in (block.fusion_block_1, block.fusion_block_2,
                                 block.fusion_block_3, block.fusion_block_4)
                    for v in affine_params(fb, sent)]
            hwio = lambda conv: conv.weight.permute(2, 3, 1, 0)
            sc = block.scale_conv
            got = fr.fused_resblock_g(
                x, *vecs[:4], hwio(block.conv_1), block.conv_1.bias,
                *vecs[4:], hwio(block.conv_2), block.conv_2.bias,
                block.gamma, None if sc is None else hwio(sc),
                None if sc is None else sc.bias)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                                   rtol=0)


class TestShapes:
    @pytest.mark.parametrize("image_size", [32, 64, 128, 256])
    def test_takes_every_block_of_the_generator_ladders(self, image_size):
        cfg = GeneratorConfig(image_size=image_size)
        for cin, cout in cfg.block_channels:
            assert fr._supported(torch.empty(3, 3, cin, cout,
                                             device="meta"))

    @pytest.mark.parametrize("cout", [8, 48, 288, 512])
    def test_declines_by_cout_alone(self, cout):
        assert not fr._supported(torch.empty(3, 3, 64, cout, device="meta"))

    def test_rejects_bad_inputs(self):
        args = _torch(_inputs(**CASES[1]))
        with pytest.raises(ValueError, match="ws and cs"):
            fr.fused_resblock_g(*args[:15], None)
        with pytest.raises(ValueError, match="identity shortcut"):
            fr.fused_resblock_g(*args[:14], None, None)
        bad = list(args)
        bad[7] = bad[7][:1]
        with pytest.raises(ValueError, match="g3"):
            fr.fused_resblock_g(*bad)
        bad = list(args)
        bad[11] = bad[11].double()
        with pytest.raises(TypeError, match="w2"):
            fr.fused_resblock_g(*bad)
        bad = list(args)
        bad[13] = torch.ones(2)
        with pytest.raises(ValueError, match="gamma"):
            fr.fused_resblock_g(*bad)


def _ladder(image_size):
    cfg = GeneratorConfig(image_size=image_size)
    return [(cfg.base_size * 2 ** i, cin, cout)
            for i, (cin, cout) in enumerate(cfg.block_channels)]


class TestPlan:
    """K3's `_plan` at every block of the 32-256px generators (n_channels
    32), in both dtypes, at batch 8 and at an odd batch that breaks the
    sample stacking."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("image_size", [32, 64, 128, 256])
    def test_tiles_cover_each_pixel_once_within_shared_memory(
            self, dtype, image_size):
        for batch in (8, 5):
            for hw, cin, cout in _ladder(image_size):
                p = fr._plan(batch, hw, hw, cin, cout, dtype, cin != cout)
                assert p.smem <= fr.SMEM_LIMIT
                assert 9 <= p.stages <= fr.MAX_STAGES
                assert p.n_tiles * p.nt * 32 == cout
                assert p.ch1 * p.ks * p.kc >= cin
                assert p.ch2 * p.ks * p.kc >= cout
                rs = batch * (hw + 1) - 1  # stacked rows, a gap row apart
                assert (p.tiles_h - 1) * p.th < rs <= p.tiles_h * p.th
                assert (p.tiles_w - 1) * p.tw < hw <= p.tiles_w * p.tw
                covered = np.zeros((batch, hw, hw), np.int64)
                for tr in range(p.tiles_h):
                    rows = np.arange(tr * p.th, min((tr + 1) * p.th, rs))
                    rows = rows[rows % (hw + 1) != hw]
                    for tc in range(p.tiles_w):
                        covered[rows // (hw + 1), rows % (hw + 1),
                                tc * p.tw:(tc + 1) * p.tw] += 1
                assert (covered == 1).all()

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("image_size", [32, 256])
    def test_flat_rows_reach_the_tile_and_its_halo(self, dtype, image_size):
        """Conv1's M rows (pitch p1 = tw + 4 over the x halo) cover h1 on
        the tile and its 1-pixel halo, conv2's (pitch p2 = tw + 2 over h1)
        the tile, and each 3x3 tap of a flat row is the 2-D neighbour: row
        m of a pitch-p grid is (m // p, m % p), tap (dy, dx) reads m + dy *
        p + dx = (m // p + dy, m % p + dx) for the kept columns. A pass's
        A buffer holds its 128 rows and the largest tap shift."""
        for hw, cin, cout in _ladder(image_size):
            p = fr._plan(8, hw, hw, cin, cout, dtype, cin != cout)
            p1, p2, m1, m2, apix, hpix = fr._geometry(p.th, p.tw)
            assert (m1, m2) == (p.m1, p.m2) and hpix == (p.th + 2) * p2
            for pitch, m_tiles, rows, cols in ((p1, m1, p.th + 2, p.tw + 2),
                                               (p2, m2, p.th, p.tw)):
                kept = [r * pitch + c for r in range(rows)
                        for c in range(cols)]
                assert max(kept) < m_tiles * 64
                for m in kept:
                    for dy in range(3):
                        for dx in range(3):
                            q = m + dy * pitch + dx
                            assert divmod(q, pitch) == (m // pitch + dy,
                                                        m % pitch + dx)
                            assert q - (m // 128) * 128 < apix
            assert apix == 128 + 2 * p1 + 2

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_a_1x1_shortcut_at_cin_equal_cout_is_planned_as_one(self, dtype):
        """The plan follows ws, not Cin != Cout: a block with a 1x1 shortcut
        and Cin == Cout gets the N tile that leaves the shortcut's sums
        their registers (the kernel has no wider instantiation)."""
        p = fr._plan(8, 16, 16, 128, 128, dtype, True)
        assert p.nt <= fr.MAX_NT[(dtype, True)] < fr.MAX_NT[(dtype, False)]
        assert p.scratch_bytes > fr._plan(8, 16, 16, 128, 128, dtype,
                                          False).scratch_bytes

    def test_conv1_share_where_shared_memory_allows(self):
        """Conv1's M rows over the output pixels stay at or below the
        direct-conv K3's 1.5625 at the 64-256px blocks of the 256px
        generator (Cout <= 128), in both dtypes."""
        for dtype in (torch.float32, torch.bfloat16):
            for hw, cin, cout in _ladder(256):
                if hw >= 64:
                    p = fr._plan(8, hw, hw, cin, cout, dtype, cin != cout)
                    assert p.conv1_share <= fr.CONV1_SHARE, (hw, dtype, p)


class TestPack:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("dims", [(8, 64, 64, 256, 128),
                                      (8, 16, 16, 256, 256)])
    def test_w1_w2_ws_equal_a_plain_packing(self, dtype, dims):
        """K2's pack with K3's plan: w1, w2 (3x3) and ws (1x1, one tap) hold
        each weight where the stages' layout says, [n tile][chunk][tap][k
        step][part][N / 8][2][8][kc / 2] (input channel (chunk * ks + k
        step) * kc + K column * kc / 2 + k, output channel n tile * N +
        8 * block + row, 0 past the channels; fp32's parts the tf32 split),
        and they fill `scratch_bytes` (ws only with the 1x1 shortcut)."""
        b, h, w, cin, cout = dims
        plan = fr._plan(b, h, w, cin, cout, dtype, cin != cout)
        rng = np.random.default_rng(3)
        total = 0
        weights = [(3, cin), (3, cout)] + ([(1, cin)] if cin != cout
                                           else [])
        for kh, ci in weights:
            wt = torch.from_numpy(rng.standard_normal(
                (kh, kh, ci, cout)).astype(np.float32)).to(dtype)
            chunks = plan.ch1 if ci == cin else plan.ch2
            # K2's pack plan for this weight, as csrc/fused_resblock.cu
            # calls the pack kernel
            packed = fr.fused_modconv.pack_weights(wt, fr.fused_modconv.Plan(
                plan.kc, plan.ks, chunks, plan.nt, plan.n_tiles, chunks, 1,
                0))
            parts = (fr.fused_modconv.tf32_split(wt)
                     if dtype == torch.float32 else (wt,))
            assert packed.shape == (plan.n_tiles, chunks, kh * kh, plan.ks,
                                    len(parts), plan.nt * 4, 2, 8,
                                    plan.kc // 2)
            want = torch.zeros(packed.shape, dtype=dtype)
            for n in range(plan.n_tiles):
                for c in range(chunks):
                    for q in range(plan.ks):
                        for kb in range(2):
                            c0 = ((c * plan.ks + q) * plan.kc
                                  + kb * (plan.kc // 2))
                            cs = slice(c0, min(c0 + plan.kc // 2, ci))
                            if c0 >= ci:
                                continue
                            for i, part in enumerate(parts):
                                blk = part[:, :, cs,
                                           n * plan.nt * 32:
                                           (n + 1) * plan.nt * 32]
                                # [kh, kw, k, N] -> [tap, N/8, 8, k]
                                blk = blk.reshape(kh * kh, -1, plan.nt * 4,
                                                  8).permute(0, 2, 3, 1)
                                want[n, c, :, q, i, :, kb, :,
                                     :blk.shape[-1]] = blk
            assert torch.equal(packed, want)
            total += -(-packed.numel() * packed.element_size() // 256) * 256
        assert total == plan.scratch_bytes
