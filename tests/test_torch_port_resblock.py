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
        """The backward recomputes through K2's Function where it takes
        the DFBlock and K1 + a torch conv where it does not."""
        calls = []
        real_k2 = fr.fused_modconv.fused_modconv3x3
        real_k1 = fr.fused_affine.fused_double_affine_leaky
        monkeypatch.setattr(fr.fused_modconv, "fused_modconv3x3",
                            lambda *a: calls.append("k2") or real_k2(*a))
        monkeypatch.setattr(fr.fused_affine, "fused_double_affine_leaky",
                            lambda *a: calls.append("k1") or real_k1(*a))
        args = _inputs(b=1, h=4, w=4, cin=64, cout=32, shortcut=True, seed=8)
        ins = _torch(args, grad=True)
        fr.fused_resblock_g(*ins).sum().backward()
        # conv1 64 -> 32 and conv2 32 -> 32: Cout 32 is not K2's
        assert calls == ["k1", "k1"]
        calls.clear()
        args = _inputs(b=1, h=4, w=4, cin=64, cout=64, seed=8)
        ins = _torch(args, grad=True)
        fr.fused_resblock_g(*ins).sum().backward()
        assert calls == ["k2", "k2"]


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
