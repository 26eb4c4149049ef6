"""The port's CUDA kernels against their plain PyTorch versions, on a card:
K1 forward and backward, K2 forward, K3 forward, and the gradients of the
kernels' autograd Functions against the plain versions' autograd.

Every test here is marked `cuda` and skips without a CUDA device. On a
machine with one (and nvcc), with or without JAX installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(`--noconftest`: tests/conftest.py configures JAX, which this file does not
use.) The CPU parity of the plain versions with the JAX package's kernels is
in tests/test_torch_port_kernels.py.
"""
import numpy as np
import pytest
import torch

from gan_codes_tpu_torch.ops.kernels import (fused_affine, fused_modconv,
                                             fused_resblock)


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


def _k3_inputs(b, h, w, cin, cout, shortcut, seed=0):
    """The 16 inputs of K3 (ws, cs None without a shortcut), weights at
    the scale of torch's conv init."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = n(b, h, w, cin)
    vin = [n(b, cin, scale=0.5) for _ in range(4)]
    vout = [n(b, cout, scale=0.5) for _ in range(4)]
    w1, c1 = n(3, 3, cin, cout, scale=(9 * cin) ** -0.5), n(cout, scale=0.1)
    w2, c2 = n(3, 3, cout, cout, scale=(9 * cout) ** -0.5), n(cout,
                                                               scale=0.1)
    ws = n(1, 1, cin, cout, scale=cin ** -0.5) if shortcut else None
    cs = n(cout, scale=0.1) if shortcut else None
    return [x, *vin, w1, c1, *vout, w2, c2, np.float32([0.7]), ws, cs]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to build and launch the "
                    "kernel")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    """The CUDA kernels against their plain versions on the card."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [(2, 16, 16, 64), (3, 5, 7, 6)])
    def test_k1(self, cuda, dtype, shape):
        args = [torch.from_numpy(a).to(cuda, dtype)
                for a in _k1_inputs(shape)]
        before = fused_affine.fused_double_affine_leaky.launches
        got = fused_affine.fused_double_affine_leaky(*args)
        want = fused_affine.reference_double_affine_leaky(*args)
        torch.cuda.synchronize()
        assert fused_affine.fused_double_affine_leaky.launches == before + 1
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("dims", [(2, 16, 16, 32, 64),
                                      (1, 5, 7, 3, 128)])
    def test_k2(self, cuda, dtype, dims):
        args = [torch.from_numpy(a).to(cuda, dtype)
                for a in _k2_inputs(*dims)]
        before = fused_modconv.fused_modconv3x3.launches
        got = fused_modconv.fused_modconv3x3(*args)
        want = fused_modconv.reference_modconv3x3(*args)
        torch.cuda.synchronize()
        assert fused_modconv.fused_modconv3x3.launches == before + 1
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        else:
            err = (got.float() - want.float()).abs().max().item()
            assert err <= 2.0 ** -6 * want.float().abs().max().item()

    def test_k2_takes_a_batch_above_65535(self, cuda):
        args = [torch.from_numpy(a).to(cuda)
                for a in _k2_inputs(70000, 2, 3, 4, 64)]
        got = fused_modconv.fused_modconv3x3(*args)
        want = fused_modconv.reference_modconv3x3(*args)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [(2, 48, 48, 8), (3, 5, 7, 6),
                                       (2, 16, 16, 256), (1, 3, 5, 2048)])
    def test_k1_bwd(self, cuda, dtype, shape):
        """Many pixel tiles, the scalar path (C = 6), the vector path, and
        more channel vectors than threads (C = 2048 fp32). dx rounds where
        the plain version rounds; the four sums add in another order:
        fp32 dx allclose 1e-6, sums 1e-4; bf16 dx <= 2^-7 max|ref|, sums
        <= 2^-6 max|ref|. The result repeats bit for bit."""
        x, *vecs = [torch.from_numpy(a).to(cuda, dtype)
                    for a in _k1_inputs(shape)]
        x[:, ::2] = 0  # exact zeros in y1 and y2 where b1 = b2 = 0
        vecs[1][:, ::2] = 0
        vecs[3][:, ::2] = 0
        dy = torch.randn(shape, device=cuda).to(dtype)
        before = fused_affine.fused_double_affine_leaky_bwd.launches
        got = fused_affine.fused_double_affine_leaky_bwd(x, *vecs, dy)
        again = fused_affine.fused_double_affine_leaky_bwd(x, *vecs, dy)
        want = fused_affine.reference_double_affine_leaky_bwd(x, *vecs, dy)
        torch.cuda.synchronize()
        assert fused_affine.fused_double_affine_leaky_bwd.launches \
            == before + 2
        for i, (g, a, w) in enumerate(zip(got, again, want)):
            assert torch.equal(g, a)
            if dtype == torch.float32:
                tol = 1e-6 if i == 0 else 1e-4
                torch.testing.assert_close(g, w, atol=tol, rtol=tol)
            else:
                err = (g.float() - w.float()).abs().max().item()
                top = w.float().abs().max().item()
                assert err <= 2.0 ** (-7 if i == 0 else -6) * top

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("kernel", ["k1", "k2"])
    def test_gradients_reach_the_inputs(self, cuda, dtype, kernel):
        """Inputs that require grad give an output with a grad_fn; one
        backward launches K1 bwd once (and, for K2, K1's forward once to
        recompute h); the gradients match the plain versions' autograd:
        fp32 (TF32 off) allclose 1e-4, bf16 max|err| <= 2^-6 max|ref|."""
        if kernel == "k1":
            arrays = _k1_inputs((2, 16, 16, 64))
            fn = fused_affine.fused_double_affine_leaky
            ref = fused_affine.reference_double_affine_leaky
        else:
            arrays = _k2_inputs(2, 16, 16, 32, 64)
            fn = fused_modconv.fused_modconv3x3
            ref = fused_modconv.reference_modconv3x3
        ins = [torch.from_numpy(a).to(cuda, dtype).requires_grad_()
               for a in arrays]
        ref_ins = [t.detach().clone().requires_grad_() for t in ins]
        k1, k1_bwd = (fused_affine.fused_double_affine_leaky,
                      fused_affine.fused_double_affine_leaky_bwd)
        k2 = fused_modconv.fused_modconv3x3
        counts = [k1.launches, k1_bwd.launches, k2.launches]
        out = fn(*ins)
        assert out.grad_fn is not None
        r = torch.randn(out.shape, device=cuda).to(dtype)
        (out * r).sum().backward()
        (ref(*ref_ins) * r).sum().backward()
        torch.cuda.synchronize()
        moved = [k1.launches - counts[0], k1_bwd.launches - counts[1],
                 k2.launches - counts[2]]
        assert moved == ([1, 1, 0] if kernel == "k1" else [1, 1, 1])
        for t, w in zip(ins, ref_ins):
            if dtype == torch.float32:
                torch.testing.assert_close(t.grad, w.grad, atol=1e-4,
                                           rtol=1e-4)
            else:
                err = (t.grad.float() - w.grad.float()).abs().max().item()
                assert err <= 2.0 ** -6 * w.grad.float().abs().max().item()

    def test_k2_refuses_unsupported_cout(self, cuda):
        args = [torch.from_numpy(a).to(cuda)
                for a in _k2_inputs(1, 4, 4, 8, 32)]
        with pytest.raises(ValueError, match="Cout"):
            fused_modconv.fused_modconv3x3(*args)


@pytest.mark.cuda
class TestResBlockOnCard:
    """K3 against its plain version, and its backward against the plain
    composition's autograd, on the card."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("dims", [(2, 4, 4, 256, 256, False),
                                      (2, 19, 21, 64, 32, True),
                                      (1, 24, 40, 36, 64, True)])
    def test_k3(self, cuda, dtype, dims):
        """A 4x4 map inside one tile (identity shortcut), ragged tiles with
        the Cout-32 chunking, and a Cin (36) that is not a multiple of the
        8-channel chunk: fp32 (TF32 off) allclose 2e-4; bf16 max|err| <= 2^-5 max|ref| (two
        chained bf16 convs, each may flip one ulp)."""
        args = [None if a is None else torch.from_numpy(a).to(cuda, dtype)
                for a in _k3_inputs(*dims)]
        before = fused_resblock.fused_resblock_g.launches
        got = fused_resblock.fused_resblock_g(*args)
        want = fused_resblock.reference_resblock_g(*args)
        torch.cuda.synchronize()
        assert fused_resblock.fused_resblock_g.launches == before + 1
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
        else:
            err = (got.float() - want.float()).abs().max().item()
            assert err <= 2.0 ** -5 * want.float().abs().max().item()

    @pytest.mark.parametrize("image_size", [32, 64, 128])
    def test_k3_takes_the_short_ladders(self, cuda, image_size):
        """Every block of the 32/64/128px generators (n_channels 32),
        batch 2, fp32: allclose 2e-4."""
        from gan_codes_tpu_torch.config import GeneratorConfig
        gcfg = GeneratorConfig(image_size=image_size)
        for i, (cin, cout) in enumerate(gcfg.block_channels):
            hw = gcfg.base_size * 2 ** i
            args = [None if a is None else torch.from_numpy(a).to(cuda)
                    for a in _k3_inputs(2, hw, hw, cin, cout, cin != cout,
                                        seed=i)]
            got = fused_resblock.fused_resblock_g(*args)
            want = fused_resblock.reference_resblock_g(*args)
            torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)

    @pytest.mark.parametrize("shortcut", [False, True])
    def test_k3_backward(self, cuda, shortcut):
        """All 16 (or 14) input gradients through the Function (K2, or K1
        and cuDNN, K1 bwd) against the plain composition's autograd, fp32:
        max|err| <= 1e-3 max|ref| per input."""
        cin, cout = (64, 64) if not shortcut else (64, 32)
        arrays = _k3_inputs(2, 16, 16, cin, cout, shortcut, seed=1)
        ins = [None if a is None else
               torch.from_numpy(a).to(cuda).requires_grad_()
               for a in arrays]
        ref_ins = [None if t is None else t.detach().clone().requires_grad_()
                   for t in ins]
        out = fused_resblock.fused_resblock_g(*ins)
        assert out.grad_fn is not None
        r = torch.randn(out.shape, device=cuda)
        k1_bwd = fused_affine.fused_double_affine_leaky_bwd.launches
        (out * r).sum().backward()
        (fused_resblock.reference_resblock_g(*ref_ins) * r).sum().backward()
        torch.cuda.synchronize()
        assert fused_affine.fused_double_affine_leaky_bwd.launches \
            == k1_bwd + 2
        for t, w in zip(ins, ref_ins):
            if t is None:
                continue
            err = (t.grad - w.grad).abs().max().item()
            assert err <= 1e-3 * w.grad.abs().max().item()

    def test_k3_refuses_unsupported_cout(self, cuda):
        args = [None if a is None else torch.from_numpy(a).to(cuda)
                for a in _k3_inputs(1, 4, 4, 16, 48, True)]
        with pytest.raises(ValueError, match="Cout"):
            fused_resblock.fused_resblock_g(*args)
