"""The port's CUDA kernels against their plain PyTorch versions, on a card:
K1 forward and backward, K2 forward, and the gradients of both kernels'
autograd Functions against the plain versions' autograd.

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

from gan_codes_tpu_torch.ops.kernels import fused_affine, fused_modconv


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
