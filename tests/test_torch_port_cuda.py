"""The port's CUDA kernels against their plain PyTorch versions, on a card.

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

    def test_k2_refuses_unsupported_cout(self, cuda):
        args = [torch.from_numpy(a).to(cuda)
                for a in _k2_inputs(1, 4, 4, 8, 32)]
        with pytest.raises(ValueError, match="Cout"):
            fused_modconv.fused_modconv3x3(*args)
