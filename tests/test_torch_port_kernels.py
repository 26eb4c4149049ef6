"""The port's kernel modules (gan_codes_tpu_torch/ops/kernels) held against
the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version; those run here
against the Pallas kernel (interpret mode, as tests/test_pallas.py runs it)
and against the JAX package's own plain reference, on the same numpy
inputs. The CUDA kernels themselves run only on a card:
tests/test_torch_port_cuda.py holds them against these plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_codes_tpu.ops.pallas.fused_affine import (
    fused_double_affine_leaky as jax_k1, reference_double_affine_leaky as
    jax_k1_ref)
from gan_codes_tpu.ops.pallas.fused_modconv import (
    _xla_composition as jax_k2_ref, fused_modconv3x3 as jax_k2)
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


class TestK2Plain:
    @pytest.mark.parametrize("dims", [
        (2, 16, 16, 8, 16),   # tests/test_pallas.py's forward shape
        (1, 128, 8, 4, 4),    # two row tiles of the Pallas kernel
        (2, 5, 7, 3, 64),     # odd spatial dims, a Cout the CUDA kernel takes
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
        # Cout % 64 only: no limit on batch, H, W or Cin to pass here
        assert fused_modconv._supported(torch.empty(3, 3, 32, 64))
        assert fused_modconv._supported(torch.empty(3, 3, 3, 256))
        assert not fused_modconv._supported(torch.empty(3, 3, 32, 32))

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
