"""The port's CUDA kernels against their plain PyTorch versions, on a card:
K1 forward and backward (one launch, with z), K2 forward and its weight
pack, K3 forward (one kernel, bit for bit on a repeat), the one-pass TF32
mode of K2 and K3 (the process's precision at "high"), and the gradients
of the kernels' autograd Functions against the plain versions' autograd.
Also DF-GAN's MA-GP through `ops_nn.PenaltyConv2d` against autograd's own
double backward at the training cells' shapes.

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
from gan_codes_tpu_torch.utils import device as pdevice
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


@pytest.fixture
def one_pass(cuda):
    """The card with the process's fp32 precision at "high" (one TF32
    product in K2 and K3), restored after the test."""
    previous = pdevice.set_matmul_precision("high")
    yield cuda
    pdevice.set_matmul_precision(previous)


def _fp32(fn):
    """fn() at the precision "highest" (TF32 off in cuDNN too), then the
    precision back."""
    previous = pdevice.set_matmul_precision("highest")
    try:
        return fn()
    finally:
        pdevice.set_matmul_precision(previous)


def _gaps(got, want, full):
    """max|got - want| and max|got - full| (float64)."""
    return ((got.double() - want.double()).abs().max().item(),
            (got.double() - full.double()).abs().max().item())


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
                                      (1, 5, 7, 3, 128),
                                      (2, 24, 20, 64, 32),
                                      (8, 4, 4, 256, 256),
                                      (3, 9, 10, 20, 320)])
    def test_k2(self, cuda, dtype, dims):
        """Several tiles and chunks; ragged 5x7 with Cin 3 (element loads,
        a zero-filled K tail); Cout 32 (one n32 tile); a 4x4 map at batch 8
        (M tiles across samples, split K); Cout 320 (two N tiles, the
        second part empty) over a Cin of 20. fp32 (3xTF32, TF32 off)
        allclose 1e-4; bf16 max|err| <= 2^-6 max|ref|. A second call gives
        the same result bit for bit."""
        args = [torch.from_numpy(a).to(cuda, dtype)
                for a in _k2_inputs(*dims)]
        before = fused_modconv.fused_modconv3x3.launches
        got = fused_modconv.fused_modconv3x3(*args)
        again = fused_modconv.fused_modconv3x3(*args)
        want = fused_modconv.reference_modconv3x3(*args)
        torch.cuda.synchronize()
        assert fused_modconv.fused_modconv3x3.launches == before + 2
        assert torch.equal(got, again)
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
                                       (2, 16, 16, 256), (1, 3, 5, 2048),
                                       (2, 64, 64, 32), (8, 16, 16, 2048)])
    def test_k1_bwd(self, cuda, dtype, shape):
        """Clusters of several blocks, the scalar path (C = 6), the vector
        path, more channel vectors than a block row (C = 2048, several
        channel chunks), and a pixel split that spans a full cluster of 16
        blocks ([2, 64, 64, 32]). dx rounds where the plain version
        rounds; the four sums add in another order: fp32 dx allclose 1e-6,
        sums 1e-4; bf16 dx <= 2^-7 max|ref|, sums <= 2^-6 max|ref|. The
        result repeats bit for bit, and z equals K1's forward bit for
        bit."""
        x, *vecs = [torch.from_numpy(a).to(cuda, dtype)
                    for a in _k1_inputs(shape)]
        x[:, ::2] = 0  # exact zeros in y1 and y2 where b1 = b2 = 0
        vecs[1][:, ::2] = 0
        vecs[3][:, ::2] = 0
        dy = torch.randn(shape, device=cuda).to(dtype)
        if shape == (2, 64, 64, 32):
            assert fused_affine._plan(2, 64 * 64, 32, dtype).split == 16
        before = fused_affine.fused_double_affine_leaky_bwd.launches
        got = fused_affine.fused_double_affine_leaky_bwd(x, *vecs, dy)
        again = fused_affine.fused_double_affine_leaky_bwd(x, *vecs, dy,
                                                           want_z=True)
        want = fused_affine.reference_double_affine_leaky_bwd(x, *vecs, dy)
        fwd = fused_affine.fused_double_affine_leaky(x, *vecs)
        torch.cuda.synchronize()
        assert fused_affine.fused_double_affine_leaky_bwd.launches \
            == before + 2
        assert torch.equal(again[5], fwd)
        for i, (g, a, w) in enumerate(zip(got, again, want)):
            assert torch.equal(g, a)
            if dtype == torch.float32:
                tol = 1e-6 if i == 0 else 1e-4
                torch.testing.assert_close(g, w, atol=tol, rtol=tol)
            else:
                err = (g.float() - w.float()).abs().max().item()
                top = w.float().abs().max().item()
                assert err <= 2.0 ** (-7 if i == 0 else -6) * top

    @pytest.mark.parametrize("want_z", [False, True])
    def test_k1_bwd_is_one_kernel_and_no_scratch(self, cuda, want_z):
        """One call of K1 bwd is one CUDA kernel in a torch.profiler trace,
        and allocates only its outputs: dx, the [4, B, C] gradients, and z
        where it is asked for."""
        from torch.profiler import ProfilerActivity, profile

        x, *vecs = [torch.from_numpy(a).to(cuda)
                    for a in _k1_inputs((8, 32, 32, 256))]
        dy = torch.randn_like(x)
        fused_affine.fused_double_affine_leaky_bwd(x, *vecs, dy,
                                                   want_z=want_z)
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fused_affine.fused_double_affine_leaky_bwd(
                x, *vecs, dy, want_z=want_z)
            torch.cuda.synchronize()
        made = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and "fused_affine_bwd" in kernels[0]
        assert made == (3 if want_z else 2)
        assert len(out) == (6 if want_z else 5)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("kernel", ["k1", "k2"])
    def test_gradients_reach_the_inputs(self, cuda, dtype, kernel):
        """Inputs that require grad give an output with a grad_fn; one
        backward launches K1 bwd once (for K2, with z, and no K1 forward:
        K1 bwd's z is h for the weight gradient); the gradients match the
        plain versions' autograd:
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
        assert moved == ([1, 1, 0] if kernel == "k1" else [0, 1, 1])
        for t, w in zip(ins, ref_ins):
            if dtype == torch.float32:
                torch.testing.assert_close(t.grad, w.grad, atol=1e-4,
                                           rtol=1e-4)
            else:
                err = (t.grad.float() - w.grad.float()).abs().max().item()
                assert err <= 2.0 ** -6 * w.grad.float().abs().max().item()

    def test_k2_refuses_unsupported_cout(self, cuda):
        args = [torch.from_numpy(a).to(cuda)
                for a in _k2_inputs(1, 4, 4, 8, 48)]
        with pytest.raises(ValueError, match="Cout"):
            fused_modconv.fused_modconv3x3(*args)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("dims", [(2, 8, 8, 20, 96), (8, 4, 4, 64, 288),
                                      (1, 64, 64, 64, 32)])
    def test_k2_weight_pack(self, cuda, dtype, dims):
        """The pack kernel, reading the HWIO view of an OIHW weight at its
        strides, against its plain version bit for bit (with the tf32
        split in fp32)."""
        plan = fused_modconv._plan(*dims, dtype)
        w = torch.from_numpy(_k2_inputs(1, 1, 1, *dims[3:])[5]).to(dtype)
        w = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
        got = fused_modconv.pack_weights(w.to(cuda), plan)
        want = fused_modconv.pack_weights(w, plan)
        assert torch.equal(got.cpu(), want)

    @pytest.mark.parametrize("dims", [(2, 16, 16, 32, 64),
                                      (1, 5, 7, 3, 128),
                                      (8, 4, 4, 256, 256)])
    def test_k2_one_pass_tf32(self, one_pass, dims):
        """One TF32 product per product, against the plain version of that
        mode (both operands rounded to TF32, so the products are exact and
        only the sums' order differs): allclose 1e-4, as 3xTF32 against
        fp32; further from the fp32 plain version than from it; a second
        call bit for bit."""
        args = [torch.from_numpy(a).to(one_pass) for a in _k2_inputs(*dims)]
        assert fused_modconv.one_pass_tf32()
        got = fused_modconv.fused_modconv3x3(*args)
        again = fused_modconv.fused_modconv3x3(*args)
        want = fused_modconv.reference_modconv3x3(*args, tf32=True)
        full = _fp32(lambda: fused_modconv.reference_modconv3x3(*args))
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        to_tf32, to_fp32 = _gaps(got, want, full)
        assert to_fp32 > to_tf32, (to_tf32, to_fp32)

    @pytest.mark.parametrize("dims", [(2, 8, 8, 20, 96), (8, 4, 4, 64, 288)])
    def test_k2_one_pass_weight_pack(self, cuda, dims):
        """The one-pass pack kernel writes the hi plane of the 3xTF32 pack
        bit for bit (its lo plane is left unwritten)."""
        plan = fused_modconv._plan(*dims, torch.float32)
        w = torch.from_numpy(_k2_inputs(1, 1, 1, *dims[3:])[5])
        got = fused_modconv.pack_weights(w.to(cuda), plan, one_pass=True)
        want = fused_modconv.pack_weights(w, plan)
        assert torch.equal(got.cpu()[:, :, :, :, 0], want[:, :, :, :, 0])


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

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("batch", [1, 5, 8])
    def test_k3_at_the_256px_blocks(self, cuda, dtype, batch):
        """The 7 residual blocks of the 256px generator (n_channels 32) at
        batch 1, 5 (which breaks the sample stacking) and 8: against the
        plain version (fp32 allclose 2e-4, bf16 max|err| <= 2^-5
        max|ref|), and a second call equal bit for bit."""
        from gan_codes_tpu_torch.config import GeneratorConfig
        gcfg = GeneratorConfig()
        for i, (cin, cout) in enumerate(gcfg.block_channels):
            hw = gcfg.base_size * 2 ** i
            args = [None if a is None else torch.from_numpy(a).to(cuda, dtype)
                    for a in _k3_inputs(batch, hw, hw, cin, cout, cin != cout,
                                        seed=i)]
            got = fused_resblock.fused_resblock_g(*args)
            again = fused_resblock.fused_resblock_g(*args)
            want = fused_resblock.reference_resblock_g(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (hw, cin, cout)
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
            else:
                err = (got.float() - want.float()).abs().max().item()
                assert err <= 2.0 ** -5 * want.float().abs().max().item()
            del args, got, again, want

    @pytest.mark.parametrize("shortcut", [False, True])
    def test_k3_is_one_kernel_and_leaves_no_scratch(self, cuda, shortcut):
        """One call launches K3's kernel once (after K2's pack kernel for
        w1, w2 and ws; the profiler may miss the first of those), adds one
        to its counter, and leaves only its output allocated: the packed
        weights' scratch is freed. With shortcut, Cin == Cout and a 1x1
        shortcut (which the plan must not take for an identity)."""
        from torch.profiler import ProfilerActivity, profile

        cin = 256 if not shortcut else 128
        args = [None if a is None else torch.from_numpy(a).to(cuda)
                for a in _k3_inputs(8, 16, 16, cin, 128 if shortcut else 256,
                                    shortcut)]
        fused_resblock.fused_resblock_g(*args)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        launches = fused_resblock.fused_resblock_g.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fused_resblock.fused_resblock_g(*args)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum("fused_resblock_g_kernel" in k for k in kernels) == 1
        # the rest are K2's pack kernel, one for each weight
        assert all("pack_kernel" in k for k in kernels
                   if "fused_resblock_g_kernel" not in k)
        assert len(kernels) <= (4 if shortcut else 3)
        assert fused_resblock.fused_resblock_g.launches == launches + 1
        assert (torch.cuda.memory_allocated() - before
                == out.numel() * out.element_size())

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
        """All 16 (or 14) input gradients through the Function (K1 and
        cuDNN, K1 bwd) against the plain composition's autograd, fp32:
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

    @pytest.mark.parametrize("dims", [(2, 4, 4, 256, 256, False),
                                      (2, 19, 21, 64, 32, True),
                                      (1, 24, 40, 36, 64, True)])
    def test_k3_one_pass_tf32(self, one_pass, dims):
        """K3 with one TF32 product per product against its plain version
        of that mode: allclose 2e-4, as 3xTF32 against fp32; further from
        the fp32 plain version than from it; a second call bit for bit."""
        args = [None if a is None else torch.from_numpy(a).to(one_pass)
                for a in _k3_inputs(*dims)]
        got = fused_resblock.fused_resblock_g(*args)
        again = fused_resblock.fused_resblock_g(*args)
        want = fused_resblock.reference_resblock_g(*args, tf32=True)
        full = _fp32(lambda: fused_resblock.reference_resblock_g(*args))
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)
        to_tf32, to_fp32 = _gaps(got, want, full)
        assert to_fp32 > to_tf32, (to_tf32, to_fp32)

    def test_k3_refuses_unsupported_cout(self, cuda):
        args = [None if a is None else torch.from_numpy(a).to(cuda)
                for a in _k3_inputs(1, 4, 4, 16, 48, True)]
        with pytest.raises(ValueError, match="Cout"):
            fused_resblock.fused_resblock_g(*args)


def _ma_gp_d_grads(d, images, sents, penalty: bool):
    """MA-GP's D gradients: through `losses.ma_gradient_penalty` (D's convs
    as `ops_nn.PenaltyConv2d`) or, with `penalty` False, the same penalty
    through autograd's own double backward of `F.conv2d`."""
    from gan_codes_tpu_torch.config import LossConfig
    from gan_codes_tpu_torch.train import losses

    cfg = LossConfig()
    params = list(d.parameters())
    if penalty:
        gp = losses.ma_gradient_penalty(d, images, sents, cfg)
    else:
        x = images.detach().requires_grad_(True)
        s = sents.detach().requires_grad_(True)
        g_img, g_sent = torch.autograd.grad(d.logits(d.embeds(x), s).sum(),
                                            (x, s), create_graph=True)
        gp = losses.penalty(g_img, g_sent, cfg.gp_coef, cfg.gp_power,
                            cfg.gp_eps, cfg.gp_norm_clip)
    grads = torch.autograd.grad(gp, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


@pytest.mark.cuda
class TestPenaltyConvOnCard:
    """DF-GAN's MA-GP with D's convs as `ops_nn.PenaltyConv2d` against
    autograd's own double backward, at the training cells' shapes (D at
    256 px, full width, batch 24)."""

    @pytest.mark.parametrize("precision,limit", [("highest", 0.012),
                                                 ("high", 0.35)])
    def test_d_gradients_against_autograd(self, cuda, precision, limit):
        """Each leaf's gradient gap, |new - native| / max(|native|, the
        median leaf's norm), within the limit the cell holds MA-GP's
        gradient to against the reference (`grad_gap_gp`: fp32 0.012, one
        TF32 pass 0.35); in fp32 the penalty runs no cuDNN
        `implicit_convolve_sgemm` kernel."""
        from torch.profiler import ProfilerActivity, profile

        from gan_codes_tpu_torch.config import DiscriminatorConfig
        from gan_codes_tpu_torch.models.discriminator import Discriminator

        gen = torch.Generator().manual_seed(5)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(5)
            d = Discriminator(DiscriminatorConfig())
        with torch.no_grad():
            for name, p in d.named_parameters():
                if name.endswith(".gamma"):
                    p.copy_(torch.rand(1, generator=gen) * 0.5 + 0.25)
        d = d.to(cuda)
        images = (torch.rand(24, 256, 256, 3, generator=gen) * 2 - 1).to(cuda)
        sents = torch.randn(24, 256, generator=gen).to(cuda)
        previous = pdevice.set_matmul_precision(precision)
        try:
            new = _ma_gp_d_grads(d, images, sents, True)
            native = _ma_gp_d_grads(d, images, sents, False)
            if precision == "highest":
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    _ma_gp_d_grads(d, images, sents, True)
                    torch.cuda.synchronize()
                kernels = {e.name for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA}
        finally:
            pdevice.set_matmul_precision(previous)
        norms = [float(w.double().norm()) for w in native]
        med = float(np.median(norms))
        assert med > 0
        gaps = {n: float((g.double() - w.double()).norm()) / max(wn, med)
                for (n, _), g, w, wn in zip(d.named_parameters(), new,
                                            native, norms)}
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= limit, (worst, gaps[worst])
        if precision == "highest":
            assert kernels, "the profiler recorded no kernel"
            assert not [k for k in kernels
                        if "implicit_convolve_sgemm" in k], sorted(kernels)


def _dfgan_state(cfg, seed=11):
    """A seeded DF-GAN train state on the card (every block gamma away
    from 0, the EMA = G), its frozen text encoder and 4 seeded batches."""
    from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
    from gan_codes_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, seed, device="cuda")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in (state.generator, state.discriminator):
            for name, p in module.named_parameters():
                if name.endswith(".gamma"):
                    p.copy_(torch.rand(1, generator=gen) * 0.5 + 0.25)
        for e, p in zip(state.g_ema.parameters(),
                        state.generator.parameters()):
            e.copy_(p)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        te = RNNEncoder(cfg.text_encoder)
    te = te.cuda().eval().requires_grad_(False)
    b, s, t = cfg.train.batch_size, cfg.generator.image_size, \
        cfg.text_encoder.max_len
    batches = [((torch.rand((b, s, s, 3), generator=gen) * 2 - 1).cuda(),
                torch.randint(1, cfg.text_encoder.vocab_size, (b, t),
                              generator=gen).cuda(),
                torch.randint(2, t + 1, (b,), generator=gen))
               for _ in range(4)]
    return state, te, batches


def _counts():
    """Every counter of the ops layer (`ops/kernels.COUNTERS`: K2, K1, K1
    bwd, K3, MA-GP's weight terms)."""
    from gan_codes_tpu_torch.ops.kernels import COUNTERS

    return [getattr(holder, name) for holder, name in COUNTERS]


def _state_tensors(state):
    """Every tensor the step leaves in `state`, by name, on the host."""
    out = {}
    for key in ("generator", "discriminator", "g_ema"):
        for n, p in getattr(state, key).named_parameters():
            out[f"{key}.{n}"] = p.detach().cpu()
    for key in ("g_opt", "d_opt"):
        opt = getattr(state, key)
        for i, p in enumerate(opt.params):
            for f, v in opt.adam.state[p].items():
                out[f"{key}.{i}.{f}"] = v.detach().cpu()
    return out


def _run(step, state, te, batches, eager: bool):
    """The steps over `batches`: with `eager`, each with its noise drawn
    from `state.rng` just before it (the draw the step makes itself), so
    the step runs eagerly on the same stream of numbers. Returns each
    step's metrics (host floats) and the counters' rise."""
    before = _counts()
    rows = []
    for images, captions, lens in batches:
        noise = torch.randn((images.shape[0], step._latent),
                            generator=state.rng, device="cuda") \
            if eager else None
        m = step(state, te, images, captions, lens, noise=noise)
        rows.append(m)
    rows = [{k: v.item() for k, v in m.items()} for m in rows]
    return rows, [a - b for a, b in zip(_counts(), before)]


@pytest.fixture
def deterministic(cuda):
    previous = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield cuda
    torch.backends.cudnn.deterministic = previous


@pytest.mark.cuda
class TestGraphedStepOnCard:
    """DF-GAN's step as CUDA graph replays (`train/step.py::DFGANStep`)
    against the same step run eagerly with the same optimizer settings,
    on deterministic cuDNN, from one seed at 64 px (K2 on every DFBlock):
    bit for bit."""

    @staticmethod
    def _cfg(gp_interval=1):
        from gan_codes_tpu_torch.config import GANConfig

        return GANConfig.for_image_size(
            64, vocab_size=40, batch_size=4,
            loss_overrides={"gp_interval": gp_interval})

    @pytest.mark.parametrize("gp_interval", [1, 2])
    def test_replays_equal_eager_steps(self, deterministic, gp_interval):
        """4 steps each way: the per-step metrics, the parameters, the
        EMA and both Adam states bit for bit; the kernels' launches and
        MA-GP's weight terms counted alike; 3 of the graphed steps
        replays (the first is the eager warm-up)."""
        from gan_codes_tpu_torch.train.step import make_train_step

        cfg = self._cfg(gp_interval)
        results = []
        for eager in (True, False):
            state, te, batches = _dfgan_state(cfg)
            step = make_train_step(cfg)
            if eager:  # the optimizer settings the graphed path takes
                state.g_opt.set_capturable(True)
                state.d_opt.set_capturable(True)
            rows, counts = _run(step, state, te, batches, eager)
            torch.cuda.synchronize()
            results.append((rows, counts, _state_tensors(state),
                            step.replays, state.step))
        (rows_e, counts_e, st_e, rep_e, n_e), \
            (rows_g, counts_g, st_g, rep_g, n_g) = results
        assert rows_g == rows_e
        assert [r["d_gp_active"] for r in rows_g] == [
            float(i % gp_interval == 0) for i in range(4)]
        assert counts_g == counts_e and min(counts_e[0], counts_e[2]) > 0
        assert counts_e[4] > 0
        assert (rep_e, rep_g, n_e, n_g) == (0, 3, 4, 4)
        assert st_g.keys() == st_e.keys()
        differ = [n for n in st_e if not torch.equal(st_g[n], st_e[n])]
        assert not differ, differ[:10]

    @pytest.mark.parametrize("saved_at", [0, 2])
    def test_restore_after_graphed_steps(self, deterministic, saved_at):
        """Graphed steps, then a checkpoint restored (one taken after
        `saved_at` steps: at 0 Adam has no state yet), then the steps to
        the fourth: the graphs are captured again (after an eager step
        where Adam has no state), and the state equals four eager steps'
        bit for bit."""
        from gan_codes_tpu_torch.train.checkpoint import (load_state_dict,
                                                          state_to_dict)
        from gan_codes_tpu_torch.train.step import make_train_step

        cfg = self._cfg()
        state, te, batches = _dfgan_state(cfg)
        step = make_train_step(cfg)
        state.g_opt.set_capturable(True)
        state.d_opt.set_capturable(True)
        rows_e, _ = _run(step, state, te, batches, eager=True)
        want = _state_tensors(state)

        state, te, batches = _dfgan_state(cfg)
        step = make_train_step(cfg)
        _run(step, state, te, batches[:saved_at], eager=False)
        blob = torch.load(_roundtrip(state_to_dict(state)),
                          map_location="cpu", weights_only=True)
        _run(step, state, te, batches[saved_at:3], eager=False)
        first = step._graphs
        load_state_dict(state, blob)
        rows_g, _ = _run(step, state, te, batches[saved_at:], eager=False)
        torch.cuda.synchronize()
        assert first is not None and step._graphs is not first
        # 2 of the 3 steps before the restore; after it every step, but
        # for the eager one that makes Adam's state when it has none
        assert step.replays == 2 + (4 - saved_at) - (saved_at == 0)
        assert rows_g == rows_e[saved_at:]
        got = _state_tensors(state)
        differ = [n for n in want if not torch.equal(got[n], want[n])]
        assert not differ, differ[:10]


def _roundtrip(blob):
    """`blob` through `torch.save`, as a checkpoint file holds it."""
    import io

    buf = io.BytesIO()
    torch.save(blob, buf)
    buf.seek(0)
    return buf
