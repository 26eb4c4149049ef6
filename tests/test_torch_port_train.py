"""The port's training slice (K1's backward, K2's gradient, the
discriminator, the losses, the optimizer and the 3-phase train step) held
against the JAX package on the CPU, on the same numpy-made inputs and
weights.

JAX runs on the CPU at highest matmul precision with its Pallas kernels in
interpret mode (tests/conftest.py); the port runs its kernels' plain
versions (CPU tensors). The CUDA kernels are held against these plain
versions on a card in tests/test_torch_port_cuda.py.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gan_codes_tpu import config as jcfg
from gan_codes_tpu.models import discriminator as jdisc
from gan_codes_tpu.models import torch_import as jimport
from gan_codes_tpu.models.text_encoder import (init_text_encoder,
                                               text_encoder_apply)
from gan_codes_tpu.ops import blocks as jblocks
from gan_codes_tpu.ops.pallas.fused_affine import (
    _pick_tile, fused_double_affine_leaky as jax_k1)
from gan_codes_tpu.ops.pallas.fused_modconv import fused_modconv3x3 as jax_k2
from gan_codes_tpu.train import losses as jlosses
from gan_codes_tpu.train import state as jstate
from gan_codes_tpu.train.step import make_train_step as jax_make_train_step
from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch.models import torch_import as pimport
from gan_codes_tpu_torch.models.discriminator import Discriminator
from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
from gan_codes_tpu_torch.ops import blocks as pblocks
from gan_codes_tpu_torch.ops.kernels import fused_affine, fused_modconv
from gan_codes_tpu_torch.train import losses as plosses
from gan_codes_tpu_torch.train import state as pstate
from gan_codes_tpu_torch.train.step import make_train_step

T = torch.from_numpy


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _with_gammas(params, base):
    """Every block gamma away from its 0 init, as
    tests/test_trajectory.py:45-51 sets them."""
    for i, bp in enumerate(params["blocks"]):
        bp["gamma"] = jnp.asarray(base + 0.07 * i, jnp.float32)
    return params


def _port_d(params, cfg) -> Discriminator:
    d = Discriminator(pcfg.DiscriminatorConfig(**dataclasses.asdict(cfg)))
    d.load_state_dict(pimport.discriminator_state_dict_from_jax(
        _np_tree(params)), strict=True)
    return d


def _k1_case(shape, seed=0):
    """x, [g1, b1, g2, b2], dy; x = 0 on a quarter of the pixels and
    b1 = b2 = 0 on half the channels, so y1 and y2 are exact zeros there."""
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    vecs = [rng.standard_normal((b, c)).astype(np.float32) for _ in range(4)]
    dy = rng.standard_normal(shape).astype(np.float32)
    x[:, ::2, ::2, :] = 0.0
    vecs[1][:, ::2] = 0.0
    vecs[3][:, ::2] = 0.0
    return x, vecs, dy


class TestK1Backward:
    @pytest.mark.parametrize("shape", [(2, 48, 48, 8), (3, 4, 4, 16)])
    def test_plain_and_function_match_jax_pallas_vjp(self, shape):
        """Against `jax.vjp` of the Pallas kernel (its `_bwd_call`, in
        interpret mode): [2,48,48,8] spans 9 HW tiles of 256, [3,4,4,16]
        one. fp32 allclose 1e-5, with exact zeros in y1 and y2, where the
        slope is 1 (F.leaky_relu's backward would give 0.2)."""
        hw = shape[1] * shape[2]
        assert hw // _pick_tile(hw) == (9 if hw == 2304 else 1)
        x, vecs, dy = _k1_case(shape)
        y1 = vecs[0][:, None, None, :] * x + vecs[1][:, None, None, :]
        assert (y1 == 0).sum() >= x.size // 8
        _, vjp = jax.vjp(jax_k1, jnp.asarray(x), *map(jnp.asarray, vecs))
        want = [np.asarray(t) for t in vjp(jnp.asarray(dy))]

        plain = fused_affine.reference_double_affine_leaky_bwd(
            T(x), *map(T, vecs), T(dy))
        ins = [T(a).requires_grad_(True) for a in [x] + vecs]
        out = fused_affine.fused_double_affine_leaky(*ins)
        assert out.grad_fn is not None
        out.backward(T(dy))
        for got in (plain, [t.grad for t in ins]):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), w, atol=1e-5,
                                           rtol=1e-5)
        # the zero slope rule is what the JAX kernel uses
        np.testing.assert_array_equal(
            plain[0].numpy()[:, ::2, ::2, ::2],
            (dy * vecs[2][:, None, None, :] * vecs[0][:, None, None, :]
             )[:, ::2, ::2, ::2])

    def test_bf16_against_fp32(self):
        """bf16 through the plain backward against fp32 on the same
        (bf16-rounded) inputs. The slope steps at y == 0, so x is redrawn
        where |y1| or |y2| < 0.1, where a bf16 rounding could flip a mask;
        what is left is rounding (|g| in [0.5, 1.5], so every y can be
        moved). dx carries at most six bf16 roundings
        (2^-9 each), the four sums add bf16-rounded products in fp32:
        max|err| <= 2^-6 max|ref| for each of the five outputs."""
        rng = np.random.default_rng(1)
        shape = (2, 48, 48, 8)
        sign = rng.choice([-1.0, 1.0], (2, 2, 8))
        vecs = [(sign[0] * rng.uniform(0.5, 1.5, (2, 8))),
                rng.standard_normal((2, 8)),
                (sign[1] * rng.uniform(0.5, 1.5, (2, 8))),
                rng.standard_normal((2, 8))]
        vecs = [v.astype(np.float32) for v in vecs]
        g1, b1, g2, b2 = (v[:, None, None, :] for v in vecs)
        x = rng.standard_normal(shape).astype(np.float32)
        for _ in range(100):
            y1 = g1 * x + b1
            y2 = g2 * np.where(y1 >= 0, y1, 0.2 * y1) + b2
            near = (np.abs(y1) < 0.1) | (np.abs(y2) < 0.1)
            if not near.any():
                break
            x = np.where(near, rng.standard_normal(shape), x
                         ).astype(np.float32)
        assert not near.any()
        dy = rng.standard_normal(shape).astype(np.float32)
        args = [T(a).bfloat16() for a in [x] + vecs + [dy]]
        want = fused_affine.reference_double_affine_leaky_bwd(
            *(a.float() for a in args))
        got = fused_affine.fused_double_affine_leaky_bwd(*args)
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            err = (g.float() - w).abs().max().item()
            assert err <= 2.0 ** -6 * w.abs().max().item(), err

    def test_bwd_rejects_bad_inputs(self):
        x, vecs, dy = _k1_case((2, 4, 4, 8))
        args = [T(a) for a in [x] + vecs]
        with pytest.raises(ValueError, match="dy must be"):
            fused_affine.fused_double_affine_leaky_bwd(*args, T(dy)[:1])
        with pytest.raises(TypeError, match="dy dtype"):
            fused_affine.fused_double_affine_leaky_bwd(*args,
                                                       T(dy).double())


class TestK2Gradient:
    @pytest.mark.parametrize("dims", [(2, 8, 8, 4, 8), (2, 5, 7, 3, 64)])
    def test_function_grads_match_jax(self, dims):
        """All seven gradients of sum(tanh(K2)) against `jax.grad` of the
        JAX `fused_modconv3x3`, as tests/test_pallas.py::TestFusedModConv::
        test_grads_match_xla holds the Pallas kernel; atol/rtol 1e-4."""
        b, h, w, cin, cout = dims
        rng = np.random.default_rng(2)
        x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
        vecs = [rng.standard_normal((b, cin)).astype(np.float32)
                for _ in range(4)]
        bound = (9 * cin) ** -0.5
        wt = rng.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32)
        bias = rng.uniform(-bound, bound, (cout,)).astype(np.float32)
        args = [x] + vecs + [wt, bias]
        want = jax.grad(lambda *a: jnp.sum(jnp.tanh(jax_k2(*a))),
                        argnums=tuple(range(7)))(*map(jnp.asarray, args))
        ins = [T(a).requires_grad_(True) for a in args]
        out = fused_modconv.fused_modconv3x3(*ins)
        assert out.grad_fn is not None
        torch.tanh(out).sum().backward()
        for t, w_ in zip(ins, want):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w_),
                                       atol=1e-4, rtol=1e-4)

    def test_backward_recomputes_h_with_k1_and_uses_k1_bwd(self):
        """K2's backward saves x, not h: it calls K1's forward once and
        K1's backward once."""
        rng = np.random.default_rng(3)
        ins = [T(rng.standard_normal(s).astype(np.float32)).requires_grad_()
               for s in [(1, 4, 4, 8)] + [(1, 8)] * 4 + [(3, 3, 8, 64),
                                                         (64,)]]
        out = fused_modconv.fused_modconv3x3(*ins)
        with mock.patch.object(fused_affine, "_forward",
                               wraps=fused_affine._forward) as fwd, \
                mock.patch.object(
                    fused_affine, "fused_double_affine_leaky_bwd",
                    wraps=fused_affine.fused_double_affine_leaky_bwd) as bwd:
            out.sum().backward()
        assert fwd.call_count == 1 and bwd.call_count == 1


D_CFG = jcfg.DiscriminatorConfig(n_channels=4, image_size=32,
                                 sentence_dim=10)


def _d_setup(seed=0):
    params = _with_gammas(jdisc.init_discriminator(
        jax.random.PRNGKey(seed), D_CFG), 0.25)
    rng = np.random.default_rng(seed)
    real = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    fake = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    sents = rng.standard_normal((3, 10)).astype(np.float32)
    return params, _port_d(params, D_CFG), real, fake, sents


class TestDiscriminator:
    @pytest.mark.parametrize("cin,cout", [(4, 8), (8, 8)])
    def test_res_block_d_matches_jax(self, cin, cout):
        """With the folded 1x1-conv shortcut and with the identity pool."""
        p = jblocks.init_res_block_d(jax.random.PRNGKey(4), cin, cout)
        p["gamma"] = jnp.asarray(0.6, jnp.float32)
        x = np.random.default_rng(5).standard_normal(
            (2, 8, 8, cin)).astype(np.float32)
        want = jblocks.res_block_d(p, jnp.asarray(x))
        block = pblocks.ResidualBlockD(cin, cout)
        tree = {"conv_stem": {"w": np.zeros((3, 3, 3, 1), np.float32)},
                "blocks": [_np_tree(p)],
                "conv_joint": {"w": np.zeros((1, 1, 1, 1), np.float32)},
                "conv_logit": {"w": np.zeros((1, 1, 1, 1), np.float32)}}
        sd = {k[len("img_forward.1."):]: v for k, v in
              pimport.discriminator_state_dict_from_jax(tree).items()
              if k.startswith("img_forward.1.")}
        block.load_state_dict(sd, strict=True)
        assert (block.scale_conv is None) == (cin == cout)
        with torch.no_grad():
            got = block(T(x))
        assert got.shape == (2, 4, 4, cout)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)

    def test_embeds_and_logits_match_jax(self):
        params, d, real, _, sents = _d_setup()
        want_e = jdisc.discriminator_embeds(params, jnp.asarray(real))
        want_l = jdisc.discriminator_logits(params, want_e,
                                            jnp.asarray(sents))
        with torch.no_grad():
            e = d.embeds(T(real))
            logits = d.logits(e, T(sents))
        assert e.shape == (3, 4, 4, 32) and logits.shape == (3, 1, 1, 1)
        np.testing.assert_allclose(e.numpy(), np.asarray(want_e),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_l),
                                   atol=1e-5, rtol=1e-5)

    def test_state_dict_equals_jax_export_and_param_count_at_256(self):
        params, d, *_ = _d_setup(1)
        want = jimport.export_discriminator_state_dict(params)
        got = pimport.discriminator_state_dict_from_jax(_np_tree(params))
        assert list(got) == list(want)
        assert set(got) == set(d.state_dict())
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
        shapes = jax.eval_shape(
            lambda k: jdisc.init_discriminator(k, jcfg.DiscriminatorConfig()),
            jax.random.PRNGKey(0))
        n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        n = sum(p.numel() for p in Discriminator(
            pcfg.DiscriminatorConfig()).parameters())
        assert n == n_jax and 19.6e6 < n < 19.7e6


class TestLosses:
    def test_hinge_and_damsm_values_match_jax(self):
        params, d, real, fake, sents = _d_setup(2)
        fns = (jdisc.discriminator_embeds, jdisc.discriminator_logits, params)
        jr, jf, js = map(jnp.asarray, (real, fake, sents))
        with torch.no_grad():
            got = [plosses.d_hinge_loss(d, T(real), T(fake), T(sents)),
                   plosses.g_hinge_loss(d, T(fake), T(sents))]
        want = [jlosses.d_hinge_loss(*fns, jr, jf, js),
                jlosses.g_hinge_loss(*fns, jf, js)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), atol=1e-5,
                                       rtol=1e-5)
        s256 = np.random.default_rng(3).standard_normal(
            (3, 256)).astype(np.float32)
        np.testing.assert_allclose(
            float(plosses.damsm_cosine_loss(T(fake), T(s256))),
            float(jlosses.damsm_cosine_loss(jf, jnp.asarray(s256))),
            atol=1e-6, rtol=1e-6)

    def test_ma_gp_value_and_d_grads_match_jax(self):
        """Value and d(penalty)/d(D params) against `jax.value_and_grad`
        (a double backward on both sides); rtol 1e-4, with an atol of
        1e-4 x the tensor's largest gradient for near-zero entries."""
        params, d, real, _, sents = _d_setup(3)
        cfg = jcfg.LossConfig()
        val, grads = jax.value_and_grad(
            lambda p: jlosses.ma_gradient_penalty(
                jdisc.discriminator_embeds, jdisc.discriminator_logits, p,
                jnp.asarray(real), jnp.asarray(sents), cfg))(params)
        gp = plosses.ma_gradient_penalty(
            d, T(real), T(sents),
            pcfg.LossConfig(**dataclasses.asdict(cfg)))
        params_t = list(d.parameters())
        got = torch.autograd.grad(gp, params_t, allow_unused=True)
        np.testing.assert_allclose(gp.item(), float(val), rtol=1e-4)
        want_sd = pimport.discriminator_state_dict_from_jax(_np_tree(grads))
        for (name, p), g in zip(d.named_parameters(), got):
            w = want_sd[name].numpy()
            g = np.zeros_like(w) if g is None else g.numpy()
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max() + 1e-12,
                                       err_msg=name)

    def test_nan_guard(self):
        rng = torch.Generator().manual_seed(0)
        ok = torch.tensor(1.5)
        assert plosses.nan_guard_loss(ok, rng) == ok
        bad = plosses.nan_guard_loss(torch.tensor(float("nan")), rng)
        assert torch.isfinite(bad) and abs(float(bad)) < 0.1
        grads = [torch.ones(3), torch.full((2,), 7.0)]
        assert all(torch.equal(a, b) for a, b in zip(
            plosses.zero_grads_if_nonfinite(ok, grads), grads))
        zeroed = plosses.zero_grads_if_nonfinite(torch.tensor(float("inf")),
                                                 grads)
        assert all(torch.equal(z, torch.zeros_like(z)) for z in zeroed)


class TestOptimizer:
    def test_clip_adam_and_ema_match_optax_over_3_updates(self):
        """The port's G and D optimizers against the optax chains of the
        JAX `make_optimizers`, with gradients scaled so the global-norm
        clip (5.0) is active at every update, and the EMA against the JAX
        `ema_update`."""
        cfg = pcfg.GANConfig.for_image_size(16, n_channels=4, vocab_size=20)
        st = pstate.create_train_state(cfg, seed=0, device="cpu")
        g_tx, d_tx = jstate.make_optimizers(jcfg.GANConfig.for_image_size(
            16, n_channels=4, vocab_size=20))
        rng = np.random.default_rng(4)
        for module, opt, tx in ((st.generator, st.g_opt, g_tx),
                                (st.discriminator, st.d_opt, d_tx)):
            params = list(module.parameters())
            # copies: a CPU jax array may alias the numpy memory it is
            # made from, and the port updates its parameters in place
            j_params = [jnp.array(p.detach().numpy(), copy=True)
                        for p in params]
            j_state = tx.init(j_params)
            j_ema = list(j_params)
            for _ in range(3):
                grads = [rng.standard_normal(p.shape).astype(np.float32)
                         for p in params]
                norm = np.sqrt(sum(float((g ** 2).sum()) for g in grads))
                assert norm > 5.0  # the clip is active
                upd, j_state = tx.update([jnp.asarray(g) for g in grads],
                                         j_state, j_params)
                j_params = optax.apply_updates(j_params, upd)
                opt.step([T(g.copy()) for g in grads])  # clips in place
                j_ema = jstate.ema_update(j_ema, j_params, 0.999)
                if module is st.generator:
                    pstate.ema_update(st.g_ema, module, 0.999)
                for p, jp in zip(params, j_params):
                    np.testing.assert_allclose(p.detach().numpy(),
                                               np.asarray(jp), rtol=1e-6,
                                               atol=1e-7)
                np.testing.assert_allclose(
                    torch.linalg.vector_norm(torch.stack(
                        [p.grad.norm() for p in params])).item(), 5.0,
                    rtol=1e-5)
            if module is st.generator:
                for e, je in zip(st.g_ema.parameters(), j_ema):
                    np.testing.assert_allclose(e.numpy(), np.asarray(je),
                                               rtol=1e-6, atol=1e-7)

    def test_clip_is_optax_not_torch(self):
        """Below the limit the gradients pass untouched; above it they are
        scaled by max / norm, not torch's max / (norm + 1e-6)."""
        small = [torch.full((4,), 0.5)]
        pstate.clip_by_global_norm(small, 5.0)
        assert torch.equal(small[0], torch.full((4,), 0.5))
        big = [torch.full((4,), 1e-5 * 4.0)]  # norm 8e-5 against max 1e-5
        pstate.clip_by_global_norm(big, 1e-5)
        np.testing.assert_allclose(big[0].numpy(), 0.5e-5, rtol=1e-6)


class TestTrainStep:
    """`make_train_step` of the port against the JAX `make_train_step` over
    6 steps from the same weights, batches and noise (replayed from the JAX
    state's key, tests/test_trajectory.py:77-79). At 16px with n_channels
    16, G's first block has Cout 64, so both of its DFBlocks run K2's
    Function and the other four K1's."""

    N_STEPS = 6
    BATCH = 6

    @staticmethod
    def _cfg(gp_interval):
        return jcfg.GANConfig(
            generator=jcfg.GeneratorConfig(n_channels=16, image_size=16),
            discriminator=jcfg.DiscriminatorConfig(n_channels=4,
                                                   image_size=16),
            text_encoder=jcfg.TextEncoderConfig(vocab_size=30, embed_dim=8,
                                                hidden_dim=256, max_len=6),
            loss=jcfg.LossConfig(gp_interval=gp_interval),
            train=jcfg.TrainConfig(batch_size=6))

    @pytest.mark.parametrize("gp_interval", [1, 2])
    def test_trajectory_matches_jax_make_train_step(self, gp_interval):
        """d_loss, d_gp_loss and g_loss at rtol 2e-4 / atol 2e-5 at every
        step; the final G and D within drift/5 of the JAX endpoint."""
        jc = self._cfg(gp_interval)
        pc = pcfg.GANConfig.from_dict(dataclasses.asdict(jc))
        jst = jstate.create_train_state(jax.random.PRNGKey(77), jc)
        _with_gammas(jst.g_params, 0.30)
        _with_gammas(jst.d_params, 0.25)
        te = init_text_encoder(jax.random.PRNGKey(3), jc.text_encoder)
        g_sd0 = pimport.generator_state_dict_from_jax(_np_tree(jst.g_params))
        d_sd0 = pimport.discriminator_state_dict_from_jax(
            _np_tree(jst.d_params))

        pst = pstate.create_train_state(pc, seed=0, device="cpu")
        pst.generator.load_state_dict(g_sd0, strict=True)
        pst.discriminator.load_state_dict(d_sd0, strict=True)
        pte = RNNEncoder(pc.text_encoder).eval()
        pte.load_state_dict(
            pimport.text_encoder_state_dict_from_jax(_np_tree(te)),
            strict=True)
        jstep = jax.jit(jax_make_train_step(jc))
        pstep = make_train_step(pc)

        rngs = jax.random.split(jax.random.PRNGKey(9), self.N_STEPS)
        for i in range(self.N_STEPS):
            ki, kc, kl = jax.random.split(rngs[i], 3)
            images = jax.random.normal(ki, (self.BATCH, 16, 16, 3)) * 0.5
            caps = jax.random.randint(kc, (self.BATCH, 6), 1, 30)
            lens = jax.random.randint(kl, (self.BATCH,), 2, 7)
            _, k_noise, _, _, _ = jax.random.split(jst.rng, 5)
            noise = jax.random.normal(k_noise, (self.BATCH, 100))
            jst, jm = jstep(jst, te, images, caps, lens)
            pm = pstep(pst, pte, T(np.asarray(images)),
                       T(np.asarray(caps)), T(np.asarray(lens)),
                       noise=T(np.asarray(noise)))
            assert set(pm) == set(jm)
            for k in ("d_loss", "d_gp_loss", "g_loss", "d_gp_active"):
                np.testing.assert_allclose(
                    float(pm[k]), float(jm[k]), rtol=2e-4, atol=2e-5,
                    err_msg=f"step {i} {k}")
        assert pst.step == self.N_STEPS

        def gap(sd_a, sd_b):
            return max(float((sd_a[k].float() - sd_b[k].float()).abs().max())
                       for k in sd_a)

        for module, sd0, final in (
                (pst.generator, g_sd0, pimport.generator_state_dict_from_jax(
                    _np_tree(jst.g_params))),
                (pst.discriminator, d_sd0,
                 pimport.discriminator_state_dict_from_jax(
                     _np_tree(jst.d_params)))):
            drift = gap(final, sd0)
            assert drift > 3e-4, drift
            got = {k: v.detach() for k, v in module.state_dict().items()}
            assert gap(got, final) < drift / 5, (gap(got, final), drift)
