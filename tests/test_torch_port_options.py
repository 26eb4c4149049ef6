"""The JAX trainer's last options in the port, held against the JAX package
on the CPU: the four flags of `train_entry` (`--matmul-precision`,
`--remat-g`, `--device-prefetch`, `--debug-nans`) against JAX's parser,
the one-pass TF32 plain versions of K2 and K3 against a float64 conv of
TF32-rounded operands, `set_matmul_precision` and `serving_device`, the
generator and a train step with `remat_blocks` against JAX's, the trainer's
one-ahead upload against the plain loop, and NaNs failing fast in both.

JAX runs on the CPU at highest matmul precision (tests/conftest.py); the
port runs its kernels' plain versions (CPU tensors)."""
import argparse
import dataclasses
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gan_codes_tpu import config as jcfg
from gan_codes_tpu import train_entry as jentry
from gan_codes_tpu.models import generator as jgen
from gan_codes_tpu.models import text_encoder as jte
from gan_codes_tpu.models import torch_import as jimport
from gan_codes_tpu.train import state as jstate
from gan_codes_tpu.train.step import make_train_step as jax_make_train_step
from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch import train_entry as pentry
from gan_codes_tpu_torch.models import torch_import as pimport
from gan_codes_tpu_torch.models.generator import Generator
from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
from gan_codes_tpu_torch.ops.kernels import fused_affine, fused_modconv
from gan_codes_tpu_torch.ops.kernels import fused_resblock
from gan_codes_tpu_torch.train import state as pstate
from gan_codes_tpu_torch.train.step import make_train_step
from gan_codes_tpu_torch.train.trainer import Trainer
from gan_codes_tpu_torch.utils import device as pdevice
from torch_port_env import one_thread_children  # noqa: E402,F401

T = torch.from_numpy
FLAGS = ("--matmul-precision", "--remat-g", "--device-prefetch",
         "--debug-nans")
# the trajectory tolerance (tests/test_trajectory.py:95)
RTOL, ATOL = 2e-4, 2e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _with_gammas(module, base):
    """Every block gamma of a port module away from its 0 init
    (tests/test_parity.py:73)."""
    with torch.no_grad():
        for i, (name, p) in enumerate(
                (n, p) for n, p in module.named_parameters()
                if n.endswith("gamma")):
            p.fill_(base + 0.07 * i)
    return module


def _jax_state(pst, jc, seed: int):
    """The JAX TrainState of a port TrainState's weights, through the JAX
    package's torch converters (JAX's own init compiles op by op, seconds
    a module on the CPU)."""
    g = jimport.convert_torch_generator_state_dict(
        pst.generator.state_dict(), jc.generator)
    d = jimport.convert_torch_discriminator_state_dict(
        pst.discriminator.state_dict(), jc.discriminator)
    g_tx, d_tx = jstate.make_optimizers(jc)
    build = jax.jit(lambda g, d, key: jstate.TrainState(
        step=jnp.zeros((), jnp.int32), g_params=g, d_params=d,
        g_opt_state=g_tx.init(g), d_opt_state=d_tx.init(d),
        g_ema_params=jax.tree.map(jnp.copy, g), rng=key))
    return build(g, d, jax.random.PRNGKey(seed))


class _Parsed(Exception):
    pass


def _parser_of(main, *args) -> argparse.ArgumentParser:
    """The parser `main` builds: its `parse_args` is intercepted."""
    seen = []

    def capture(self, *a, **k):
        seen.append(self)
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        with pytest.raises(_Parsed):
            main(*args)
    return seen[0]


def _options(parser) -> dict:
    return {opt: action for action in parser._actions
            for opt in action.option_strings}


@pytest.fixture
def restore_precision():
    """Put the process's precision and torch's TF32 flags back."""
    saved = (pdevice._precision, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    yield
    pdevice._precision = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    torch.backends.cuda.matmul.allow_tf32 = saved[2]


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


class TestCli:
    @pytest.mark.parametrize("flag", FLAGS)
    def test_flag_matches_jax_parser(self, flag):
        """Each flag as JAX's parser has it: kind, destination, default and
        choices (`--matmul-precision`: default, high, highest; None)."""
        want = _options(_parser_of(jentry.main))[flag]
        got = _options(_parser_of(pentry.main, []))[flag]
        assert type(got) is type(want)
        assert got.dest == want.dest
        assert got.default == want.default
        assert (None if got.choices is None else list(got.choices)) \
            == (None if want.choices is None else list(want.choices))
        if flag == "--matmul-precision":
            assert list(got.choices) == ["default", "high", "highest"]
            assert got.default is None

    def test_main_forwards_the_flags_to_train(self):
        argv = ["--data", "d", "--device", "cpu"]
        with mock.patch.object(pentry, "train") as train:
            pentry.main(argv)
            pentry.main(argv + ["--matmul-precision", "high", "--remat-g",
                                "--device-prefetch", "--debug-nans"])
        off, on = (c.kwargs for c in train.call_args_list)
        assert (off["matmul_precision"], off["remat_g"],
                off["device_prefetch"], off["debug_nans"]) \
            == (None, False, False, False)
        assert (on["matmul_precision"], on["remat_g"],
                on["device_prefetch"], on["debug_nans"]) \
            == ("high", True, True, True)
        with pytest.raises(SystemExit):
            pentry.main(argv + ["--matmul-precision", "fastest"])


class TestMatmulPrecision:
    @pytest.mark.parametrize("precision, tf32", [
        (None, False), ("highest", False), ("high", True),
        ("default", True)])
    def test_sets_both_flags_and_serving_device_keeps_them(
            self, precision, tf32, restore_precision):
        pdevice.set_matmul_precision("high" if not tf32 else "highest")
        pdevice.set_matmul_precision(precision)
        assert _tf32_flags() == (tf32, tf32)
        assert fused_modconv.one_pass_tf32() is tf32
        with mock.patch.object(torch.cuda, "is_available",
                               return_value=True):
            assert pdevice.serving_device("cuda").type == "cuda"
            assert pdevice.serving_device("cuda:0").type == "cuda"
        assert _tf32_flags() == (tf32, tf32)
        assert pdevice.serving_device("cpu").type == "cpu"
        assert _tf32_flags() == (tf32, tf32)

    @pytest.mark.parametrize("precision", [None, "highest"])
    def test_torch_flags_set_elsewhere_leave_the_kernels_in_fp32(
            self, precision, restore_precision):
        """A library that turns torch's TF32 flags on behind the port's
        back (`torch.set_float32_matmul_precision("high")`) switches
        neither K2 nor K3, nor their plain versions on the CPU, to one
        TF32 pass: the port's precision is the one that decides."""
        pdevice.set_matmul_precision(precision)
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        assert torch.backends.cuda.matmul.allow_tf32
        assert not fused_modconv.one_pass_tf32()
        assert not fused_resblock.one_pass_tf32()
        ins = _k2_inputs(2, 4, 4, 8, 32, seed=1)
        assert torch.equal(fused_modconv.fused_modconv3x3(*ins),
                           fused_modconv.reference_modconv3x3(*ins))

    def test_unknown_precision_raises(self, restore_precision):
        with pytest.raises(ValueError, match="fastest"):
            pdevice.set_matmul_precision("fastest")

    def test_train_sets_the_precision_for_the_run_only(
            self, tmp_path, restore_precision):
        """train(matmul_precision="high") runs its trainer with TF32 on
        and the kernels in one pass, and puts the precision back."""
        from gan_codes_tpu_torch.data import make_synthetic_cub
        data = make_synthetic_cub(str(tmp_path / "cub"), n_train=4,
                                  n_test=4, image_size=20)["root"]
        pdevice.set_matmul_precision(None)
        seen = []

        def fit(self, *a, **k):
            seen.append((_tf32_flags(), fused_modconv.one_pass_tf32()))
            return {k: [] for k in ("g_losses", "d_losses", "d_gp_losses",
                                    "txtimg_losses", "is_scores",
                                    "fid_scores")}

        with mock.patch.object(Trainer, "fit", fit):
            for precision in ("high", None):
                pentry.train(data, None, str(tmp_path / "i"),
                             str(tmp_path / "w"), image_size=16,
                             batch_size=2, num_epochs=1, n_channels=4,
                             device="cpu", matmul_precision=precision)
        assert seen == [((True, True), True), ((False, False), False)]
        assert _tf32_flags() == (False, False)
        assert pdevice._precision is None


def _k2_inputs(b, h, w, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    gb = [(rng.standard_normal((b, cin)) * s + m).astype(np.float32)
          for m, s in ((1.0, 0.2), (0.0, 0.3), (1.0, 0.2), (0.0, 0.3))]
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return [T(a) for a in (x, *gb, wt, bias)]


def _conv64(h, w, padding=1):
    """NHWC h (*) HWIO w in float64: the exact sums of the products."""
    return F.conv2d(h.double().permute(0, 3, 1, 2),
                    w.double().permute(3, 2, 0, 1),
                    padding=padding).permute(0, 2, 3, 1)


def _tf32_conv64(h, w, padding=1):
    """(float64 conv of the TF32-rounded operands, the float64 conv of
    their magnitudes: each output's sum of |products|)."""
    h, w = fused_modconv.tf32_round(h), fused_modconv.tf32_round(w)
    return _conv64(h, w, padding), _conv64(h.abs(), w.abs(), padding)


class TestOnePassTf32PlainVersions:
    """The one-pass kernels' plain versions round both operands of every
    conv to TF32 (as `cvt.rna.tf32.f32`) and sum their products in fp32:
    against the float64 conv of the TF32-rounded operands, each output is
    within fp32 accumulation error, n * 2^-24 of its sum of |products|
    (n products), while the fp32 (TF32-off) plain version is TF32's
    rounding away (2^-11 a product)."""

    @pytest.mark.parametrize("dims", [(2, 8, 8, 16, 32), (3, 4, 4, 40, 64)])
    def test_k2(self, dims):
        b, h, w, cin, cout = dims
        x, g1, b1, g2, b2, wt, bias = _k2_inputs(*dims, seed=cin)
        got = fused_modconv.reference_modconv3x3(x, g1, b1, g2, b2, wt,
                                                 bias, tf32=True)
        hmod = fused_affine.reference_double_affine_leaky(x, g1, b1, g2, b2)
        want, mag = _tf32_conv64(hmod, wt)
        want = want + bias.double()
        err = (got.double() - want).abs()
        assert bool((err <= 9 * cin * 2.0**-24 * (mag + bias.abs())).all())
        fp32 = fused_modconv.reference_modconv3x3(x, g1, b1, g2, b2, wt,
                                                  bias)
        assert float((fp32.double() - want).abs().max()) \
            > 50 * float(err.max())

    @pytest.mark.parametrize("cin, cout", [(32, 32), (16, 32)])
    def test_k3(self, cin, cout):
        b, h, w = 2, 8, 8
        x, g1, b1, g2, b2, w1, c1 = _k2_inputs(b, h, w, cin, cout, seed=7)
        _, g3, b3, g4, b4, w2, c2 = _k2_inputs(b, h, w, cout, cout, seed=8)
        gamma = torch.tensor([0.6])
        ws = cs = None
        if cin != cout:
            ws = T((np.random.default_rng(9).standard_normal(
                (1, 1, cin, cout)) * 0.3).astype(np.float32))
            cs = torch.full((cout,), 0.05)
        args = (x, g1, b1, g2, b2, w1, c1, g3, b3, g4, b4, w2, c2, gamma, ws,
                cs)
        got = fused_resblock.reference_resblock_g(*args, tf32=True)
        # float64 sums of the TF32-rounded operands, each stage's output
        # rounded to fp32 where the plain version rounds it
        chain = fused_affine.reference_double_affine_leaky
        s1, m1 = _tf32_conv64(chain(x, g1, b1, g2, b2), w1)
        h1 = (s1.float() + c1).float()
        s2, m2 = _tf32_conv64(chain(h1, g3, b3, g4, b4), w2)
        want = (s2.float() + c2) * gamma
        bound = 9 * cout * 2.0**-24 * float(m2.max()) * 0.6
        if ws is not None:
            s3, m3 = _tf32_conv64(x, ws, padding=0)
            want = want + (s3.float() + cs)
            bound += cin * 2.0**-24 * float(m3.max())
        else:
            want = want + x
        # h1's own sum error reaches h2 through conv2 (|w2| sums)
        bound += (9 * cin * 2.0**-24 * float(m1.max())
                  * float(w2.abs().sum(dim=(0, 1, 2)).max()) * 0.6 * 1.5)
        err = float((got.double() - want.double()).abs().max())
        assert err <= 2 * bound, (err, bound)
        fp32 = fused_resblock.reference_resblock_g(*args)
        assert float((fp32.double() - want.double()).abs().max()) > 10 * err

    def test_wrappers_follow_the_process_precision_on_the_cpu(
            self, restore_precision):
        """`fused_modconv3x3` and `fused_resblock_g` on CPU tensors run the
        plain version of the mode `one_pass_tf32` names at the call."""
        ins = _k2_inputs(2, 4, 4, 8, 32, seed=1)
        for precision, tf32 in (("high", True), ("highest", False)):
            pdevice.set_matmul_precision(precision)
            assert torch.equal(
                fused_modconv.fused_modconv3x3(*ins),
                fused_modconv.reference_modconv3x3(*ins, tf32=tf32))
        x, g1, b1, g2, b2, w1, c1 = _k2_inputs(2, 4, 4, 32, 32, seed=2)
        _, g3, b3, g4, b4, w2, c2 = _k2_inputs(2, 4, 4, 32, 32, seed=3)
        args = (x, g1, b1, g2, b2, w1, c1, g3, b3, g4, b4, w2, c2,
                torch.tensor([0.5]))
        pdevice.set_matmul_precision("default")
        assert torch.equal(fused_resblock.fused_resblock_g(*args),
                           fused_resblock.reference_resblock_g(*args,
                                                               tf32=True))

    def test_one_pass_pack_keeps_hi(self):
        """The plain pack of the one-pass mode: the 3xTF32 pack's hi plane,
        zeros for lo (the pack kernel leaves lo unwritten)."""
        wt = _k2_inputs(1, 4, 4, 24, 64, seed=4)[5]
        plan = fused_modconv._plan(1, 4, 4, 24, 64, torch.float32)
        three = fused_modconv.pack_weights(wt, plan)
        one = fused_modconv.pack_weights(wt, plan, one_pass=True)
        assert torch.equal(one[:, :, :, :, 0], three[:, :, :, :, 0])
        assert not one[:, :, :, :, 1].any()


def _generator_case(remat: bool):
    cfg = jcfg.GeneratorConfig(n_channels=8, image_size=16, sentence_dim=16,
                               affine_hidden=24, remat_blocks=remat)
    torch.manual_seed(5)
    g = _with_gammas(Generator(pcfg.GeneratorConfig(
        **dataclasses.asdict(cfg))), 0.35)
    params = jimport.convert_torch_generator_state_dict(g.state_dict(), cfg)
    rng = np.random.default_rng(6)
    noise = rng.standard_normal((2, cfg.latent_dim)).astype(np.float32)
    sent = rng.standard_normal((2, 16)).astype(np.float32)
    r = rng.standard_normal((2, 16, 16, 3)).astype(np.float32) / 16
    return cfg, params, noise, sent, r


def _port_grads(cfg, params, noise, sent, r, remat: bool):
    g = Generator(pcfg.GeneratorConfig(**dict(
        dataclasses.asdict(cfg), remat_blocks=remat)))
    g.load_state_dict(pimport.generator_state_dict_from_jax(
        _np_tree(params)), strict=True)
    out = g(T(noise), T(sent))
    (out * T(r)).sum().backward()
    return out.detach(), {n: p.grad for n, p in g.named_parameters()}


class TestRematG:
    def test_generator_matches_jax_remat_and_port_without(self):
        """`generator_apply` with `remat_blocks` (its default order, each
        block under `jax.checkpoint`) and the port's Generator with it: the same images
        and parameter gradients at the trajectory tolerance; on the CPU the
        port with remat equals the port without bit for bit."""
        cfg, params, noise, sent, r = _generator_case(remat=True)

        def loss(p):
            img = jgen.generator_apply(p, cfg, jnp.asarray(noise),
                                       jnp.asarray(sent))
            return jnp.sum(img * r), img

        (_, want), jgrads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(params)
        want_grads = pimport.generator_state_dict_from_jax(_np_tree(jgrads))
        got, grads = _port_grads(cfg, params, noise, sent, r, remat=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
        assert set(grads) == set(want_grads)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        plain, plain_grads = _port_grads(cfg, params, noise, sent, r,
                                         remat=False)
        assert torch.equal(got, plain)
        for name, g in grads.items():
            assert torch.equal(g, plain_grads[name]), name

    @pytest.mark.parametrize("remat", [False, True])
    def test_remat_runs_each_block_twice_and_only_with_grad(self, remat):
        """A forward + backward runs each K2 DFBlock's forward twice under
        remat (the recompute), once without, and K1 bwd once a DFBlock
        either way; under `no_grad` (serving, eval) remat changes
        nothing."""
        cfg, params, noise, sent, r = _generator_case(remat=remat)
        g = Generator(pcfg.GeneratorConfig(**dataclasses.asdict(cfg)))
        calls = {"k2": 0, "bwd": 0}
        k2_forward = fused_modconv._forward
        k1_bwd = fused_affine.fused_double_affine_leaky_bwd

        def counted_k2(*a):
            calls["k2"] += 1
            return k2_forward(*a)

        def counted_bwd(*a, **k):
            calls["bwd"] += 1
            return k1_bwd(*a, **k)

        # K2 takes the DFBlocks whose Cout is a multiple of 32
        n_k2 = sum(2 for _, o in cfg.block_channels if o % 32 == 0)
        with mock.patch.object(fused_modconv, "_forward", counted_k2), \
                mock.patch.object(fused_affine,
                                  "fused_double_affine_leaky_bwd",
                                  counted_bwd):
            with torch.no_grad():
                g(T(noise), T(sent))
            assert calls == {"k2": n_k2, "bwd": 0} and n_k2 > 0
            calls.update(k2=0)
            (g(T(noise), T(sent)) * T(r)).sum().backward()
        assert calls == {"k2": n_k2 * (2 if remat else 1),
                         "bwd": 2 * len(cfg.block_channels)}

    def test_two_train_steps_match_jax_remat_step(self):
        """`make_train_step` of the port with `remat_blocks` against the
        JAX `make_train_step` with it, 2 steps from the same weights,
        batches and noise (as tests/test_torch_port_train.py's trajectory
        test): the losses at the trajectory tolerance each step, and the
        final G within a fifth of its drift of the JAX endpoint."""
        jc = jcfg.GANConfig(
            generator=jcfg.GeneratorConfig(n_channels=16, image_size=16,
                                           remat_blocks=True),
            discriminator=jcfg.DiscriminatorConfig(n_channels=4,
                                                   image_size=16),
            text_encoder=jcfg.TextEncoderConfig(vocab_size=30, embed_dim=8,
                                                hidden_dim=256, max_len=6),
            train=jcfg.TrainConfig(batch_size=4))
        pc = pcfg.GANConfig.from_dict(dataclasses.asdict(jc))
        assert pc.generator.remat_blocks
        pst = pstate.create_train_state(pc, seed=77, device="cpu")
        _with_gammas(pst.generator, 0.30)
        _with_gammas(pst.discriminator, 0.25)
        jst = _jax_state(pst, jc, 77)
        g_sd0 = {k: v.clone() for k, v in pst.generator.state_dict().items()}
        torch.manual_seed(3)
        pte = RNNEncoder(pc.text_encoder).eval()
        te = jte.convert_torch_state_dict(pte.state_dict(), jc.text_encoder)
        jstep = jax.jit(jax_make_train_step(jc))
        pstep = make_train_step(pc)
        rng = np.random.default_rng(9)
        for i in range(2):
            images = (rng.standard_normal((4, 16, 16, 3)) * 0.5).astype(
                np.float32)
            caps = rng.integers(1, 30, (4, 6)).astype(np.int32)
            lens = rng.integers(2, 7, (4,)).astype(np.int32)
            # the noise the JAX step draws from its state's key
            _, k_noise, _, _, _ = jax.random.split(jst.rng, 5)
            noise = np.array(jax.random.normal(k_noise, (4, 100)))
            jst, jm = jstep(jst, te, images, caps, lens)
            pm = pstep(pst, pte, T(images), T(caps), T(lens),
                       noise=T(noise))
            for k in ("d_loss", "d_gp_loss", "g_loss"):
                np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"step {i} {k}")
        final = pimport.generator_state_dict_from_jax(_np_tree(jst.g_params))
        got = pst.generator.state_dict()
        drift = max(float((final[k] - g_sd0[k]).abs().max()) for k in final)
        gap = max(float((got[k] - final[k]).abs().max()) for k in final)
        assert drift > 1e-4 and gap < drift / 5, (gap, drift)


def _small_cfg(**train):
    return pcfg.GANConfig(
        generator=pcfg.GeneratorConfig(n_channels=4, image_size=16,
                                       sentence_dim=16),
        discriminator=pcfg.DiscriminatorConfig(n_channels=4, image_size=16,
                                               sentence_dim=16),
        text_encoder=pcfg.TextEncoderConfig(vocab_size=20, embed_dim=8,
                                            hidden_dim=16, max_len=6),
        train=pcfg.TrainConfig(**train))


def _trainer(tmp_path, name, debug_nans=False, **train):
    cfg = _small_cfg(**train)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        te = RNNEncoder(cfg.text_encoder)
    return Trainer(cfg, te, str(tmp_path / name / "w"),
                   str(tmp_path / name / "i"), seed=3, device="cpu",
                   debug_nans=debug_nans)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"images": rng.integers(0, 256, (2, 16, 16, 3), np.uint8),
             "captions": rng.integers(1, 20, (2, 6)).astype(np.int32),
             "cap_lens": np.array([6, 4], np.int32)} for _ in range(n)]


class TestDevicePrefetch:
    @pytest.mark.parametrize("prefetch", [False, True])
    def test_epoch_uploads_one_ahead_and_equals_the_plain_loop(
            self, tmp_path, prefetch):
        """`train_epoch` issues batch i + 1's upload before step i, with
        `device_prefetch` or without it (kept for the JAX package's configs
        and command lines), and each step's metrics and the final state
        equal the plain loop's (upload, then step) bit for bit."""
        batches = _batches(3)
        plain = _trainer(tmp_path, "plain")
        want = [plain._step_fn(plain.state, plain.text_encoder,
                               *plain._device_batch(b)) for b in batches]
        trainer = _trainer(tmp_path, str(prefetch), device_prefetch=prefetch)
        order, got = [], []
        upload, step = trainer._device_batch, trainer._step_fn

        def logged_upload(batch):
            order.append("up")
            return upload(batch)

        def logged_step(*a, **k):
            order.append("step")
            got.append(step(*a, **k))
            return got[-1]

        trainer._device_batch = logged_upload
        trainer._step_fn = logged_step
        trainer.train_epoch(batches)
        trainer.close()
        plain.close()
        assert order == ["up", "up", "step", "up", "step", "step"]
        assert len(got) == len(want) == 3
        for i, (m, w) in enumerate(zip(got, want)):
            assert m.keys() == w.keys()
            for k in w:
                assert torch.equal(m[k], w[k]), (i, k)
        a, b = plain.state, trainer.state
        assert a.step == b.step == 3
        for ma, mb in ((a.generator, b.generator),
                       (a.discriminator, b.discriminator),
                       (a.g_ema, b.g_ema)):
            for (name, x), (_, y) in zip(ma.state_dict().items(),
                                         mb.state_dict().items()):
                assert torch.equal(x, y), name


def _nan_case(where: str):
    """A 16px port train state with a NaN in one weight of G or D, and
    its JAX TrainState."""
    jc = jcfg.GANConfig(
        generator=jcfg.GeneratorConfig(n_channels=8, image_size=16),
        discriminator=jcfg.DiscriminatorConfig(n_channels=4, image_size=16),
        text_encoder=jcfg.TextEncoderConfig(vocab_size=30, embed_dim=8,
                                            hidden_dim=256, max_len=6),
        train=jcfg.TrainConfig(batch_size=2))
    pc = pcfg.GANConfig.from_dict(dataclasses.asdict(jc))
    pst = pstate.create_train_state(pc, seed=1, device="cpu")
    w = pst.generator.res_blocks[0].conv_1.weight if where == "G" \
        else pst.discriminator.img_forward[0].weight
    with torch.no_grad():
        w[0, 0, 0, 0] = float("nan")
    return jc, pc, pst, _jax_state(pst, jc, 1)


class TestDebugNans:
    @pytest.mark.parametrize("where, phase", [("G", "G forward"),
                                              ("D", "phase 1 (D hinge)")])
    def test_nan_weight_raises_in_jax_and_port(self, where, phase):
        """A NaN in a G or D weight: JAX under `jax.debug_nans` raises
        FloatingPointError (G's forward, or D's on real images), and so
        does the port's step under `debug_nans`, naming the phase; without
        it the port's step runs on (its NaN guard)."""
        jc, pc, pst, jst = _nan_case(where)
        rng = np.random.default_rng(2)
        images = (rng.standard_normal((2, 16, 16, 3)) * 0.5).astype(
            np.float32)
        sent = rng.standard_normal((2, 256)).astype(np.float32)
        noise = rng.standard_normal((2, 100)).astype(np.float32)
        if where == "G":
            fn = jax.jit(lambda p: jgen.generator_apply(
                p, jc.generator, jnp.asarray(noise), jnp.asarray(sent)))
            params = jst.g_params
        else:
            from gan_codes_tpu.models import discriminator as jdisc
            fn = jax.jit(lambda p: jdisc.discriminator_embeds(
                p, jnp.asarray(images)))
            params = jst.d_params
        with jax.debug_nans(True):
            with pytest.raises(FloatingPointError):
                jax.block_until_ready(fn(params))

        te = RNNEncoder(pc.text_encoder).eval()
        caps = T(rng.integers(1, 30, (2, 6)))
        lens = T(np.array([6, 3]))
        for debug in (True, False):
            step = make_train_step(pc, debug_nans=debug)
            if debug:
                with pytest.raises(FloatingPointError,
                                   match=re.escape(phase)):
                    step(pst, te, T(images), caps, lens, noise=T(noise))
            else:
                metrics = step(pst, te, T(images), caps, lens,
                               noise=T(noise))
                assert pst.step == 1 and set(metrics) >= {"d_loss"}

    def test_fit_raises_to_its_caller(self, tmp_path):
        """The step's FloatingPointError is not eval's: it leaves
        `Trainer.fit` (so `train_entry` exits non-zero)."""
        trainer = _trainer(tmp_path, "nan", debug_nans=True)
        with torch.no_grad():
            trainer.state.generator.linear_in.weight[0, 0] = float("nan")
        with pytest.raises(FloatingPointError, match="G forward"):
            trainer.fit(_batches(2), _batches(1), num_epochs=1)
        trainer.close()
