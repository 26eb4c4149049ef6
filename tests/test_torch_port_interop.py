"""Checkpoint interop of the port on the CPU: the reference `checkpoint.pt`
import with both Adam states (`_adam_moments` by name, the lazy-state and
fresh-init cases as tests/test_torch_import.py holds the JAX package's),
resuming in `train_entry`; the `gen_N.pth` import and export with the CLI's
checks; and `tools/convert_checkpoint_torch.py` between a JAX and a port
weights directory, bit for bit both ways, with one port train step from a
converted state against one JAX step from the original.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_codes_tpu import config as jcfg
from gan_codes_tpu.models import torch_import as jimport
from gan_codes_tpu.models.text_encoder import init_text_encoder
from gan_codes_tpu.train import checkpoint as jckpt
from gan_codes_tpu.train import state as jstate
from gan_codes_tpu.train.step import make_train_step as jax_make_train_step
from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch import train_entry
from gan_codes_tpu_torch.data import make_synthetic_cub
from gan_codes_tpu_torch.models import torch_import as pimport
from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
from gan_codes_tpu_torch.train import checkpoint as pckpt
from gan_codes_tpu_torch.train.state import create_train_state
from gan_codes_tpu_torch.train.step import make_train_step
from gan_codes_tpu_torch.utils.seeding import fold_seed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import convert_checkpoint_torch as convert  # noqa: E402

HISTORIES = {"g_losses": [0.5, 0.4], "d_losses": [2.0, 1.9],
             "d_gp_losses": [0.1, 0.1], "txtimg_losses": [1.0, 0.9],
             "is_scores": [1.0, 1.5], "fid_scores": [float("inf"), 8.0]}


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _ref_adam(model_sd, step, seed, skip=()):
    """A torch Adam state_dict in the reference's layout: state keyed by
    the index in `model_sd`'s order, none for the indexes in `skip`."""
    g = torch.Generator().manual_seed(seed)
    state = {i: {"step": torch.tensor(float(step)),
                 "exp_avg": torch.randn(v.shape, generator=g),
                 "exp_avg_sq": torch.rand(v.shape, generator=g)}
             for i, v in enumerate(model_sd.values()) if i not in skip}
    return {"state": state,
            "param_groups": [{"params": list(range(len(model_sd)))}]}


def _port_state(cfg, seed=0):
    """A CPU train state with every block gamma away from 0."""
    st = create_train_state(cfg, seed=seed, device="cpu")
    with torch.no_grad():
        for module in (st.generator, st.discriminator, st.g_ema):
            for name, p in module.named_parameters():
                if name.endswith(".gamma"):
                    p.fill_(0.3)
    return st


def _assert_equal_sd(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v.cpu()), (what, k)


class TestAdamMoments:
    def _sd(self):
        g = torch.Generator().manual_seed(4)
        return {"a.weight": torch.randn(3, 2, generator=g),
                "b.weight": torch.randn(4, generator=g)}

    def test_reference_key_order_is_the_jax_exports(self, jax_dir):
        """`reference_order` gives the reference's order (the JAX
        package's export writes it); the port's own order differs, which
        is why the moments go by name."""
        _, jst = jax_dir
        st = create_train_state(pcfg.GANConfig.from_dict(
            dataclasses.asdict(JCFG)), seed=0, device="cpu")
        for module, export in (
                (st.generator, jimport.export_generator_state_dict(
                    _np(jst.g_params))),
                (st.discriminator, jimport.export_discriminator_state_dict(
                    _np(jst.d_params)))):
            own = module.state_dict()
            assert list(pimport.reference_order(own)) == list(export)
            assert list(own) != list(export)

    def test_moments_land_by_name_in_the_ports_order(self):
        cfg = pcfg.GANConfig.for_image_size(16, n_channels=4)
        st = create_train_state(cfg, seed=0, device="cpu")
        ref_sd = pimport.reference_order(st.generator.state_dict())
        opt = _ref_adam(ref_sd, step=9, seed=1)
        exp_avg, exp_avg_sq, count = pimport._adam_moments(opt, ref_sd)
        assert count == 9
        names = [n for n, _ in st.generator.named_parameters()]
        st.g_opt.adam.load_state_dict(pimport.adam_state_dict(
            st.g_opt.adam, names, (exp_avg, exp_avg_sq, count)))
        by_param = st.g_opt.adam.state
        for i, k in enumerate(ref_sd):
            p = dict(st.generator.named_parameters())[k]
            assert torch.equal(by_param[p]["exp_avg"],
                               opt["state"][i]["exp_avg"]), k
            assert torch.equal(by_param[p]["exp_avg_sq"],
                               opt["state"][i]["exp_avg_sq"]), k
            assert float(by_param[p]["step"]) == 9.0

    def test_param_missing_from_state_gets_zero_moments(self, capsys):
        sd = self._sd()
        opt = _ref_adam(sd, step=9, seed=20, skip=(1,))
        mu, nu, count = pimport._adam_moments(opt, sd)
        assert count == 9
        assert torch.equal(mu["b.weight"], torch.zeros(4))
        assert torch.equal(nu["b.weight"], torch.zeros(4))
        assert torch.equal(mu["a.weight"], opt["state"][0]["exp_avg"])
        assert "zero moments substituted" in capsys.readouterr().out

    def test_no_state_for_any_group_param_is_fresh_init(self, capsys):
        sd = self._sd()
        opt = _ref_adam(sd, step=3, seed=20)
        opt["state"] = {99: opt["state"][0]}
        assert pimport._adam_moments(opt, sd) is None
        out = capsys.readouterr().out
        assert "fresh Adam init" in out
        assert "zero moments substituted" not in out
        opt["state"] = {}  # never stepped
        assert pimport._adam_moments(opt, sd) is None
        with pytest.raises(ValueError, match="not a matching checkpoint"):
            pimport._adam_moments(_ref_adam({"x": torch.zeros(1)}, 1, 0), sd)


def _reference_checkpoint(tmp_path):
    """A reference checkpoint.pt at 16px, n_channels 4: reference key
    order, a D parameter with no Adam entry, numpy-scalar histories.
    Returns (its contents, its path, the port state it was made from)."""
    cfg = pcfg.GANConfig.for_image_size(16, n_channels=4)
    st = _port_state(cfg, seed=3)
    g_sd = pimport.reference_order(st.generator.state_dict())
    d_sd = pimport.reference_order(st.discriminator.state_dict())
    missing = list(d_sd).index("img_forward.1.gamma")
    ck = {"generator": g_sd, "discriminator": d_sd,
          "g_optimizer": _ref_adam(g_sd, step=7, seed=32),
          "d_optimizer": _ref_adam(d_sd, step=14, seed=33,
                                   skip=(missing,)),
          "epoch": 2,
          "g_losses": [np.float64(0.5), np.float64(0.4), np.float64(0.3)],
          "d_losses": [2.0, 1.9, 1.8], "d_gp_losses": [0.1] * 3,
          "txtimg_losses": [1.0, 0.9, 0.8], "is_scores": [1.0] * 3,
          "fid_scores": [9.0, 8.0, 7.0]}
    pt = str(tmp_path / "checkpoint.pt")
    torch.save(ck, pt)
    return ck, pt, st


class TestReferenceImport:
    def test_checkpoint_pt_resumes_in_train_entry(self, tmp_path, capsys):
        """A reference checkpoint.pt (reference key order, a D parameter
        with no Adam entry, numpy-scalar histories) imports through the
        CLI; the checkpoint holds G, D, both Adam states and the step bit
        for bit, and train_entry resumes it for one more epoch."""
        root = str(tmp_path / "data")
        info = make_synthetic_cub(root, n_train=4, n_test=2, image_size=24)
        ck, pt, st = _reference_checkpoint(tmp_path)
        g_sd, d_sd = ck["generator"], ck["discriminator"]
        wdir = str(tmp_path / "weights")
        pimport._cli(["--ckpt", pt, "--out", wdir, "--vocab-size",
                      str(info["n_words"]), "--batch-size", "2"])
        assert "1 param(s) had no Adam state" in capsys.readouterr().out

        blob = torch.load(os.path.join(wdir, "checkpoint"),
                          weights_only=True)
        assert blob["step"] == 7
        assert blob["rng"] == fold_seed(123321, 2)
        _assert_equal_sd(blob["generator"], g_sd, "generator")
        _assert_equal_sd(blob["g_ema"], g_sd, "g_ema")
        _assert_equal_sd(blob["discriminator"], d_sd, "discriminator")
        for module, opt, key, sd in (
                (st.generator, "g_opt", "g_optimizer", g_sd),
                (st.discriminator, "d_opt", "d_optimizer", d_sd)):
            names = [n for n, _ in module.named_parameters()]
            ref_index = {k: i for i, k in enumerate(sd)}
            for i, n in enumerate(names):
                got = blob[opt]["state"][i]
                src = ck[key]["state"].get(ref_index[n])
                for f in ("exp_avg", "exp_avg_sq"):
                    want = src[f] if src else torch.zeros_like(sd[n])
                    assert torch.equal(got[f], want), (opt, n, f)
                assert float(got["step"]) == (7.0 if opt == "g_opt"
                                              else 14.0)
        saved = pckpt.CheckpointManager(wdir).load_config()
        assert saved.train.seed == 123321 and saved.train.batch_size == 2
        for f in ("gen_2.pth", "gen_ema_2.pth", "histories.json"):
            assert os.path.exists(os.path.join(wdir, f)), f

        hist = train_entry.main([
            "--data", root, "--image-size", "16", "--n-channels", "4",
            "--batch-size", "2", "--epochs", "4", "--device", "cpu",
            "--weights", wdir, "--images", str(tmp_path / "images")])
        assert "Resuming from epoch 3" in capsys.readouterr().out
        assert hist["g_losses"][:3] == [0.5, 0.4, 0.3]
        assert len(hist["g_losses"]) == 4 and np.isfinite(
            hist["g_losses"][3])
        after = torch.load(os.path.join(wdir, "checkpoint"),
                           weights_only=True)
        assert after["step"] == 9  # 2 steps of the resumed epoch

    def test_checkpoint_pt_import_matches_the_jax_import(self, tmp_path):
        """The same checkpoint.pt through the JAX package's
        import_training_checkpoint and the port's: G, D, EMA, both Adam
        states (the zero moments of the D parameter with no entry
        included), each Adam count, the step, the histories and the
        recorded seed and batch size agree bit for bit through the
        converter's maps."""
        ck, pt, st = _reference_checkpoint(tmp_path)
        jdir, wdir = str(tmp_path / "jax"), str(tmp_path / "port")
        assert jimport.import_training_checkpoint(
            pt, jdir, seed=5, batch_size=2) == 2
        assert pimport.import_training_checkpoint(
            pt, wdir, seed=5, batch_size=2) == 2
        jst, jepoch, jhist = _restore_jax(jdir)
        blob = torch.load(os.path.join(wdir, "checkpoint"),
                          weights_only=True)
        assert jepoch == 2 and int(jst.step) == blob["step"] == 7
        for key, tree, to_sd in (
                ("generator", jst.g_params,
                 pimport.generator_state_dict_from_jax),
                ("g_ema", jst.g_ema_params,
                 pimport.generator_state_dict_from_jax),
                ("discriminator", jst.d_params,
                 pimport.discriminator_state_dict_from_jax)):
            _assert_equal_sd(blob[key], to_sd(_np(tree)), key)
        for module, opt, opt_state, to_sd, count in (
                (st.generator, "g_opt", jst.g_opt_state,
                 pimport.generator_state_dict_from_jax, 7),
                (st.discriminator, "d_opt", jst.d_opt_state,
                 pimport.discriminator_state_dict_from_jax, 14)):
            adam = convert.find_adam(opt_state)
            assert int(adam.count) == count, opt
            mu, nu = to_sd(_np(adam.mu)), to_sd(_np(adam.nu))
            for i, (n, _) in enumerate(module.named_parameters()):
                got = blob[opt]["state"][i]
                assert torch.equal(got["exp_avg"], mu[n]), (opt, n)
                assert torch.equal(got["exp_avg_sq"], nu[n]), (opt, n)
                assert float(got["step"]) == count, (opt, n)
        with open(os.path.join(wdir, "histories.json")) as f:
            assert json.load(f) == dict(jhist, epoch=jepoch)
        jc = jckpt.CheckpointManager(jdir).load_config()
        pc = pckpt.CheckpointManager(wdir).load_config()
        assert (pc.train.seed, pc.train.batch_size) == \
            (jc.train.seed, jc.train.batch_size) == (5, 2)
        assert dataclasses.asdict(pc.generator) == \
            dataclasses.asdict(jc.generator)

    def test_gen_import_export_and_cli_checks(self, tmp_path, capsys):
        """--gen writes config.json, gen_N.pth and gen_ema_N.pth (the same
        weights), which build_sampler serves; --export writes them back;
        the CLI refuses flags that do not apply."""
        cfg = pcfg.GANConfig.for_image_size(16, n_channels=4)
        st = _port_state(cfg, seed=5)
        sd = pimport.reference_order(st.generator.state_dict())
        src = str(tmp_path / "gen_5.pth")
        torch.save(sd, src)
        wdir = str(tmp_path / "weights")
        pimport._cli(["--gen", src, "--out", wdir, "--epoch", "2"])
        assert sorted(os.listdir(wdir)) == ["config.json", "gen_2.pth",
                                            "gen_ema_2.pth"]
        for name in ("gen_2.pth", "gen_ema_2.pth"):
            _assert_equal_sd(torch.load(os.path.join(wdir, name),
                                        weights_only=True), sd, name)
        assert pckpt.CheckpointManager(wdir).load_config().generator == \
            cfg.generator
        out = str(tmp_path / "exported.pth")
        pimport._cli(["--export", wdir, "--out", out, "--ema"])
        exported = torch.load(out, weights_only=True)
        _assert_equal_sd(exported, sd, "export")
        assert list(exported) == list(sd)  # the reference's key order
        with pytest.raises(FileNotFoundError, match="gen_7.pth"):
            pimport.export_generator_checkpoint(wdir, out, epoch=7)
        for argv, message in (
                (["--ckpt", src, "--epoch", "1"], "--epoch is not valid"),
                (["--gen", src, "--vocab-size", "5"], "only apply to --ckpt"),
                (["--gen", src, "--ema"], "--ema only applies"),
                (["--gen", src, "--export", wdir], "not allowed with")):
            with pytest.raises(SystemExit):
                pimport._cli(argv + ["--out", str(tmp_path / "x")])
            assert message in capsys.readouterr().err


# -- the converter ------------------------------------------------------

JCFG = jcfg.GANConfig(
    generator=jcfg.GeneratorConfig(n_channels=4, image_size=16,
                                   sentence_dim=16, affine_hidden=8),
    discriminator=jcfg.DiscriminatorConfig(n_channels=4, image_size=16,
                                           sentence_dim=16),
    text_encoder=jcfg.TextEncoderConfig(vocab_size=30, embed_dim=8,
                                        hidden_dim=16, max_len=6),
    train=jcfg.TrainConfig(batch_size=4))


def _random_adam(opt_state, seed):
    """The chain's Adam state with seeded random mu, positive nu and
    count 7 (as if 7 steps had run)."""
    rng = np.random.default_rng(seed)
    adam = convert.find_adam(opt_state)
    new = adam._replace(
        count=jnp.asarray(7, jnp.int32),
        mu=jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape), x.dtype) * 1e-2, adam.mu),
        nu=jax.tree.map(lambda x: jnp.asarray(
            rng.uniform(0.1, 1.0, x.shape), x.dtype) * 1e-5, adam.nu))
    return jimport._inject_adam(opt_state, (new.mu, new.nu, 7))


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A JAX weights dir: epoch 1's state (gammas away from 0, random Adam
    states, step 7) with gen_0 and gen_1 trees."""
    root = tmp_path_factory.mktemp("jax")
    st = jstate.create_train_state(jax.random.PRNGKey(77), JCFG)
    for tree, base in ((st.g_params, 0.3), (st.d_params, 0.25)):
        for i, bp in enumerate(tree["blocks"]):
            bp["gamma"] = jnp.asarray(base + 0.07 * i, jnp.float32)
    st = st.replace(
        step=jnp.asarray(7, jnp.int32),
        g_ema_params=jax.tree.map(lambda x: x * 0.5, st.g_params),
        g_opt_state=_random_adam(st.g_opt_state, 1),
        d_opt_state=_random_adam(st.d_opt_state, 2))
    mgr = jckpt.CheckpointManager(str(root / "w"))
    mgr.save_generator(0, st.replace(
        g_ema_params=jax.tree.map(lambda x: x * 0.25, st.g_params)))
    mgr.save(1, st, HISTORIES, config=JCFG)
    return str(root / "w"), st


def _jax_leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(la, lb))


def _restore_jax(directory):
    mgr = jckpt.CheckpointManager(directory)
    template = jax.eval_shape(
        lambda k: jstate.create_train_state(k, mgr.load_config()),
        jax.random.PRNGKey(0))
    return mgr.restore(template)


class TestConverter:
    def test_jax_port_jax_round_trip(self, jax_dir, tmp_path):
        """G, D, EMA, both Adam states (mu, nu, count), the step, the
        histories and every gen_N tree come back bit for bit; the port
        directory between holds them in the port's layout."""
        src, st = jax_dir
        port = str(tmp_path / "port")
        back = str(tmp_path / "back")
        assert convert.jax_to_port(src, port) == 1
        blob = torch.load(os.path.join(port, "checkpoint"),
                          weights_only=True)
        assert blob["step"] == 7 and isinstance(blob["rng"], int)
        g_sd = pimport.generator_state_dict_from_jax(_np(st.g_params))
        _assert_equal_sd(blob["generator"], g_sd, "generator")
        mu = pimport.generator_state_dict_from_jax(
            _np(convert.find_adam(st.g_opt_state).mu))
        # the port's parameter order is its state_dict's
        for i, n in enumerate(blob["generator"]):
            assert torch.equal(blob["g_opt"]["state"][i]["exp_avg"], mu[n])
            assert float(blob["g_opt"]["state"][i]["step"]) == 7.0
        assert sorted(os.listdir(port)) == sorted(
            ["checkpoint", "config.json", "histories.json", "gen_0.pth",
             "gen_ema_0.pth", "gen_1.pth", "gen_ema_1.pth"])

        assert convert.port_to_jax(port, back) == 1
        got, epoch, hist = _restore_jax(back)
        assert epoch == 1 and hist == HISTORIES
        assert int(got.step) == 7
        for field in ("g_params", "d_params", "g_ema_params"):
            assert _jax_leaves_equal(getattr(got, field),
                                     getattr(st, field)), field
        for field in ("g_opt_state", "d_opt_state"):
            a = convert.find_adam(getattr(got, field))
            b = convert.find_adam(getattr(st, field))
            assert int(a.count) == int(b.count) == 7
            assert _jax_leaves_equal(a.mu, b.mu) and \
                _jax_leaves_equal(a.nu, b.nu), field
        for ep in (0, 1):
            a = jckpt.CheckpointManager(back).restore_generator_tree(
                JCFG.generator, ep)[0]
            b = jckpt.CheckpointManager(src).restore_generator_tree(
                JCFG.generator, ep)[0]
            assert _jax_leaves_equal(a, b), ep

    def test_port_jax_port_round_trip(self, tmp_path):
        """A port state trained nowhere but with random Adam states, step
        7: port -> JAX -> port gives every tensor back bit for bit."""
        pc = pcfg.GANConfig.from_dict(dataclasses.asdict(JCFG))
        st = _port_state(pc, seed=9)
        gen = torch.Generator().manual_seed(3)
        for module, opt in ((st.generator, st.g_opt),
                            (st.discriminator, st.d_opt)):
            named = dict(module.named_parameters())
            moments = ({n: torch.randn(p.shape, generator=gen)
                        for n, p in named.items()},
                       {n: torch.rand(p.shape, generator=gen)
                        for n, p in named.items()}, 7)
            opt.adam.load_state_dict(pimport.adam_state_dict(
                opt.adam, list(named), moments))
        st.step = 7
        src = str(tmp_path / "port")
        pckpt.CheckpointManager(src).save(0, st, HISTORIES, config=pc)
        assert convert.port_to_jax(src, str(tmp_path / "jax")) == 0
        assert convert.jax_to_port(str(tmp_path / "jax"),
                                   str(tmp_path / "again")) == 0
        a = torch.load(os.path.join(src, "checkpoint"), weights_only=True)
        b = torch.load(os.path.join(tmp_path / "again", "checkpoint"),
                       weights_only=True)
        assert a["step"] == b["step"] == 7
        for key in ("generator", "discriminator", "g_ema"):
            _assert_equal_sd(b[key], a[key], key)
        for opt in ("g_opt", "d_opt"):
            assert a[opt]["param_groups"] == b[opt]["param_groups"]
            for i, s in a[opt]["state"].items():
                for f, v in s.items():
                    assert torch.equal(b[opt]["state"][i][f], v), (opt, i, f)
        with open(tmp_path / "again" / "histories.json") as f:
            assert json.load(f)["fid_scores"] == ["Infinity", 8.0]

    def test_one_step_from_the_converted_state_matches_jax(self, jax_dir,
                                                           tmp_path):
        """One port step from the converted directory (restored by the
        port's CheckpointManager) against one JAX step from the original,
        on the same batch and noise: the losses and every updated G and D
        parameter at rtol 2e-4 / atol 2e-5. The random nu and count 7 set
        the size of each update, so a moment in the wrong place moves a
        parameter by far more than the tolerance."""
        src, jst = jax_dir
        port = str(tmp_path / "port")
        convert.jax_to_port(src, port)
        pc = pckpt.CheckpointManager(port).load_config()
        pst, epoch, _ = pckpt.CheckpointManager(port).restore(
            create_train_state(pc, seed=0, device="cpu"))
        assert epoch == 1 and pst.step == 7
        te = init_text_encoder(jax.random.PRNGKey(3), JCFG.text_encoder)
        pte = RNNEncoder(pc.text_encoder).eval()
        pte.load_state_dict(pimport.text_encoder_state_dict_from_jax(
            _np(te)), strict=True)
        rng = np.random.default_rng(0)
        images = rng.standard_normal((4, 16, 16, 3)).astype(np.float32) * .5
        caps = rng.integers(1, 30, (4, 6)).astype(np.int32)
        lens = rng.integers(2, 7, (4,)).astype(np.int32)
        _, k_noise, _, _, _ = jax.random.split(jst.rng, 5)
        noise = np.array(jax.random.normal(k_noise, (4, 100)))
        jst1, jm = jax.jit(jax_make_train_step(JCFG))(
            jst, te, jnp.asarray(images), jnp.asarray(caps),
            jnp.asarray(lens))
        pm = make_train_step(pc)(pst, pte, torch.from_numpy(images),
                                 torch.from_numpy(caps).long(),
                                 torch.from_numpy(lens).long(),
                                 noise=torch.from_numpy(noise))
        for k in ("d_loss", "d_gp_loss", "g_loss"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=2e-4, atol=2e-5, err_msg=k)
        assert pst.step == int(jst1.step) == 8
        moved = 0.0
        for module, before, after in (
                (pst.generator, jst.g_params, jst1.g_params),
                (pst.discriminator, jst.d_params, jst1.d_params)):
            to_sd = (pimport.generator_state_dict_from_jax
                     if module is pst.generator
                     else pimport.discriminator_state_dict_from_jax)
            want, was = to_sd(_np(after)), to_sd(_np(before))
            for k, v in module.state_dict().items():
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           rtol=2e-4, atol=2e-5, err_msg=k)
                moved = max(moved, float((want[k] - was[k]).abs().max()))
        assert moved > 10 * 2e-5, moved
