"""The port's training entry point on the CPU: the CUB data pipeline
(gan_codes_tpu_torch/data) against the JAX package's, the checkpoint
round trip and config.json against the JAX config, the trainer's epoch
loop, and a killed-and-resumed `train_entry.train` run against its
uninterrupted twin (the pattern of tests/test_e2e.py::
test_resume_is_bit_identical_to_uninterrupted), plus the small utilities
the trainer uses (jsonio, the metrics log, the step timer, image dumps).
"""
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from gan_codes_tpu import config as jcfg
from gan_codes_tpu import data as jdata
from gan_codes_tpu.utils import image_io as jimage_io
from gan_codes_tpu.utils import jsonio as jjsonio
from gan_codes_tpu.utils import plotting as jplotting
from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch import data as pdata
from gan_codes_tpu_torch import serve, train_entry
from gan_codes_tpu_torch.eval import metrics
from gan_codes_tpu_torch.models.inception import (
    init_inception, random_torchvision_state_dict)
from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
from gan_codes_tpu_torch.train import checkpoint as pckpt
from gan_codes_tpu_torch.train.state import create_train_state
from gan_codes_tpu_torch.train.step import make_train_step
from gan_codes_tpu_torch.train.trainer import Trainer
from gan_codes_tpu_torch.utils import image_io, jsonio, plotting, profiling
from torch_port_env import one_thread_children  # noqa: E402,F401


@pytest.fixture(scope="module")
def cub(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cub"))
    pdata.make_synthetic_cub(root, n_train=8, n_test=4, image_size=48)
    return root


def _small_cfg(**train):
    return pcfg.GANConfig(
        generator=pcfg.GeneratorConfig(n_channels=4, image_size=16,
                                       sentence_dim=16),
        discriminator=pcfg.DiscriminatorConfig(n_channels=4, image_size=16,
                                               sentence_dim=16),
        text_encoder=pcfg.TextEncoderConfig(vocab_size=20, embed_dim=8,
                                            hidden_dim=16, max_len=6),
        train=pcfg.TrainConfig(**train))


def _text_encoder(cfg, seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return RNNEncoder(cfg.text_encoder)


def _assert_same(a, b, path="state"):
    """Equal nested dicts / lists of tensors and plain values, bit for
    bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


class TestData:
    def test_synthetic_fixture_equals_jax(self, tmp_path):
        for pkg, name in ((pdata, "port"), (jdata, "jax")):
            pkg.make_synthetic_cub(str(tmp_path / name), n_train=3,
                                   n_test=2, image_size=32, seed=4)
        files = []
        for dirpath, _, names in os.walk(tmp_path / "port"):
            files += [os.path.relpath(os.path.join(dirpath, n),
                                      tmp_path / "port") for n in names]
        assert len(files) == 5 + 5  # 5 index/caption files, 5 JPEGs
        for rel in files:
            with open(tmp_path / "port" / rel, "rb") as f, \
                    open(tmp_path / "jax" / rel, "rb") as g:
                assert f.read() == g.read(), rel

    @pytest.mark.parametrize("split", ["train", "test"])
    def test_loader_yields_jax_bytes(self, cub, split):
        """The same seed gives the same batches, byte for byte, at epochs
        0 and 1 (the train loader shuffles and augments; the test loader
        is the trainer's: in order, no augmentation)."""
        train = split == "train"
        loaders = []
        for pkg, cfg_mod in ((pdata, pcfg), (jdata, jcfg)):
            ds = pkg.CUBDataset(cfg_mod.DataConfig(data_dir=cub,
                                                   image_size=32),
                                split, augment=train)
            loaders.append(pkg.DataLoader(ds, 2, shuffle=train, seed=17))
        for epoch in (0, 1):
            batches = []
            for loader in loaders:
                loader.set_epoch(epoch)
                batches.append(list(loader))
            got, want = batches
            assert len(got) == len(want) == (4 if train else 2)
            for g, w in zip(got, want):
                assert g["images"].dtype == np.uint8
                for key in ("images", "captions", "cap_lens"):
                    np.testing.assert_array_equal(g[key], w[key])
                assert g["file_names"] == w["file_names"]

    def test_batch_helpers_match_jax(self, cub):
        ds = pdata.CUBDataset(pcfg.DataConfig(data_dir=cub, image_size=32))
        batch = next(iter(pdata.DataLoader(ds, 4, seed=3)))
        from gan_codes_tpu.data import utils as jutils
        from gan_codes_tpu_torch.data import utils as putils
        got = putils.sort_batch_by_length(batch)
        want = jutils.sort_batch_by_length(batch)
        for key in ("images", "captions", "cap_lens"):
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(
            putils.normalize_images_np(batch["images"]),
            jutils.normalize_images_np(batch["images"]))


class TestCheckpoint:
    def _stepped_state(self, seed):
        """A small CPU state after one train step (Adam moments filled)."""
        cfg = _small_cfg(batch_size=2)
        state = create_train_state(cfg, seed, device="cpu")
        rng = np.random.default_rng(seed)
        images = torch.from_numpy(
            rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32))
        caps = torch.from_numpy(rng.integers(1, 20, (2, 6)))
        lens = torch.tensor([6, 3])
        make_train_step(cfg)(state, _text_encoder(cfg), images, caps, lens)
        return cfg, state

    def test_round_trip_is_bit_exact(self, tmp_path):
        cfg, state = self._stepped_state(0)
        ckpt = pckpt.CheckpointManager(str(tmp_path), numbered_every=1)
        hist = pckpt.empty_histories()
        hist["fid_scores"].append(float("inf"))
        ckpt.save(0, state, hist, config=cfg)
        saved = pckpt.state_to_dict(state)
        assert saved["g_opt"]["state"] and saved["step"] == 1
        _, fresh = self._stepped_state(1)
        fresh.rng.manual_seed(99)
        restored, epoch, hist2 = ckpt.restore(fresh)
        assert epoch == 0 and hist2 == hist
        _assert_same(pckpt.state_to_dict(restored), saved)
        # the step's generator continues where the saved one was
        assert torch.equal(torch.randn(4, generator=restored.rng),
                           torch.randn(4, generator=state.rng))
        names = set(os.listdir(tmp_path))
        assert {"checkpoint", "checkpoint_epoch_0", "gen_0.pth",
                "gen_ema_0.pth", "histories.json",
                "config.json"} <= names
        assert not [n for n in names if n.endswith(".tmp")]
        assert serve.latest_generator_weights(str(tmp_path)) == (
            str(tmp_path / "gen_0.pth"), 0)
        # histories.json stays standard JSON (the FID inf sentinel)
        with open(tmp_path / "histories.json") as f:
            assert json.load(f)["fid_scores"] == ["Infinity"]

    def test_config_json_reads_back_through_jax(self, tmp_path):
        cfg = pcfg.GANConfig.for_image_size(
            32, n_channels=8, vocab_size=20,
            loss_overrides={"gp_interval": 2, "damsm_weight": 0.5},
            batch_size=4, num_epochs=3, seed=7, compute_dtype="bfloat16",
            eval_every_epochs=2, log_every_steps=1)
        pckpt.CheckpointManager(str(tmp_path)).save_config(cfg)
        with open(tmp_path / "config.json") as f:
            blob = json.load(f)
        assert dataclasses.asdict(jcfg.GANConfig.from_dict(blob)) \
            == dataclasses.asdict(cfg) == blob

    def test_verify_config(self, tmp_path):
        cfg = _small_cfg()
        ckpt = pckpt.CheckpointManager(str(tmp_path))
        ckpt.verify_config(cfg)  # no config.json yet: nothing to hold
        ckpt.save_config(cfg)
        ckpt.verify_config(dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, num_epochs=9)))
        with pytest.raises(ValueError, match="generator.n_channels"):
            ckpt.verify_config(dataclasses.replace(
                cfg, generator=dataclasses.replace(cfg.generator,
                                                   n_channels=8)))
        assert "train.num_epochs" in pckpt.CONFIG_RESUME_MUTABLE


def _run(cub, weights, images, epochs, te_path=None):
    return train_entry.train(cub, te_path, images, weights, image_size=32,
                             batch_size=4, num_epochs=epochs, seed=5,
                             n_channels=8, device="cpu")


@pytest.fixture(scope="module")
def twins(cub, tmp_path_factory):
    """An uninterrupted 2-epoch run and a run killed after epoch 1 and
    resumed to 2 (a fresh Trainer per call), with one text encoder file."""
    work = tmp_path_factory.mktemp("twins")
    cfg = pcfg.GANConfig.for_image_size(32, n_channels=8, vocab_size=20)
    te_path = str(work / "text_encoder.pth")
    torch.save(_text_encoder(cfg, seed=3).state_dict(), te_path)
    out = {"te": te_path, "work": work}
    out["straight"] = _run(cub, str(work / "a_w"), str(work / "a_i"), 2,
                           te_path)
    out["first_leg"] = _run(cub, str(work / "b_w"), str(work / "b_i"), 1,
                            te_path)
    out["resumed"] = _run(cub, str(work / "b_w"), str(work / "b_i"), 2,
                          te_path)
    return out


class TestTrainEntry:
    def test_resume_is_bit_identical_to_uninterrupted(self, twins):
        work = twins["work"]
        assert twins["resumed"] == twins["straight"]
        blobs = [torch.load(work / w / "checkpoint", weights_only=True)
                 for w in ("a_w", "b_w")]
        assert blobs[0]["step"] == 4
        _assert_same(blobs[1], blobs[0])
        for name in ("gen_1.pth", "gen_ema_1.pth"):
            _assert_same(torch.load(work / "b_w" / name, weights_only=True),
                         torch.load(work / "a_w" / name, weights_only=True))

    def test_run_writes_its_files(self, twins):
        work = twins["work"]
        for run in ("a", "b"):
            names = set(os.listdir(work / f"{run}_w"))
            assert {"checkpoint", "histories.json", "config.json",
                    "metrics_log.jsonl", "gen_0.pth", "gen_1.pth",
                    "gen_ema_1.pth"} <= names
            with open(work / f"{run}_w" / "metrics_log.jsonl") as f:
                rows = [json.loads(line) for line in f]
            assert [r["epoch"] for r in rows] == [0, 1]  # one row each
            assert rows[-1]["fid_score"] == "Infinity"
            imgs = set(os.listdir(work / f"{run}_i"))
            assert {"fake_sample_epoch_0.png",
                    "fake_sample_epoch_1.png"} <= imgs
        assert twins["straight"]["is_scores"] == [1.0, 1.0]
        assert twins["straight"]["fid_scores"] == [float("inf")] * 2

    def test_resume_prints_and_gen_serves(self, twins, cub, capsys):
        """A third call resumes from epoch 2 (nothing left to train), and
        the trained gen_N.pth serves through build_sampler unchanged."""
        work = twins["work"]
        _run(cub, str(work / "b_w"), str(work / "b_i"), 2, twins["te"])
        assert "Resuming from epoch 2" in capsys.readouterr().out
        sampler, epoch = serve.build_sampler(cub, twins["te"],
                                             str(work / "b_w"), batch_size=2,
                                             device="cpu")
        assert epoch == 1 and sampler.cfg.generator.image_size == 32
        images = sampler.generate_tokens(np.ones((3, 18), np.int64),
                                         np.asarray([1, 2, 3]))
        assert images.shape == (3, 32, 32, 3)
        assert np.isfinite(images).all()

    def test_inception_records_finite_is_and_fid(self, cub, tmp_path):
        """`--inception` with a seeded random torchvision-layout .pth: a
        one-epoch 32px run on the CPU records a finite IS >= 1 and a finite
        FID (the low-rank cross term, 4 images a side) in
        metrics_log.jsonl; `--eval-sqrtm` reaches config.json."""
        path = str(tmp_path / "inception.pth")
        torch.save(random_torchvision_state_dict(
            torch.Generator().manual_seed(1)), path)
        hist = train_entry.main([
            "--data", cub, "--inception", path, "--device", "cpu",
            "--image-size", "32", "--batch-size", "4", "--epochs", "1",
            "--n-channels", "8", "--seed", "5", "--eval-sqrtm",
            "newton_schulz", "--weights", str(tmp_path / "w"),
            "--images", str(tmp_path / "i")])
        with open(tmp_path / "w" / "metrics_log.jsonl") as f:
            rows = [json.loads(line) for line in f]
        assert len(rows) == 1
        is_score, fid = rows[0]["is_score"], rows[0]["fid_score"]
        assert np.isfinite(is_score) and is_score >= 1.0
        assert isinstance(fid, float) and np.isfinite(fid) and fid > 0
        assert hist["is_scores"] == [is_score]
        assert hist["fid_scores"] == [fid]
        with open(tmp_path / "w" / "config.json") as f:
            assert json.load(f)["train"]["eval_sqrtm"] == "newton_schulz"

    def test_deterministic_sets_cudnn_for_the_call(self, cub, tmp_path,
                                                   monkeypatch):
        """`--deterministic` turns on cuDNN's deterministic algorithms for
        the call's training, and the flag is restored after it, also when
        the training raises."""
        seen = []

        class Stub:
            def __init__(self, *a, **k):
                pass

            def fit(self, *a, **k):
                seen.append(torch.backends.cudnn.deterministic)
                if len(seen) == 3:
                    raise RuntimeError("stop")
                return {k: [] for k in ("g_losses", "d_losses")}

            def close(self):
                pass

        monkeypatch.setattr(train_entry, "Trainer", Stub)
        argv = ["--data", cub, "--device", "cpu", "--image-size", "32",
                "--batch-size", "4", "--epochs", "1", "--n-channels", "8",
                "--weights", str(tmp_path / "w"), "--images",
                str(tmp_path / "i")]
        assert not torch.backends.cudnn.deterministic
        train_entry.main(argv)
        train_entry.main(argv + ["--deterministic"])
        assert not torch.backends.cudnn.deterministic
        with pytest.raises(RuntimeError, match="stop"):
            train_entry.main(argv + ["--deterministic"])
        assert seen == [False, True, True]
        assert not torch.backends.cudnn.deterministic


class _Loader(list):
    """A test loader: its batches, `shuffle`, and `dataset.augment`."""
    shuffle = False

    def __init__(self, batches, augment=False):
        super().__init__(batches)
        self.dataset = types.SimpleNamespace(augment=augment)


class TestTrainer:
    def _trainer(self, tmp_path, **train):
        cfg = _small_cfg(**train)
        return Trainer(cfg, _text_encoder(cfg), str(tmp_path / "w"),
                       str(tmp_path / "i"), device="cpu")

    @staticmethod
    def _stub_steps(trainer, rows):
        """Replace the step with one returning the given metric rows."""
        it = iter(rows)

        def step(state, te, images, captions, cap_lens):
            state.step += 1
            return {k: torch.tensor(v) for k, v in next(it).items()}

        trainer._step_fn = step

    @staticmethod
    def _batches(n):
        return [{"images": np.zeros((2, 16, 16, 3), np.uint8),
                 "captions": np.ones((2, 6), np.int32),
                 "cap_lens": np.full((2,), 6, np.int32)}] * n

    def test_masked_gp_mean_under_gp_interval(self, tmp_path):
        trainer = self._trainer(tmp_path, log_every_steps=2)
        self._stub_steps(trainer, [
            {"d_loss": 1.0, "d_gp_loss": 4.0, "d_gp_active": 1.0},
            {"d_loss": 2.0, "d_gp_loss": 0.0, "d_gp_active": 0.0},
            {"d_loss": 3.0, "d_gp_loss": 2.0, "d_gp_active": 1.0},
            {"d_loss": 6.0, "d_gp_loss": 0.0, "d_gp_active": 0.0}])
        means = trainer.train_epoch(self._batches(4))
        assert means == {"d_loss": 3.0, "d_gp_loss": 3.0}
        trainer._flush_step_rows(0)
        trainer.close()
        with open(tmp_path / "w" / "metrics_log.jsonl") as f:
            rows = [json.loads(line) for line in f]
        assert [(r["step"], r["kind"], r["d_loss"]) for r in rows] == [
            (2, "step", 2.0), (4, "step", 6.0)]

    def test_device_batch_normalizes(self, tmp_path):
        trainer = self._trainer(tmp_path)
        batch = self._batches(1)[0]
        batch = dict(batch, images=np.full((2, 16, 16, 3), 255, np.uint8))
        images, captions, cap_lens = trainer._device_batch(batch)
        assert images.dtype == torch.float32
        assert torch.equal(images, torch.ones_like(images))
        assert captions.shape == (2, 6) and cap_lens.device.type == "cpu"
        trainer.close()

    def test_grid_survives_a_failing_figure(self, tmp_path, monkeypatch,
                                            capsys):
        """The PNG grid is written first; a figure that fails (matplotlib
        missing) leaves it in place and does not stop training."""
        trainer = self._trainer(tmp_path)

        def no_matplotlib(*a, **k):
            raise ImportError("No module named 'matplotlib'")

        monkeypatch.setattr(image_io, "save_images_with_prompts",
                            no_matplotlib)
        fake = np.zeros((2, 16, 16, 3), np.float32)
        trainer._save_samples(fake, np.ones((2, 6), np.int32),
                              np.full((2,), 6), 3)
        assert os.path.exists(tmp_path / "i" / "fake_sample_epoch_3.png")
        assert "matplotlib" in capsys.readouterr().out
        trainer.close()

    def test_eval_noise_is_keyed_to_the_epoch(self, tmp_path):
        trainer = self._trainer(tmp_path)
        caps, lens = np.ones((2, 6), np.int32), np.full((2,), 6)
        trainer._eval_rng = trainer._epoch_generator(1)
        a = trainer.generate(caps, lens)
        trainer._eval_rng = trainer._epoch_generator(2)
        b = trainer.generate(caps, lens)
        trainer._eval_rng = trainer._epoch_generator(1)
        assert torch.equal(trainer.generate(caps, lens), a)
        assert not torch.equal(a, b)
        is_score, fid, fake, _, _ = trainer.evaluate(
            [{"captions": caps, "cap_lens": lens}])
        assert (is_score, fid) == (1.0, float("inf"))
        assert fake.shape == (2, 16, 16, 3)
        trainer.close()


    @staticmethod
    def _eval_batches(n):
        rng = np.random.default_rng(6)
        return [{"images": rng.integers(0, 256, (2, 16, 16, 3), np.uint8),
                 "captions": rng.integers(1, 20, (2, 6), np.int32),
                 "cap_lens": np.asarray([6, 3], np.int32)}
                for _ in range(n)]

    def test_evaluate_scores_equal_compute_is_fid(self, tmp_path):
        """With Inception weights, `evaluate` over a loader of 3 batches
        (eval_max_batches 2) gives the scores of `compute_is_fid` on the
        same 4 fakes (the epoch's eval noise) and 4 normalized reals,
        exactly; it returns the last fake batch."""
        cfg = _small_cfg(eval_max_batches=2)
        params = init_inception(torch.Generator().manual_seed(0))
        trainer = Trainer(cfg, _text_encoder(cfg), str(tmp_path / "w"),
                          str(tmp_path / "i"), inception_params=params,
                          device="cpu")
        batches = self._eval_batches(3)
        trainer._eval_rng = trainer._epoch_generator(0)
        is_score, fid, fake, caps, _ = trainer.evaluate(_Loader(batches))
        trainer._eval_rng = trainer._epoch_generator(0)
        fakes = torch.cat([trainer.generate(b["captions"], b["cap_lens"])
                           for b in batches[:2]])
        reals = torch.cat([torch.from_numpy(b["images"]).float() / 127.5
                           - 1.0 for b in batches[:2]])
        want = metrics.compute_is_fid(params, fakes, reals)
        assert np.isfinite(fid) and is_score >= 1.0
        assert (is_score, fid) == want
        np.testing.assert_array_equal(fake, fakes[2:].numpy())
        np.testing.assert_array_equal(caps, batches[1]["captions"])
        trainer.close()

    @pytest.mark.parametrize("augment", [False, True])
    def test_real_side_computed_once_for_a_deterministic_loader(
            self, tmp_path, monkeypatch, augment):
        """Two evaluations on one unshuffled, un-augmented loader compute
        the real side's stats once and give the same scores; an augmented
        loader recomputes it each time; another loader object does not
        reuse the cache. The network is replaced by cheap functions of
        the pixels."""
        calls = []
        stats = metrics.activation_stats

        def spy(params, images, *a, **k):
            calls.append(images.shape[0])
            return stats(params, images, *a, **k)

        monkeypatch.setattr(metrics, "activation_stats", spy)
        monkeypatch.setattr(metrics, "_features_batch",
                            lambda p, im: im.reshape(im.shape[0], -1)[:, :64])
        monkeypatch.setattr(metrics, "_logits_batch", lambda p, im: (
            torch.softmax(im.reshape(im.shape[0], -1)[:, :10], dim=1)))
        cfg = _small_cfg()
        trainer = Trainer(cfg, _text_encoder(cfg), str(tmp_path / "w"),
                          str(tmp_path / "i"),
                          inception_params={"fc": {"w": torch.zeros(1)}},
                          device="cpu")
        loader = _Loader(self._eval_batches(2), augment=augment)
        scores = []
        for _ in range(2):
            trainer._eval_rng = trainer._epoch_generator(0)
            scores.append(trainer.evaluate(loader)[:2])
        assert scores[0] == scores[1] and np.isfinite(scores[0][1])
        # per evaluation one call for the fakes, plus the reals' when
        # they are not cached
        assert len(calls) == (4 if augment else 3)
        trainer.evaluate(_Loader(self._eval_batches(2), augment=augment))
        assert len(calls) == (6 if augment else 5)
        trainer.close()

class TestUtils:
    def test_jsonio_matches_jax(self):
        obj = {"a": [1.0, float("inf"), float("-inf")], "b": float("nan"),
               "c": {"d": (2, "x")}}
        got = jsonio.sanitize_nonfinite(obj)
        assert got == jjsonio.sanitize_nonfinite(obj)
        back = jsonio.restore_nonfinite(json.loads(json.dumps(got)))
        assert back["a"] == [1.0, float("inf"), float("-inf")]
        assert np.isnan(back["b"])

    def test_metrics_logger_truncates_replayed_epochs(self, tmp_path):
        log = profiling.MetricsLogger(str(tmp_path / "m.jsonl"))
        for epoch in range(3):
            log.log(epoch, epoch=epoch, fid=float("inf"), kind="epoch")
        log.truncate_from(1)
        log.log(9, epoch=1)
        log.close()
        with open(tmp_path / "m.jsonl") as f:
            rows = [json.loads(line) for line in f]
        assert [(r["step"], r["epoch"]) for r in rows] == [(0, 0), (9, 1)]
        assert rows[0]["fid"] == "Infinity" and rows[0]["kind"] == "epoch"

    def test_step_timer_on_the_host(self):
        timer = profiling.StepTimer(skip_first=1)
        for _ in range(3):
            with timer:
                pass
        s = timer.summary()
        assert s["steps"] == 2 and s["max_s"] >= s["p50_s"] >= 0
        assert profiling.StepTimer().summary() == {"steps": 0}

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with profiling.trace(str(tmp_path / "t")):
            torch.ones(8).sum()
        assert os.path.getsize(tmp_path / "t" / "trace.json") > 0

    def test_image_helpers_match_jax(self, tmp_path):
        code2word = {0: "<end>", 2: "red", 3: "bird"}
        caption = np.asarray([2, 3, 7, 0])
        assert image_io.decode_caption(caption, 3, code2word) == \
            jimage_io.decode_caption(caption, 3, code2word) == "red bird [7]"
        images = np.random.default_rng(0).uniform(
            -1, 1, (2, 8, 8, 3)).astype(np.float32)
        path = image_io.save_images_with_prompts(
            images, ["a", "b"], str(tmp_path / "p.jpg"))
        assert os.path.getsize(path) > 0

    def test_plots_equal_jax_bytes(self, tmp_path):
        """plot_losses and plot_metrics write the JAX package's PNGs, byte
        for byte."""
        losses = ([1.0, 0.8, 0.7], [2.0, 1.5, 1.2], [0.1, 0.05, 0.02])
        metric = ([300.0, 250.0, 240.0], [1.5, 2.0, 2.4])
        for mod, name in ((plotting, "port"), (jplotting, "jax")):
            assert mod.plot_losses(*losses, path_save=str(
                tmp_path / f"{name}_l.png")).endswith("_l.png")
            mod.plot_metrics(*metric, epochs=[1, 2, 3],
                             path_save=str(tmp_path / f"{name}_m.png"))
        for kind in ("l", "m"):
            port = (tmp_path / f"port_{kind}.png").read_bytes()
            assert port[:8] == b"\x89PNG\r\n\x1a\n"
            assert port == (tmp_path / f"jax_{kind}.png").read_bytes()
