"""The port's FID-parity harness
(`gan_codes_tpu_torch/tools/validate_pretrained.py`) on the CPU: the
self-test on seeded random assets passes every check, `--check-weights`
holds a 32px port weights dir against the reference forward, a check made
to fail exits 1, and the tool's reference leg equals the test oracle
(tests/torch_ref.py) bit for bit. Its subprocess has a limit of 120 s. The
two full runs take one thread each (the reference leg's scipy `sqrtm` of a
2048x2048 matrix barely gains from more, and several workers of a
parallel suite oversubscribe the cores). The kill-and-resume tool's tests
are in tests/test_torch_port_longrun.py."""
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
from threadpoolctl import threadpool_limits

import torch_ref
from gan_codes_tpu_torch.config import GANConfig
from gan_codes_tpu_torch.models.generator import Generator
from gan_codes_tpu_torch.tools import validate_pretrained as vp
from gan_codes_tpu_torch.train.checkpoint import CheckpointManager
from torch_port_env import one_thread_children  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_weights_dir(path: str) -> GANConfig:
    """A 32px, n_channels 8 port weights dir (config.json, gen_0.pth,
    gen_ema_0.pth) with every block gamma away from 0."""
    cfg = GANConfig.for_image_size(32, n_channels=8, vocab_size=20)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        g = Generator(cfg.generator)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(torch.rand(1, generator=gen) * 0.5 + 0.25)
    mgr = CheckpointManager(path)
    mgr.save_config(cfg)
    mgr.save_generator(0, g.state_dict(), g.state_dict())
    return cfg


class TestValidatePretrained:
    def test_self_test_passes_every_check(self, tmp_path):
        env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1",
                   OPENBLAS_NUM_THREADS="1")
        r = subprocess.run(
            [sys.executable, "-m",
             "gan_codes_tpu_torch.tools.validate_pretrained", "--self-test",
             "--device", "cpu", "--n-images", "8"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
        checks = [line for line in r.stdout.splitlines()
                  if line.startswith("[")]
        assert len(checks) == 3, r.stdout
        assert all(line.startswith("[PASS]") for line in checks), r.stdout
        assert "gan_codes_tpu_torch.train_entry" in r.stdout

    def test_check_weights_on_a_port_weights_dir(self, tmp_path, capsys):
        weights = str(tmp_path / "w")
        _port_weights_dir(weights)
        assert vp.main(["--check-weights", weights, "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "[PASS] weights-dir generator" in out and "[FAIL]" not in out
        os.remove(os.path.join(weights, "config.json"))
        assert vp.main(["--check-weights", weights, "--device", "cpu"]) == 1
        assert "[FAIL] weights-dir generator" in capsys.readouterr().out

    def test_a_failing_check_exits_1(self, tmp_path, capsys, monkeypatch):
        """The port's IS made to be off by 1.0: the IS check fails, the
        run exits 1 and prints no procedure."""
        real = vp.metrics.compute_inception_score
        monkeypatch.setattr(vp.metrics, "compute_inception_score",
                            lambda *a, **k: real(*a, **k) + 1.0)
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with threadpool_limits(1):
                rc = vp.main(["--self-test", "--device", "cpu",
                              "--n-images", "8"])
        finally:
            torch.set_num_threads(threads)
        assert rc == 1
        out = capsys.readouterr().out
        assert "[FAIL] Inception Score" in out
        assert "[PASS] FID" in out and "matched-steps" not in out

    def test_reference_leg_equals_the_test_oracle(self):
        """The tool's own copy of the reference (Inception3 with unfolded
        batch norm, the raw-state_dict generator forward) equals
        tests/torch_ref.py's functions bit for bit on one state_dict."""
        sd = torch_ref.random_inception_state_dict(seed=2)
        x = torch.rand((2, 3, 80, 80), generator=torch.Generator()
                       .manual_seed(5))
        assert torch.equal(vp.inception_v3_pool_features(sd, x),
                           torch_ref.inception_v3_pool_features(sd, x))
        assert torch.equal(vp.inception_v3_logits(sd, x),
                           torch_ref.inception_v3_logits(sd, x))

        cfg = GANConfig.for_image_size(32, n_channels=8).generator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(6)
            gsd = Generator(cfg).state_dict()
        for k in gsd:
            if k.endswith(".gamma"):
                gsd[k] = torch.full((1,), 0.5)
        rng = np.random.default_rng(7)
        noise = torch.from_numpy(rng.standard_normal(
            (2, cfg.latent_dim), dtype=np.float32))
        sent = torch.from_numpy(rng.standard_normal(
            (2, cfg.sentence_dim), dtype=np.float32))
        with torch.no_grad():
            got = vp.sd_generator_forward(gsd, cfg, noise, sent)
            want = torch_ref.sd_generator_forward(gsd, cfg, noise, sent)
        assert got.shape == (2, 3, 32, 32)
        assert torch.equal(got, want)
