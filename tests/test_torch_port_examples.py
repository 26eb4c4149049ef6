"""The port's example walkthroughs (`gan_codes_tpu_torch/examples/`), run
as tests/test_examples.py runs the JAX package's: the train example at its
defaults on the CPU (a synthetic fixture, 2 epochs at 32px), then the eval
example on its artifacts (restore, test-split sampling, free-text
generation). Also: each entry point this slice adds (the two examples and
the two tools) raises without a card unless it is given the CPU."""
import importlib.util
import os

import pytest
import torch

from gan_codes_tpu_torch.examples import eval_example, train_example
from gan_codes_tpu_torch.tools import longrun, validate_pretrained


@pytest.fixture(scope="module")
def example_workdir(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("examples"))
    assert train_example.main(work=work, device="cpu") == work
    return work


class TestExamples:
    def test_train_example_produces_artifacts(self, example_workdir):
        work = example_workdir
        weights = os.path.join(work, "gen_weights")
        for name in ("checkpoint", "config.json", "gen_0.pth", "gen_1.pth",
                     "gen_ema_1.pth", "histories.json"):
            assert os.path.exists(os.path.join(weights, name)), name
        assert os.path.exists(os.path.join(work, "gen_images",
                                           "fake_sample_epoch_1.png"))
        if importlib.util.find_spec("matplotlib") is not None:
            assert os.path.exists(os.path.join(work, "losses.png"))
            assert os.path.exists(os.path.join(work, "metrics.png"))

    def test_eval_example_consumes_them(self, example_workdir, tmp_path):
        work = example_workdir
        out = str(tmp_path / "eval_out")
        eval_example.main([
            "--data", os.path.join(work, "data"),
            "--weights", os.path.join(work, "gen_weights"),
            "--image-size", "32",
            "--out", out,
            "--caption", "this bird has a red beak",
            "--device", "cpu",
        ])
        batch_pngs = os.listdir(os.path.join(out, "batch"))
        assert len(batch_pngs) == 4, "sample() wrote one PNG per test image"
        own = [f for f in os.listdir(out) if f.startswith("own_bird")]
        assert own, "generate_from_prompt wrote no image"


class TestEntryPointsRefuseASilentCpu:
    def test_each_new_entry_point_raises_without_a_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        out = tmp_path / "o"
        calls = [
            lambda: train_example.main(work=str(out)),
            lambda: eval_example.main(["--data", str(out), "--weights",
                                       str(out), "--out", str(out)]),
            lambda: validate_pretrained.main(["--self-test"]),
            lambda: validate_pretrained.main(["--check-weights", str(out)]),
            lambda: longrun.main(["--out", str(out)]),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert not os.path.exists(out)
