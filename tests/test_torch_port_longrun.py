"""The port's kill-and-resume tool (`gan_codes_tpu_torch/tools/
longrun.py`) on the CPU: a 32px run SIGKILLed after epoch 1 and resumed
equals its uninterrupted twin bit for bit, with its loss health in band;
each of its train_entry processes has a limit of 120 s and two threads."""
import json

import torch

from gan_codes_tpu_torch.tools import longrun
from torch_port_env import one_thread_children  # noqa: E402,F401


class TestLongrun:
    def test_differences_finds_one_flipped_bit(self):
        a = {"g": {"w": torch.ones(3)}, "step": 4, "rng": torch.zeros(2)}
        b = {"g": {"w": torch.ones(3)}, "step": 4, "rng": torch.zeros(2)}
        assert longrun._differences(a, b) == []
        b["g"]["w"] = torch.ones(3).view(torch.int32).add(
            torch.tensor([0, 1, 0], dtype=torch.int32)).view(torch.float32)
        b["step"] = 5
        assert longrun._differences(a, b) == ["state.g.w", "state.step"]

    def test_killed_and_resumed_run_equals_its_twin(self, tmp_path,
                                                    monkeypatch):
        """32px, n_channels 8, batch 4, 3 epochs, SIGKILL after epoch 1:
        bit for bit, loss health in band."""
        out = tmp_path / "lr"
        monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the legs inherit it
        rc = longrun.main(["--device", "cpu", "--image-size", "32",
                           "--n-channels", "8", "--batch-size", "4",
                           "--epochs", "3", "--kill-after-epoch", "1",
                           "--n-train", "4", "--n-test", "4",
                           "--leg-timeout", "120", "--out", str(out)])
        assert rc == 0
        report = json.loads((out / "LONGRUN.json").read_text())
        assert report["equivalent"] and report["loss_health"]["ok"]
        assert report["resume_print"] == "Resuming from epoch 1"
        assert not report["param_mismatches"]
        assert report["sample_grids"]
