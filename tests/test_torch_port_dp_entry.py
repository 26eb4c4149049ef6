"""The port's data-parallel entry point and eval on the CPU: pairs of real
processes of `gan_codes_tpu_torch.train_entry --dp --device cpu` with a
torchrun environment (gloo; a free port and a time limit each, as
tests/test_multiprocess.py::_run_pair starts its workers) train in
lockstep, resume bit for bit, write files from rank 0 only and raise
together on a config mismatch; the moment-reduced IS/FID of two ranks'
shards equals `compute_is_fid` on their union.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch import data as pdata
from gan_codes_tpu_torch import train_entry
from gan_codes_tpu_torch.models.inception import (
    random_torchvision_state_dict)
from gan_codes_tpu_torch.parallel import mesh as pmesh
from gan_codes_tpu_torch.tools import dp_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds, every pair of rank processes

# One rank of `train_entry --dp`: records the files it opens for writing
# or renames into place under DP_TEST_ROOT (an audit hook), then prints its
# final state's digest.
_LAUNCH = r'''
import json, os, sys
root = os.environ["DP_TEST_ROOT"]
writes = []

def hook(event, args):
    if event == "open" and isinstance(args[0], str) \
            and isinstance(args[1], str) and set(args[1]) & set("wax+"):
        path = args[0]
    elif event == "os.rename" and isinstance(args[1], str):
        path = args[1]
    else:
        return
    if os.path.abspath(path).startswith(root):
        writes.append(path)

sys.addaudithook(hook)
from unittest import mock
from gan_codes_tpu_torch import train_entry
from gan_codes_tpu_torch.tools.dp_check import digest
made = []

class Recorded(train_entry.Trainer):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        made.append(self)

with mock.patch.object(train_entry, "Trainer", Recorded):
    train_entry.main(sys.argv[1:])
t = made[-1]
print("RESULT " + json.dumps({"digest": digest(t.state, t.text_encoder),
                              "step": t.state.step, "writes": writes}))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair(root, args_by_rank):
    """Run one `train_entry` process per rank (2 ranks, one node); returns
    [(returncode, output, result or None)]."""
    port = str(_free_port())
    procs = []
    for rank, args in enumerate(args_by_rank):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   GROUP_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="2", PYTHONPATH=REPO,
                   DP_TEST_ROOT=str(root))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _LAUNCH] + args, cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, out in zip(procs, outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        results.append((p.returncode, out,
                        json.loads(lines[-1][7:]) if lines else None))
    return results


def _args(cub, weights, images, epochs, dp=True):
    return ["--data", cub, "--image-size", "32", "--batch-size", "4",
            "--n-channels", "8", "--epochs", str(epochs), "--seed", "5",
            "--device", "cpu", "--weights", str(weights),
            "--images", str(images)] + (["--dp"] if dp else [])


@pytest.fixture(scope="module")
def cub(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cub"))
    info = pdata.make_synthetic_cub(root, n_train=8, n_test=4,
                                    image_size=48)
    return root, info["n_words"]


@pytest.fixture(scope="module")
def runs(cub, tmp_path_factory):
    """Pairs of ranks: A, 2 epochs; B, 1 epoch, then resumed to 2."""
    root = tmp_path_factory.mktemp("dp_entry")
    out = {"root": root}
    for name, run, epochs in (("straight", "a", 2), ("first", "b", 1),
                              ("resumed", "b", 2)):
        args = _args(cub[0], root / f"{run}_w", root / f"{run}_i", epochs)
        out[name] = _pair(root, [args, args])
    return out


class TestTrainEntryDP:
    def test_pairs_run_in_lockstep(self, runs):
        for name in ("straight", "first", "resumed"):
            (rc0, out0, r0), (rc1, out1, r1) = runs[name]
            assert rc0 == 0 and rc1 == 0, (name, out0[-4000:],
                                           out1[-4000:])
            assert r0["digest"] == r1["digest"], name
            assert r0["step"] == r1["step"] == (2 if name == "first" else 4)

    def test_resumed_pair_equals_uninterrupted_pair(self, runs):
        """The final checkpoint of the pair killed after epoch 1 and
        resumed to 2 equals the uninterrupted pair's bit for bit, as do
        the ranks' whole states (digests)."""
        assert runs["resumed"][0][2]["digest"] == \
            runs["straight"][0][2]["digest"]
        blobs = [torch.load(runs["root"] / w / "checkpoint",
                            weights_only=True) for w in ("a_w", "b_w")]
        assert blobs[0]["step"] == blobs[1]["step"] == 4
        for key in ("generator", "discriminator", "g_ema"):
            for k, v in blobs[0][key].items():
                assert torch.equal(v, blobs[1][key][k]), (key, k)
        assert torch.equal(blobs[0]["rng"], blobs[1]["rng"])
        for opt in ("g_opt", "d_opt"):
            for i, st in blobs[0][opt]["state"].items():
                for k, v in st.items():
                    assert torch.equal(v, blobs[1][opt]["state"][i][k])

    def test_only_rank_0_writes_and_prints(self, runs):
        root = runs["root"]
        for name in ("straight", "first", "resumed"):
            assert runs[name][1][2]["writes"] == [], name
            assert any(w.endswith("checkpoint")
                       for w in runs[name][0][2]["writes"]), name
        for d in ("a_w", "a_i", "b_w", "b_i"):
            names = os.listdir(root / d)
            assert names and not [n for n in names if n.endswith(".tmp")]
        with open(root / "b_w" / "metrics_log.jsonl") as f:
            assert [json.loads(line)["epoch"] for line in f] == [0, 1]
        outs = "".join(out for _, out, _ in runs["resumed"])
        assert outs.count("Resuming from epoch 1") == 1
        assert "Resuming" not in "".join(out for _, out, _ in
                                         runs["straight"])

    def test_config_mismatch_raises_on_every_rank(self, cub, tmp_path):
        """Rank 0's directory holds a checkpoint trained at another width,
        rank 1's holds nothing: rank 0's view decides for both (broadcast),
        so both raise instead of rank 1 training on alone and hanging."""
        data, n_words = cub
        w0 = tmp_path / "w0"
        w0.mkdir()
        (w0 / "checkpoint").write_bytes(b"")
        (w0 / "histories.json").write_text('{"epoch": 0}')
        (w0 / "config.json").write_text(json.dumps(dataclasses.asdict(
            pcfg.GANConfig.for_image_size(32, n_channels=16,
                                          vocab_size=n_words))))
        results = _pair(tmp_path, [
            _args(data, w0, tmp_path / "i0", 1),
            _args(data, tmp_path / "w1", tmp_path / "i1", 1)])
        for rc, out, _ in results:
            assert rc != 0 and "Config mismatch" in out, out[-4000:]

    def test_dp_outside_torchrun_is_a_world_of_one(self, cub, tmp_path,
                                                   monkeypatch):
        """`--dp` with no torchrun environment trains as one process (no
        group, no collective), within the sharded-step tolerances of the
        plain run."""
        for key in ("RANK", "WORLD_SIZE"):
            monkeypatch.delenv(key, raising=False)
        calls = pmesh.all_reduce.calls
        hist = [train_entry.main(_args(cub[0], tmp_path / f"w{dp}",
                                       tmp_path / f"i{dp}", 1, dp))
                for dp in (False, True)]
        assert pmesh.all_reduce.calls == calls
        for key in ("g_losses", "d_losses", "d_gp_losses", "txtimg_losses"):
            np.testing.assert_allclose(hist[1][key], hist[0][key],
                                       atol=1e-5, rtol=2e-4, err_msg=key)

    def test_mesh_flags_take_only_their_defaults(self, cub, tmp_path,
                                                 capsys):
        """`--mesh-layout` / `--mesh-slices` shape the JAX package's TPU
        mesh: any value but the default is an argparse error naming NCCL,
        and the defaults still reach `train`."""
        args = _args(cub[0], tmp_path / "w", tmp_path / "i", 1)
        for extra in (["--mesh-layout", "hybrid"], ["--mesh-slices", "2"]):
            with mock.patch.object(train_entry, "train") as train:
                with pytest.raises(SystemExit) as e:
                    train_entry.main(args + extra)
            assert e.value.code == 2 and not train.called, extra
            err = capsys.readouterr().err
            assert extra[0] in err and "NCCL picks its own rings" in err
        with mock.patch.object(train_entry, "train") as train:
            train_entry.main(args + ["--mesh-layout", "flat",
                                     "--mesh-slices", "0"])
        assert train.call_count == 1
        assert not os.path.exists(tmp_path / "w")


class TestMomentReducedEval:
    @pytest.mark.parametrize("split", [(4, 4), (8, 0)])
    def test_multihost_scores_equal_direct_scores(self, split, tmp_path):
        """`compute_is_fid_multihost` over two ranks' shards (a random
        torchvision-layout InceptionV3) equals `compute_is_fid` on their
        union of 8 (IS - 1 within 1e-2 and FID within 1e-5, relative);
        a rank with an empty shard still enters the reduction."""
        inception = str(tmp_path / "inception.pth")
        torch.save(random_torchvision_state_dict(
            torch.Generator().manual_seed(1)), inception)
        case = dp_check.make_case(32, 8, global_batch=4, steps=0, seed=6)
        gen = torch.Generator().manual_seed(7)
        case["eval"] = {"fakes": torch.rand((8, 32, 32, 3),
                                            generator=gen) * 2 - 1,
                        "reals": torch.rand((8, 32, 32, 3),
                                            generator=gen) * 2 - 1,
                        "split": list(split), "inception": inception}
        path = str(tmp_path / "case.pt")
        torch.save(case, path)
        ranks = dp_check.run_ranks(path, str(tmp_path), world=2,
                                   device="cpu", timeout=TIMEOUT)
        want = dp_check.reference(case)["eval"]
        assert tuple(ranks[0]["eval"]) == tuple(ranks[1]["eval"])
        (is_mh, fid_mh), (is_1, fid_1) = ranks[0]["eval"], want
        assert np.isfinite(fid_1) and is_1 > 1.0
        assert abs(is_mh - is_1) <= dp_check.IS_RTOL * (is_1 - 1.0)
        assert abs(fid_mh - fid_1) <= dp_check.FID_RTOL * fid_1
