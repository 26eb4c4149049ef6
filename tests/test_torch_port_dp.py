"""The port's data-parallel train step (gan_codes_tpu_torch/parallel) on
the CPU: two ranks, each a real process on gloo, step from one state on
their rows of each global batch (`gan_codes_tpu_torch/tools/dp_check.py`
starts them, a free port and a time limit each), held against the port's
single-process step on the global batch and against the JAX package's
2-device sharded step; and the loader's rows under `--dp` and
`--multihost` against the JAX loader's global batches.

Tolerances are tests/test_parallel.py's (sharded against single device):
metrics atol 1e-5 / rtol 2e-4, parameters atol 5e-5 / rtol 2e-3; the
ranks' whole states (G, D, EMA, Adam, step, RNG) equal bit for bit.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from gan_codes_tpu import config as jcfg
from gan_codes_tpu import data as jdata
from gan_codes_tpu.models.text_encoder import init_text_encoder
from gan_codes_tpu.parallel.dp import (make_parallel_train_step, replicate,
                                       shard_batch)
from gan_codes_tpu.parallel.mesh import make_mesh
from gan_codes_tpu.train import state as jstate
from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch import data as pdata
from gan_codes_tpu_torch.models import torch_import as pimport
from gan_codes_tpu_torch.parallel.dp import loader_shard
from gan_codes_tpu_torch.parallel.mesh import Mesh, mesh_layout
from gan_codes_tpu_torch.tools import dp_check

TIMEOUT = 120  # seconds, every pair of rank processes


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _run(case, tmp_path):
    path = str(tmp_path / "case.pt")
    torch.save(case, path)
    return dp_check.run_ranks(path, str(tmp_path), world=2, device="cpu",
                              timeout=TIMEOUT)


def _hold(ranks, want, n_steps, want_params=None):
    """Per step: both ranks' states equal bit for bit; rank 0's metrics
    and parameters against `want` (or `want_params`, state dicts)."""
    for i in range(n_steps):
        assert ranks[0]["digests"][i] == ranks[1]["digests"][i], i
        assert ranks[0]["metrics"][i] == ranks[1]["metrics"][i], i
        for k, w in want["metrics"][i].items():
            np.testing.assert_allclose(ranks[0]["metrics"][i][k], w,
                                       atol=1e-5, rtol=2e-4,
                                       err_msg=f"step {i} metric {k}")
        params = want_params[i] if want_params else want["params"][i]
        for part in ("g", "d"):
            for k, w in params[part].items():
                np.testing.assert_allclose(
                    ranks[0]["params"][i][part][k].numpy(),
                    np.asarray(w), atol=5e-5, rtol=2e-3,
                    err_msg=f"step {i} {part} {k}")


class TestDPStep:
    @pytest.mark.parametrize("gp_interval", [1, 2])
    def test_dp_step_equals_single_process_step(self, gp_interval,
                                                tmp_path):
        """2 ranks x local batch 2 against the single-process step on the
        global batch of 4, at each of 4 steps (32px, block gammas in
        [0.25, 0.75]; the noise drawn at the global batch from each
        state's generator). A rank-local mismatch term (b - 1 pairs a
        rank) or a mean of per-rank means moves d_loss by about 0.1."""
        case = dp_check.make_case(32, 8, global_batch=4, steps=4,
                                  gp_interval=gp_interval, seed=3)
        ranks = _run(case, tmp_path)
        _hold(ranks, dp_check.reference(case), 4)
        assert [m["d_gp_active"] for m in ranks[0]["metrics"]] == (
            [1.0] * 4 if gp_interval == 1 else [1.0, 0.0, 1.0, 0.0])

    def test_a_nan_on_one_rank_guards_every_rank(self, tmp_path):
        """A NaN pixel in rank 1's images only: the guard reads the
        all-reduced loss, so both ranks zero phase 1's and phase 2's D
        gradients, draw the same fallback loss, stay bit-equal and equal
        the single-process step on the global batch."""
        case = dp_check.make_case(32, 8, global_batch=4, steps=2, seed=4,
                                  nan_rank=1)
        ranks = _run(case, tmp_path)
        want = dp_check.reference(case)
        _hold(ranks, want, 2)
        for i in range(2):
            for g in want["grads"][i]["d1"]:
                assert not g.any()
            assert abs(ranks[0]["metrics"][i]["d_loss"]) < 0.1  # 0.01 randn
            assert np.isfinite(ranks[0]["metrics"][i]["g_loss"])


class TestAgainstJax:
    N_STEPS = 2

    @staticmethod
    def _cfg():
        return jcfg.GANConfig(
            generator=jcfg.GeneratorConfig(n_channels=8, image_size=32),
            discriminator=jcfg.DiscriminatorConfig(n_channels=4,
                                                   image_size=32),
            text_encoder=jcfg.TextEncoderConfig(vocab_size=30, embed_dim=8,
                                                hidden_dim=256, max_len=6),
            train=jcfg.TrainConfig(batch_size=4))

    def test_dp_step_matches_jax_sharded_step(self, tmp_path):
        """The port's 2-rank step against `make_parallel_train_step` over
        `make_mesh(n_data=2)` (two virtual CPU devices), from the same
        weights (`models/torch_import.py`) and batches, the noise replayed
        from the JAX state's key (tests/test_trajectory.py:76-82)."""
        jc = self._cfg()
        jst = jstate.create_train_state(jax.random.PRNGKey(21), jc)
        for tree, base in ((jst.g_params, 0.30), (jst.d_params, 0.25)):
            for i, bp in enumerate(tree["blocks"]):
                bp["gamma"] = jax.numpy.asarray(base + 0.07 * i,
                                                jax.numpy.float32)
        te = init_text_encoder(jax.random.PRNGKey(3), jc.text_encoder)
        pc = pcfg.GANConfig.from_dict(dataclasses.asdict(jc))
        case = {"cfg": dataclasses.asdict(pc), "seed": 0,
                "g": pimport.generator_state_dict_from_jax(
                    _np_tree(jst.g_params)),
                "d": pimport.discriminator_state_dict_from_jax(
                    _np_tree(jst.d_params)),
                "te": pimport.text_encoder_state_dict_from_jax(
                    _np_tree(te)),
                "batches": [], "noises": [], "eval": None}

        mesh = make_mesh(n_data=2)
        pstep = make_parallel_train_step(jc, mesh, donate_state=False)
        state, te_r = replicate(mesh, jst), replicate(mesh, te)
        want, params = {"metrics": []}, []
        rngs = jax.random.split(jax.random.PRNGKey(9), self.N_STEPS)
        for i in range(self.N_STEPS):
            ki, kc, kl = jax.random.split(rngs[i], 3)
            images = jax.random.normal(ki, (4, 32, 32, 3)) * 0.5
            caps = jax.random.randint(kc, (4, 6), 1, 30)
            lens = jax.random.randint(kl, (4,), 2, 7)
            _, k_noise, _, _, _ = jax.random.split(state.rng, 5)
            case["noises"].append(torch.from_numpy(np.array(
                jax.random.normal(k_noise, (4, 100)))))
            case["batches"].append(tuple(torch.from_numpy(np.array(a))
                                         for a in (images, caps, lens)))
            state, m = pstep(state, te_r,
                             *shard_batch(mesh, jc, images, caps, lens))
            want["metrics"].append({k: float(v) for k, v in m.items()})
            params.append({
                "g": pimport.generator_state_dict_from_jax(
                    _np_tree(state.g_params)),
                "d": pimport.discriminator_state_dict_from_jax(
                    _np_tree(state.d_params))})
        ranks = _run(case, tmp_path)
        _hold(ranks, want, self.N_STEPS, want_params=params)


class TestLoaderRows:
    @pytest.fixture(scope="class")
    def cub(self, tmp_path_factory):
        root = str(tmp_path_factory.mktemp("cub"))
        pdata.make_synthetic_cub(root, n_train=16, n_test=4, image_size=48)
        return root

    @staticmethod
    def _meshes(local_world, nodes):
        """The processes' meshes from their torchrun environments."""
        world = local_world * nodes
        out = []
        for rank in range(world):
            env = {"RANK": str(rank), "WORLD_SIZE": str(world),
                   "LOCAL_RANK": str(rank % local_world),
                   "LOCAL_WORLD_SIZE": str(local_world),
                   "GROUP_RANK": str(rank // local_world)}
            out.append(Mesh(**mesh_layout(env)))
        return out

    @pytest.mark.parametrize("mode", ["dp", "multihost"])
    def test_ranks_rows_are_the_jax_global_batches(self, cub, mode):
        """Over 2 epochs the ranks' rows, concatenated in rank order,
        equal the JAX loader's global batch byte for byte: under `--dp`
        (1 node x 2 ranks, --batch-size 4 the global batch) one unsharded
        JAX loader; under `--multihost` (2 nodes x 1 rank, --batch-size 4
        a node's batch) the JAX per-host shards concatenated."""
        meshes = self._meshes(*((2, 1) if mode == "dp" else (1, 2)))
        assert [m.node for m in meshes] == ([0, 0] if mode == "dp"
                                            else [0, 1])

        def ds(pkg, cfg_mod):
            return pkg.CUBDataset(cfg_mod.DataConfig(data_dir=cub,
                                                     image_size=32), "train")

        ports = [pdata.DataLoader(ds(pdata, pcfg), 4, seed=17,
                                  **loader_shard(m)) for m in meshes]
        shards = [{}] if mode == "dp" else [
            dict(shard_id=h, num_shards=2) for h in range(2)]
        jaxes = [jdata.DataLoader(ds(jdata, jcfg), 4, seed=17, **s)
                 for s in shards]
        for epoch in (0, 1):
            for loader in ports + jaxes:
                loader.set_epoch(epoch)
            got = [list(loader) for loader in ports]
            want = [list(loader) for loader in jaxes]
            n = len(want[0])
            assert n == (4 if mode == "dp" else 2)
            assert all(len(g) == n for g in got)
            for j in range(n):
                for key in ("images", "captions", "cap_lens"):
                    cat = np.concatenate([g[j][key] for g in got])
                    ref = np.concatenate([w[j][key] for w in want])
                    assert cat.shape[0] == 4 * len(shards)
                    np.testing.assert_array_equal(cat, ref)
            assert all(g[0]["images"].shape[0] == 4 // meshes[0].local_world
                       for g in got)

    def test_rows_need_an_even_split(self, cub):
        ds = pdata.CUBDataset(pcfg.DataConfig(data_dir=cub, image_size=32),
                              "train")
        with pytest.raises(ValueError, match="equal full shares"):
            pdata.DataLoader(ds, 5, local_rank=0, local_world=2)
        with pytest.raises(ValueError, match="inconsistent"):
            mesh_layout({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
                         "LOCAL_WORLD_SIZE": "2", "GROUP_RANK": "0"})
        assert mesh_layout({k: v for k, v in os.environ.items()
                            if k not in ("RANK", "WORLD_SIZE")}) is None
