"""The port's evaluation (gan_codes_tpu_torch/models/inception.py and
eval/metrics.py) held against the JAX package on the CPU: the resize,
InceptionV3's pool features and softmax on the same weights, the weights
carried across from JAX and read from a torchvision state_dict, and the
IS/FID math and its failure sentinels on the same seeded features.

JAX's InceptionV3 is compiled once for the whole file (batch 2, 64px);
its logits come from its features with numpy. The metric math is fed
seeded features through each package's `_batched`, so it runs without the
network.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ref as tr
from scipy import linalg

from gan_codes_tpu.eval import metrics as jm
from gan_codes_tpu.models import inception as jinc
from gan_codes_tpu_torch.eval import metrics as pm
from gan_codes_tpu_torch.models import inception as pinc
from gan_codes_tpu_torch.models.torch_import import inception_params_from_jax
from torch_port_env import one_thread_children  # noqa: E402,F401

T = torch.from_numpy


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _softmax_np(logits):
    z = np.clip(logits, -50.0, 50.0)
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


@pytest.fixture(scope="module")
def net():
    """One seeded torchvision-layout state_dict folded by both packages,
    [-1, 1] NHWC 64px inputs, and JAX's features compiled once."""
    sd = pinc.random_torchvision_state_dict(torch.Generator().manual_seed(3))
    x = np.random.RandomState(7).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jax_features = jax.jit(
        lambda p, im: jinc.inception_features(p, jm._preprocess(im)))
    jparams = jinc.convert_torch_inception_state_dict(sd)
    return {"sd": sd, "x": x, "jax_features": jax_features,
            "jparams": jparams,
            "pparams": pinc.convert_torch_inception_state_dict(sd),
            "want": np.asarray(jax_features(jparams, jnp.asarray(x)))}


class TestInception:
    @pytest.mark.parametrize("case", ["up64", "down320", "nonfinite"])
    def test_preprocess_matches_jax(self, case):
        """[-1, 1] -> [0, 1] 299x299: upsampling from 64px, downsampling
        from 320px (antialiased, as jax.image.resize), and NaN / +-inf
        inputs scrubbed to 0 / +-1; atol 3e-5 (the filters' weights are
        computed in other orders)."""
        size = 320 if case == "down320" else 64
        x = np.random.default_rng(size).uniform(
            -1.2, 1.2, (2, size, size, 3)).astype(np.float32)
        if case == "nonfinite":
            x[0, :5, :5] = np.nan
            x[1, 10:20, :, 0] = np.inf
            x[1, 30:40, :, 1] = -np.inf
        want = np.asarray(jm._preprocess(jnp.asarray(x)))
        got = pm._preprocess(T(x)).numpy()
        assert got.shape == want.shape == (2, 299, 299, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)

    def test_features_match_jax(self, net):
        """Pool features through `_preprocess`, same folded weights: atol
        2e-4 / rtol 1e-3 (tests/test_metrics.py's oracle tolerance)."""
        got = pm._features_batch(net["pparams"], T(net["x"])).numpy()
        assert got.shape == (2, pinc.POOL_DIM)
        np.testing.assert_allclose(got, net["want"], atol=2e-4, rtol=1e-3)

    def test_softmax_logits_match_jax(self, net):
        """The logits path (fc, clip +-50, softmax) against JAX's features
        through JAX's fc in numpy: atol 1e-4."""
        fc = net["jparams"]["fc"]
        want = _softmax_np(net["want"] @ np.asarray(fc["w"])
                           + np.asarray(fc["b"]))
        got = pm._logits_batch(net["pparams"], T(net["x"])).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_torchvision_route_equals_jax_carry_over(self, net, tmp_path):
        """A torchvision state_dict read by `load_torch_inception` equals
        the JAX fold carried across by `inception_params_from_jax`, bit
        for bit, and both keep OIHW (one transpose on each route)."""
        path = str(tmp_path / "inception.pth")
        torch.save(net["sd"], path)
        loaded = pinc.load_torch_inception(path)
        carried = inception_params_from_jax(_np_tree(net["jparams"]))
        assert set(loaded) == set(carried) == set(net["pparams"])
        for name, p in loaded.items():
            for k, v in p.items():
                assert v.dtype == torch.float32
                assert torch.equal(v, carried[name][k]), (name, k)
                assert torch.equal(v, net["pparams"][name][k]), (name, k)
        assert loaded["Mixed_6b.branch7x7_2"]["w"].shape == (128, 128, 1, 7)
        assert loaded["fc"]["w"].shape == (1000, 2048)

    def test_carried_jax_init_matches_jax(self, net):
        """JAX's `init_inception` weights carried across: the same
        features (atol 2e-4 / rtol 1e-3)."""
        jparams = jinc.init_inception(jax.random.PRNGKey(0))
        want = np.asarray(net["jax_features"](jparams, jnp.asarray(net["x"])))
        pparams = inception_params_from_jax(_np_tree(jparams))
        got = pm._features_batch(pparams, T(net["x"])).numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)

    def test_torch_oracle_and_init(self, net):
        """The functional torch Inception3 of tests/torch_ref.py on the raw
        state_dict (its own BN, no fold) gives the port's features (atol
        1e-4 / rtol 1e-4); `init_inception` has the JAX package's conv
        table and is seeded."""
        t = torch.clamp((T(net["x"]).permute(0, 3, 1, 2) + 1) / 2, 0, 1)
        t = torch.nn.functional.interpolate(t, size=(299, 299),
                                            mode="bilinear",
                                            align_corners=False)
        want = tr.inception_v3_pool_features(net["sd"], t).numpy()
        got = pm._features_batch(net["pparams"], T(net["x"])).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        assert pinc._conv_specs() == jinc._conv_specs()
        a = pinc.init_inception(torch.Generator().manual_seed(1))
        b = pinc.init_inception(torch.Generator().manual_seed(1))
        for name, kh, kw, cin, cout in pinc._conv_specs():
            assert a[name]["w"].shape == (cout, cin, kh, kw)
            assert torch.equal(a[name]["w"], b[name]["w"])
        assert a["fc"]["w"].abs().max() <= (1 / 2048) ** 0.5

    def test_random_torchvision_state_dict_equals_the_suites(self):
        """The port's seeded torchvision-layout builder draws what
        tests/torch_ref.py's `random_inception_state_dict` draws from the
        same seed: the same keys, shapes and values, bit for bit."""
        want = tr.random_inception_state_dict(seed=4)
        got = pinc.random_torchvision_state_dict(
            torch.Generator().manual_seed(4))
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                                 want[k]), k


# -- the metric math on seeded features ------------------------------------

def _feed(monkeypatch, feats, preds=None):
    """Both packages' `_batched` return feats[k] (the features path) or
    preds[k] (the softmax path) for images whose first value is k; the
    network is not run."""
    def fake(fn, params, images, batch_size):
        k = int(np.asarray(images).reshape(-1)[0])
        return (preds if fn.__name__ == "_logits_batch" else feats)[k]
    monkeypatch.setattr(jm, "_batched", fake)
    monkeypatch.setattr(pm, "_batched", fake)


# stands in for the network's params: the metric functions read only the
# device the network lives on (the CPU)
P = {"fc": {"w": torch.zeros(1)}}


def _images(k, n):
    return np.full((n, 1, 1, 3), k, np.float32)


def _preds(rng, n):
    return _softmax_np(rng.standard_normal((n, 1000)) * 3).astype(np.float32)


class TestMetricMath:
    @pytest.mark.parametrize("splits", [1, 3])
    def test_inception_score_matches_jax(self, monkeypatch, splits):
        preds = _preds(np.random.default_rng(0), 12)
        preds[3, 7] = np.nan  # scrubbed to 1/1000 on both sides
        _feed(monkeypatch, {}, {0: preds})
        want = jm.compute_inception_score(P, _images(0, 12), 8, splits)
        got = pm.compute_inception_score(P, _images(0, 12), 8, splits)
        assert want > 1.0
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_sqrtm_trace_lowrank_and_scipy_frechet_match_jax(self):
        """The Gram-trick cross term on 10 x 64 activations, and the
        scipy Fréchet distance on 64-dim stats: rtol 1e-6."""
        rng = np.random.default_rng(1)
        a1, a2 = rng.standard_normal((2, 10, 64)) / 3.0
        np.testing.assert_allclose(pm.sqrtm_trace_lowrank(a1, a2),
                                   jm.sqrtm_trace_lowrank(a1, a2), rtol=1e-6)
        mu1, mu2 = rng.standard_normal((2, 64))
        s1 = a1.T @ a1 + 1e-3 * np.eye(64)
        s2 = a2.T @ a2 + 1e-3 * np.eye(64)
        np.testing.assert_allclose(
            pm._frechet_distance(mu1, s1, mu2, s2, use_scipy=True),
            jm._frechet_distance(mu1, s1, mu2, s2, use_scipy=True),
            rtol=1e-6)

    @pytest.mark.parametrize("n", [10, 200])
    def test_sqrtm_trace_psd_is_exact_at_any_rank(self, n):
        """The cross term of the moment-reduced FID from two 64-dim
        covariances of n samples each, below the dimension (rank n - 1)
        and above it (full rank), against the JAX package's Gram-trick
        trace of the same activations (exact at any n) and, at full rank,
        scipy's sqrtm: rtol 1e-6."""
        rng = np.random.default_rng(n)
        acts = rng.standard_normal((2, n, 64)) / 3.0
        acts -= acts.mean(axis=1, keepdims=True)
        acts /= np.sqrt(n - 1)
        s1, s2 = acts[0].T @ acts[0], acts[1].T @ acts[1]
        got = pm.sqrtm_trace_psd(s1, s2)
        np.testing.assert_allclose(
            got, jm.sqrtm_trace_lowrank(acts[0], acts[1]), rtol=1e-6)
        if n > 64:
            np.testing.assert_allclose(
                got, np.trace(linalg.sqrtm(s1 @ s2)).real, rtol=1e-6)

    def test_newton_schulz_matches_jax_x64(self):
        """float64 Newton-Schulz (50 iterations) against JAX's under
        enable_x64, and against scipy: rtol 1e-6; the Fréchet distance on
        that path too."""
        rng = np.random.default_rng(2)
        a, b = rng.standard_normal((2, 16, 24))
        s1 = a @ a.T + 1e-3 * np.eye(16)
        s2 = b @ b.T + 1e-3 * np.eye(16)
        with jax.enable_x64():
            want = float(jm.sqrtm_trace_newton_schulz(
                jnp.asarray(s1 @ s2, jnp.float64)))
            mu1, mu2 = rng.standard_normal((2, 16))
            want_fid = jm._frechet_distance(mu1, s1, mu2, s2,
                                            use_scipy=False)
        got = float(pm.sqrtm_trace_newton_schulz(
            torch.as_tensor(s1 @ s2, dtype=torch.float64)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(
            got, np.trace(linalg.sqrtm(s1 @ s2).real), rtol=1e-6)
        np.testing.assert_allclose(
            pm._frechet_distance(mu1, s1, mu2, s2, use_scipy=False),
            want_fid, rtol=1e-6)

    def test_stats_and_moments_match_jax(self, monkeypatch):
        """activation_stats (with acts), the moment helpers and the
        statistics they give back: rtol 1e-6."""
        rng = np.random.default_rng(3)
        feats = rng.standard_normal((10, 64)).astype(np.float32)
        preds = _preds(rng, 10)
        _feed(monkeypatch, {0: feats}, {0: preds})
        for got, want in zip(pm.activation_stats(P, _images(0, 10),
                                                 return_acts=True),
                             jm.activation_stats(P, _images(0, 10),
                                                 return_acts=True)):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
        pmom = pm.activation_moments(P, _images(0, 10))
        jmom = jm.activation_moments(P, _images(0, 10))
        for k in jmom:
            np.testing.assert_allclose(pmom[k], jmom[k], rtol=1e-6)
        for got, want in zip(pm.stats_from_moments(pmom),
                             jm.stats_from_moments(jmom)):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
        pis = pm.is_moments(P, _images(0, 10))
        jis = jm.is_moments(P, _images(0, 10))
        for k in jis:
            np.testing.assert_allclose(pis[k], jis[k], rtol=1e-6)
        np.testing.assert_allclose(pm.is_from_moments(pis),
                                   jm.is_from_moments(jis), rtol=1e-6)
        np.testing.assert_allclose(
            pm.is_from_moments(pis),
            pm.compute_inception_score(P, _images(0, 10)), rtol=1e-6)

    @pytest.mark.parametrize("real_side", ["images", "stats_with_acts",
                                           "stats_without_acts"])
    def test_fid_and_is_fid_match_jax(self, monkeypatch, real_side):
        """compute_is_fid with the real side as images or cached stats:
        the low-rank cross term where both sides carry activations, scipy
        where the cached stats have none; rtol 1e-6."""
        rng = np.random.default_rng(4)
        feats_real = rng.standard_normal((12, 64)).astype(np.float32)
        feats_fake = (rng.standard_normal((9, 64)) * 1.3 + 0.2).astype(
            np.float32)
        _feed(monkeypatch, {0: feats_real, 1: feats_fake},
              {1: _preds(rng, 9)})
        scores = []
        for m in (jm, pm):
            stats = None
            if real_side != "images":
                stats = m.activation_stats(P, _images(0, 12),
                                           return_acts=True)
                if real_side == "stats_without_acts":
                    stats = stats[:2]
            scores.append(m.compute_is_fid(P, _images(1, 9),
                                           _images(0, 12), real_stats=stats))
        (jis, jfid), (pis, pfid) = scores
        assert pis > 1.0 and np.isfinite(pfid) and pfid > 0
        np.testing.assert_allclose([pis, pfid], [jis, jfid], rtol=1e-6)

    @pytest.mark.parametrize("case", ["is_raises", "fid_nan", "fid_one",
                                      "fid_raises", "is_moments_empty"])
    def test_sentinels_match_jax(self, monkeypatch, case):
        """IS 1.0 on any failure, FID inf on NaN activations, on a side of
        fewer than 2 samples and on any other failure, on both sides."""
        rng = np.random.default_rng(5)
        nan_feats = rng.standard_normal((4, 64)).astype(np.float32)
        nan_feats[2, 5] = np.nan

        def boom(*_):
            raise RuntimeError("boom")

        _feed(monkeypatch, {0: rng.standard_normal((4, 64)), 1: nan_feats,
                            2: rng.standard_normal((1, 64))})
        for m in (jm, pm):
            if case == "is_raises":
                monkeypatch.setattr(m, "_batched", boom)
                assert m.compute_inception_score(P, _images(0, 4)) == 1.0
            elif case == "is_moments_empty":
                assert m.is_from_moments({"sum_p": np.zeros(1000),
                                          "sum_plogp": 0.0, "n": 0.0}) == 1.0
            elif case == "fid_raises":
                monkeypatch.setattr(m, "_batched", boom)
                assert m.compute_fid(P, _images(0, 4),
                                     _images(0, 4)) == float("inf")
            else:
                fake = _images(1 if case == "fid_nan" else 2, 4)
                assert m.compute_fid(P, _images(0, 4),
                                     fake) == float("inf")
