"""The traffic generator repeats for a seed and differs across seeds."""
import hashlib
import os

import numpy as np

from h100_bench import spec as spec_mod, workgen

BIG = 2**31 + 123  # seeds beyond 32 signed bits


def test_streams_repeat_and_differ():
    words = {"mean": 15.0, "sd": 4.0, "min": 5, "max": 30}
    a = workgen.token_batch(workgen.rng(BIG, "x"), 64, 5450, 18, words)
    b = workgen.token_batch(workgen.rng(BIG, "x"), 64, 5450, 18, words)
    c = workgen.token_batch(workgen.rng(BIG + 1, "x"), 64, 5450, 18, words)
    d = workgen.token_batch(workgen.rng(BIG, "y"), 64, 5450, 18, words)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[0], d[0])
    caps, lens = a
    assert lens.min() >= 5 and lens.max() <= 18
    assert ((caps > 0).sum(axis=1) == lens).all()
    assert workgen.torch_seed(BIG, "x") == workgen.torch_seed(BIG, "x")
    assert workgen.torch_seed(BIG, "x") != workgen.torch_seed(BIG + 1, "x")


def test_arrivals():
    t1 = workgen.poisson_arrivals(workgen.rng(BIG, "a"), 200.0, 10.0)
    t2 = workgen.poisson_arrivals(workgen.rng(BIG, "a"), 200.0, 10.0)
    t3 = workgen.poisson_arrivals(workgen.rng(BIG + 1, "a"), 200.0, 10.0)
    assert np.array_equal(t1, t2) and not np.array_equal(t1[:50], t3[:50])
    assert (np.diff(t1) > 0).all() and t1[-1] < 10.0
    assert 1800 < len(t1) < 2200


def _digest(root):
    h = hashlib.sha256()
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            with open(os.path.join(dirpath, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_cub_tree_repeats(tmp_path, tiny):
    mix = dict(spec_mod.Spec().traffic("cub-train-b24"), **tiny["mix"])
    for name, seed in (("a", BIG), ("b", BIG), ("c", BIG + 1)):
        info = workgen.write_cub_tree(str(tmp_path / name), seed, mix, 60)
        assert info == {"images": 16, "captions": 160}
    assert _digest(tmp_path / "a") == _digest(tmp_path / "b")
    assert _digest(tmp_path / "a") != _digest(tmp_path / "c")
