"""The port's spans (`gan_codes_tpu_torch/utils/profiling.py`): nothing
recorded and no `record_function` entered without a profiler; nested spans
under one (counts, parents, host, self and device seconds, user annotations
in the profiler's events); the profiler flag's helper; the train step's
four phases inside `train.step` and the Sampler's three parts inside
`sampler.generate`, with outputs bit for bit those of a run without a
profiler; `idle_by_span`'s grouping of the device's idle time.
"""
import numpy as np
import pytest
import torch

from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch import serve
from gan_codes_tpu_torch.models.generator import Generator
from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
from gan_codes_tpu_torch.train.trainer import Trainer
from gan_codes_tpu_torch.utils import profiling
from torch_port_env import one_thread_children  # noqa: E402,F401

STEP_PHASES = ("step.g_forward", "step.d_hinge", "step.magp",
               "step.g_hinge")
SAMPLER_PARTS = ("sampler.launch", "sampler.to_host", "sampler.assemble")


def _small_cfg():
    return pcfg.GANConfig(
        generator=pcfg.GeneratorConfig(n_channels=4, image_size=16,
                                       sentence_dim=16),
        discriminator=pcfg.DiscriminatorConfig(n_channels=4, image_size=16,
                                               sentence_dim=16),
        text_encoder=pcfg.TextEncoderConfig(vocab_size=20, embed_dim=8,
                                            hidden_dim=16, max_len=6))


def _text_encoder(cfg):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return RNNEncoder(cfg.text_encoder)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _records(name):
    return [r for r in profiling._records if r.name == name]


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def test_no_profiler_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.profiler_enabled()
    with profiling.span("t.host"):
        with profiling.span("t.device", "cpu"):
            torch.ones(4).sum()
    assert profiling.span("a") is profiling.span("b", "cpu")
    assert profiling.span_summary() == {}
    assert profiling._records == []


def test_profiler_flag_follows_start_and_stop():
    prof = _profile()
    assert not profiling.profiler_enabled()
    prof.start()
    try:
        assert profiling.profiler_enabled()
    finally:
        prof.stop()
    assert not profiling.profiler_enabled()
    with _profile():
        assert profiling.profiler_enabled()
    assert not profiling.profiler_enabled()


def test_nested_spans_count_parents_and_self_time():
    with _profile() as prof:
        with profiling.span("t.outer", "cpu"):
            for _ in range(2):
                with profiling.span("t.inner"):
                    torch.ones(64, 64).mm(torch.ones(64, 64))
    s = profiling.span_summary()
    assert set(s) == {"t.outer", "t.inner"}
    outer, inner = s["t.outer"], s["t.inner"]
    assert outer["count"] == 1 and inner["count"] == 2
    assert outer["host_s"] >= inner["host_s"] > 0
    assert outer["self_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=1e-9)
    assert inner["self_s"] == inner["host_s"]
    # the CPU as the device takes the host clock; a host span has none
    assert outer["device_s"] == outer["host_s"]
    assert inner["device_s"] is None
    (top,) = _records("t.outer")
    assert top.parent is None
    assert all(r.parent is top for r in _records("t.inner"))
    annotations = [e.name for e in prof.events()
                   if getattr(e, "is_user_annotation", False)]
    assert annotations.count("t.outer") == 1
    assert annotations.count("t.inner") == 2


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"images": rng.integers(0, 256, (2, 16, 16, 3), np.uint8),
             "captions": rng.integers(1, 20, (2, 6)).astype(np.int32),
             "cap_lens": np.full((2,), 6, np.int32)} for _ in range(n)]


def test_train_step_spans_tile_the_step(tmp_path):
    """Under a profiler one train_epoch of one batch records the four
    phases once each inside `train.step`, which has almost no time of its
    own; the state after it is bit for bit that of a run without one."""
    cfg = _small_cfg()
    runs = []
    for traced in (False, True):
        trainer = Trainer(cfg, _text_encoder(cfg),
                          str(tmp_path / f"w{traced}"),
                          str(tmp_path / f"i{traced}"), device="cpu")
        if traced:
            with _profile():
                means = trainer.train_epoch(_batches(1))
        else:
            means = trainer.train_epoch(_batches(1))
        trainer.close()
        runs.append((means, trainer.state))
    (means0, state0), (means1, state1) = runs
    assert means0 == means1
    for m in ("generator", "discriminator", "g_ema"):
        for (n, a), b in zip(getattr(state0, m).named_parameters(),
                             getattr(state1, m).parameters()):
            assert torch.equal(a, b), f"{m}.{n}"

    s = profiling.span_summary()
    assert s["train.step"]["count"] == 1
    assert s["train.stage"]["count"] == 2  # the batch, then the loader's end
    (step,) = _records("train.step")
    for name in STEP_PHASES:
        assert s[name]["count"] == 1, name
        assert _records(name)[0].parent is step
        assert s[name]["device_s"] > 0
    total = s["train.step"]
    assert total["self_s"] < 0.05 * total["host_s"]
    assert sum(s[n]["host_s"] for n in STEP_PHASES) == pytest.approx(
        total["host_s"] - total["self_s"])


def _sampler():
    cfg = _small_cfg()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g = Generator(cfg.generator)
        te = RNNEncoder(cfg.text_encoder)
    return serve.Sampler(cfg, g, te, batch_size=4, seed=3, device="cpu")


def test_sampler_spans_tile_generate():
    """Six captions at batch 4: the output's allocation, two launches and
    two batches' copies enqueued, the padding, the final wait, all inside
    `sampler.generate`; the images are those of a call without a
    profiler."""
    rng = np.random.default_rng(1)
    caps = rng.integers(1, 20, (6, 6))
    lens = rng.integers(1, 7, (6,))
    want = _sampler().generate_tokens(caps, lens)
    with _profile():
        got = _sampler().generate_tokens(caps, lens)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    s = profiling.span_summary()
    assert s["sampler.generate"]["count"] == 1
    assert [s[n]["count"] for n in SAMPLER_PARTS] == [2, 3, 2]
    (call,) = _records("sampler.generate")
    for name in SAMPLER_PARTS:
        assert all(r.parent is call for r in _records(name))
        assert s[name]["device_s"] is None
    children = sum(s[n]["host_s"] for n in SAMPLER_PARTS)
    assert children == pytest.approx(s["sampler.generate"]["host_s"]
                                     - s["sampler.generate"]["self_s"])
    assert children > 0.8 * s["sampler.generate"]["host_s"]


def test_idle_by_span_groups_the_gaps():
    # gaps (0, 2), (5, 7), (8, 10) of busy (2, 3), (2.5, 5), (7, 8): the
    # first's middle only in "x", the others' also in the shorter "y"
    got = profiling._gaps_by_span([(2, 3), (2.5, 5), (7, 8)],
                                  [("x", 0, 6), ("y", 5, 10)], 0, 10)
    assert got == {"(none)": 0.0, "x": 2.0, "y": 4.0}
    assert profiling._gaps_by_span([(0, 4)], [("x", 5, 6)], 0, 10) == {
        "(none)": 6.0}
    # a CPU profile: no device events, so the whole window is idle
    with _profile() as prof:
        with profiling.span("t.idle"):
            torch.ones(256, 256).mm(torch.ones(256, 256))
    idle = profiling.idle_by_span(prof)
    assert "(none)" in idle
    assert all(v >= 0 for v in idle.values())
    assert sum(idle.values()) > 0
