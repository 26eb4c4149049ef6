"""DF-GAN's step where it stays eager, on the CPU (`train/step.py::
DFGANStep`): the CPU, a mesh, `debug_nans` and a given noise replay no
CUDA graph and keep Adam's step counts on the host; the noise the step
draws itself is the draw a caller makes from `state.rng` just before it
(which the card tests' eager twins rely on); a checkpoint loads with
Adam counting on the host, whichever way it was saved; and the capture's
bindings follow what a restore or a new batch shape replaces. The graphed
path itself runs on the card (tests/test_torch_port_cuda.py::
TestGraphedStepOnCard).
"""
import io

import pytest
import torch

from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
from gan_codes_tpu_torch.parallel.mesh import Mesh
from gan_codes_tpu_torch.train import checkpoint as pckpt
from gan_codes_tpu_torch.train.state import create_train_state
from gan_codes_tpu_torch.train.step import (DFGANStep, _bindings, _same,
                                            make_train_step)
from torch_port_env import one_thread_children  # noqa: E402,F401

STEPS = 3


def _cfg(gp_interval=1):
    return pcfg.GANConfig(
        generator=pcfg.GeneratorConfig(n_channels=4, image_size=16,
                                       sentence_dim=16),
        discriminator=pcfg.DiscriminatorConfig(n_channels=4, image_size=16,
                                               sentence_dim=16),
        text_encoder=pcfg.TextEncoderConfig(vocab_size=20, embed_dim=8,
                                            hidden_dim=16, max_len=6),
        loss=pcfg.LossConfig(gp_interval=gp_interval),
        train=pcfg.TrainConfig(batch_size=4))


def _setup(cfg, seed=3):
    state = create_train_state(cfg, seed, device="cpu")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        te = RNNEncoder(cfg.text_encoder).eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(seed)
    batches = [(torch.rand((4, 16, 16, 3), generator=gen) * 2 - 1,
                torch.randint(1, 20, (4, 6), generator=gen),
                torch.randint(2, 7, (4,), generator=gen))
               for _ in range(STEPS)]
    return state, te, batches


def _tensors(state):
    out = [p.detach().clone() for m in (state.generator,
                                        state.discriminator, state.g_ema)
           for p in m.parameters()]
    for opt in (state.g_opt, state.d_opt):
        out += [v.clone() for p in opt.params
                for v in opt.adam.state[p].values()]
    return out


def _draw(state, cfg):
    return torch.randn((4, cfg.generator.latent_dim), generator=state.rng)


@pytest.mark.parametrize("case", ["cpu", "mesh", "debug_nans", "noise"])
def test_eager_paths_replay_nothing(case):
    """Each step eager: `replays` 0 of `steps` 3, Adam's groups not
    capturable and its step counts on the host, metrics finite."""
    cfg = _cfg()
    state, te, batches = _setup(cfg)
    step = make_train_step(cfg, mesh=Mesh() if case == "mesh" else None,
                           debug_nans=case == "debug_nans")
    assert isinstance(step, DFGANStep)
    for images, captions, lens in batches:
        noise = _draw(state, cfg) if case == "noise" else None
        m = step(state, te, images, captions, lens, noise=noise)
        assert all(torch.isfinite(v) for v in m.values())
    assert (step.steps, step.replays, state.step) == (STEPS, 0, STEPS)
    # G: one update a step; D: two (phases 1 and 2)
    for opt, updates in ((state.g_opt, STEPS), (state.d_opt, 2 * STEPS)):
        assert not any(g["capturable"] for g in opt.adam.param_groups)
        assert all(opt.adam.state[p]["step"].device.type == "cpu"
                   and float(opt.adam.state[p]["step"]) == updates
                   for p in opt.params)


@pytest.mark.parametrize("gp_interval", [1, 2])
def test_the_steps_own_draw_is_the_callers(gp_interval):
    """Noise drawn from `state.rng` just before each step and passed in
    leaves the same metrics and state, bit for bit, as the step's own
    draw: the noise and the NaN guard's numbers come from one stream."""
    cfg = _cfg(gp_interval)
    runs = []
    for given in (False, True):
        state, te, batches = _setup(cfg)
        step = make_train_step(cfg)
        rows = [step(state, te, *b, noise=_draw(state, cfg) if given
                     else None) for b in batches]
        runs.append(([{k: float(v) for k, v in m.items()} for m in rows],
                     _tensors(state), state.rng.get_state()))
    (rows_a, ts_a, rng_a), (rows_b, ts_b, rng_b) = runs
    assert rows_a == rows_b
    assert [r["d_gp_active"] for r in rows_a] == [
        float(i % gp_interval == 0) for i in range(STEPS)]
    assert all(torch.equal(a, b) for a, b in zip(ts_a, ts_b))
    assert torch.equal(rng_a, rng_b)


def test_checkpoint_loads_with_adam_counting_on_the_host():
    """A checkpoint whose Adam groups were capturable (a graphed run's)
    loads with them off and the counts on the host, and the next step
    equals the step from the same checkpoint saved plain, bit for bit."""
    cfg = _cfg()
    state, te, batches = _setup(cfg)
    step = make_train_step(cfg)
    step(state, te, *batches[0])
    buf = io.BytesIO()
    torch.save(pckpt.state_to_dict(state), buf)
    runs = []
    for graphed_blob in (False, True):
        buf.seek(0)
        blob = torch.load(buf, map_location="cpu", weights_only=True)
        if graphed_blob:
            for key in ("g_opt", "d_opt"):
                for group in blob[key]["param_groups"]:
                    group["capturable"] = True
        fresh, _, _ = _setup(cfg, seed=9)
        pckpt.load_state_dict(fresh, blob)
        for opt in (fresh.g_opt, fresh.d_opt):
            assert not any(g["capturable"] for g in opt.adam.param_groups)
            assert all(opt.adam.state[p]["step"].device.type == "cpu"
                       for p in opt.params)
        make_train_step(cfg)(fresh, te, *batches[1])
        runs.append(_tensors(fresh))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_checkpoint_of_a_capturable_state_is_the_plain_one():
    """`state_to_dict` of a state whose Adam counts its steps for the
    graphs writes what the same state counting on the host writes: the
    groups not capturable, the same counts and moments."""
    cfg = _cfg()
    state, te, batches = _setup(cfg)
    make_train_step(cfg)(state, te, *batches[0])
    plain = pckpt.state_to_dict(state)
    state.g_opt.set_capturable(True)
    state.d_opt.set_capturable(True)
    graphed = pckpt.state_to_dict(state)
    for key in ("g_opt", "d_opt"):
        assert graphed[key]["param_groups"] == plain[key]["param_groups"]
        assert not plain[key]["param_groups"][0]["capturable"]
        assert graphed[key]["state"].keys() == plain[key]["state"].keys()
        for i, st in plain[key]["state"].items():
            assert all(torch.equal(graphed[key]["state"][i][f], v)
                       and graphed[key]["state"][i][f].device == v.device
                       for f, v in st.items())
    assert state.g_opt.adam.defaults["capturable"]  # the live state keeps it


def test_set_capturable_keeps_the_counts():
    """`ClipAdam.set_capturable` flips the groups and moves each count
    as it is (a float32 scalar), on and off."""
    cfg = _cfg()
    state, te, batches = _setup(cfg)
    make_train_step(cfg)(state, te, *batches[0])
    opt = state.d_opt
    before = [opt.adam.state[p]["step"].clone() for p in opt.params]
    for on in (True, False):
        opt.set_capturable(on)
        assert opt.adam.defaults["capturable"] is on
        assert all(g["capturable"] is on for g in opt.adam.param_groups)
        assert all(torch.equal(opt.adam.state[p]["step"], b)
                   and opt.adam.state[p]["step"].dtype == torch.float32
                   for p, b in zip(opt.params, before))


def test_bindings_follow_what_replaces_the_state():
    """The capture's bindings hold across steps of one state and batch
    shape, and break on a checkpoint restore (new Adam states), a new
    generator, another batch shape or another precision."""
    cfg = _cfg()
    state, te, batches = _setup(cfg)
    step = make_train_step(cfg)
    images = batches[0][0]
    sents = torch.zeros((4, 16))
    step(state, te, *batches[0])
    key = _bindings(state, images, sents)
    step(state, te, *batches[1])
    assert _same(key, _bindings(state, images, sents))
    assert not _same(key, _bindings(state, images[:2], sents[:2]))
    previous = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = not previous
    try:
        assert not _same(key, _bindings(state, images, sents))
    finally:
        torch.backends.cudnn.deterministic = previous
    pckpt.load_state_dict(state, pckpt.state_to_dict(state))
    assert not _same(key, _bindings(state, images, sents))
    key = _bindings(state, images, sents)
    state.rng = torch.Generator().manual_seed(0)
    assert not _same(key, _bindings(state, images, sents))
