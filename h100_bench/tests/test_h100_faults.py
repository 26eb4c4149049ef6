"""A whole run, on the CPU at a tiny size, with the timed path broken
underneath: `correct` comes out false for every fault a cell can have.
(Every cell takes one chip, so no exchange between chips can be left
out.)"""
import numpy as np
import pytest
import torch

from h100_bench import core

SEED = 2**31 + 29


def _run(cell, tiny, spec=None):
    return core.run_cell(cell, SEED, 1.0, False, device="cpu", spec=spec,
                         size=tiny)


# the modules a fault leaves as they were before each step
KEPT = {"unchanged": ("generator", "discriminator", "g_ema"),
        "g_unchanged": ("generator",), "ema_unchanged": ("g_ema",)}


def _broken_step(monkeypatch, fault):
    """The trainer's step, with `fault` planted."""
    import gan_codes_tpu_torch.train.step as step_mod
    import gan_codes_tpu_torch.train.trainer as trainer_mod

    if fault == "ema_decay":  # the EMA at 0.99 where 0.999 is stated
        real_ema = step_mod.ema_update
        monkeypatch.setattr(step_mod, "ema_update",
                            lambda ema, model, decay: real_ema(ema, model,
                                                               0.99))
        return
    real = trainer_mod.make_train_step

    def make(cfg, mesh=None, debug_nans=False):
        step = real(cfg, mesh, debug_nans)

        def broken(state, te, images, captions, cap_lens, noise=None):
            if fault == "half_batch":  # the mean over the rest
                h = images.shape[0] // 2
                return step(state, te, images[:h], captions[:h],
                            cap_lens[:h])
            mods = [getattr(state, m) for m in KEPT[fault]]
            kept = [[p.detach().clone() for p in m.parameters()]
                    for m in mods]
            out = step(state, te, images, captions, cap_lens)
            with torch.no_grad():  # those modules left as they were
                for m, ps in zip(mods, kept):
                    for p, q in zip(m.parameters(), ps):
                        p.copy_(q)
            return out

        return broken

    monkeypatch.setattr(trainer_mod, "make_train_step", make)


@pytest.mark.parametrize("cell", ["cub256-fp32-train", "cub256-tf32-train"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "g_unchanged",
                                   "ema_unchanged", "ema_decay"])
def test_train_faults(cell, fault, tiny, monkeypatch):
    _broken_step(monkeypatch, fault)
    r = _run(cell, tiny)
    assert not r["correct"], r["checks"]


def _altered_answer(monkeypatch):
    """One image of each answer altered where the sampler produces it."""
    from gan_codes_tpu_torch.serve import Sampler

    real = Sampler.generate_tokens

    def altered(self, captions, cap_lens):
        out = real(self, captions, cap_lens)
        out[0] = np.clip(out[0] + 0.25, -1.0, 1.0)
        return out

    monkeypatch.setattr(Sampler, "generate_tokens", altered)


def _altered_token(monkeypatch):
    """One token of each prompt altered where the server produces it."""
    from gan_codes_tpu_torch.serve import Sampler

    real = Sampler.tokenize_prompts

    def altered(self, prompts):
        caps, lens = real(self, prompts)
        caps[:, 0] = (caps[:, 0] + 1) % self.cfg.text_encoder.vocab_size
        return caps, lens

    monkeypatch.setattr(Sampler, "tokenize_prompts", altered)


@pytest.mark.parametrize("cell,fault", [
    ("cub256-tf32-gen", _altered_answer),
    ("cub256-fp32-serve", _altered_answer),
    ("cub256-fp32-serve", _altered_token)])
def test_answer_faults(cell, fault, tiny, bench, monkeypatch):
    fault(monkeypatch)
    r = _run(cell, tiny, bench)
    assert not r["correct"], r["checks"]


def test_gen_token_fault(tiny, monkeypatch):
    """A caption token altered on its way into the sampler's pipeline."""
    from gan_codes_tpu_torch.serve import Sampler

    real = Sampler._launch

    def altered(self, captions, cap_lens, noise):
        captions = np.array(captions, copy=True)
        captions[:, 0] = (captions[:, 0] + 1) % 60
        return real(self, captions, cap_lens, noise)

    monkeypatch.setattr(Sampler, "_launch", altered)
    r = _run("cub256-tf32-gen", tiny)
    assert not r["correct"], r["checks"]
