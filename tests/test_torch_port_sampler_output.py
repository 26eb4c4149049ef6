"""The Sampler's output path (`serve.Sampler.generate_tokens`): each batch's
images land once, in their rows of the array the call returns.

On the CPU: the array against the route it replaced (each replica's images
copied to the host, each batch concatenated, then the batches), bit for
bit, for counts around the batch size, with one replica and with two; its
dtype and layout; an array held from one call unchanged by later calls;
`host_copies` counting every batch. On a card (marked `cuda`, skips
without one): every batch copied into pinned memory, the images equal to
a pageable `.cpu()` of the same launch, with one replica and with two on
one card, and a held array surviving later calls. The file imports no JAX,
so on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_sampler_output.py
"""
import numpy as np
import pytest
import torch

from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch import serve
from gan_codes_tpu_torch.models.generator import Generator
from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
from torch_port_env import one_thread_children  # noqa: E402,F401

BS = 4


def _sampler(devices=None, device="cpu", batch_size=BS, n_channels=4,
             image_size=16, seed=0):
    """A seeded Sampler (every block gamma 0.5), noise stream `seed`."""
    cfg = pcfg.GANConfig(
        generator=pcfg.GeneratorConfig(n_channels=n_channels,
                                       image_size=image_size,
                                       sentence_dim=16),
        discriminator=pcfg.DiscriminatorConfig(n_channels=n_channels,
                                               image_size=image_size,
                                               sentence_dim=16),
        text_encoder=pcfg.TextEncoderConfig(vocab_size=20, embed_dim=8,
                                            hidden_dim=16, max_len=6))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        g = Generator(cfg.generator)
        te = RNNEncoder(cfg.text_encoder)
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith(".gamma"):
                p.fill_(0.5)
    return serve.Sampler(cfg, g, te, batch_size=batch_size, seed=seed,
                         device=device, devices=devices)


def _tokens(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 20, (n, 6)), rng.integers(1, 7, (n,))


def _concatenated(launches, n, bs):
    """The replaced route's array from each batch's replica images: each
    copied to pageable host memory, each batch concatenated and cut to
    its real rows, then the batches concatenated."""
    outs = []
    for i, imgs in zip(range(0, n, bs), launches):
        host = [o.float().cpu().numpy() for o in imgs]
        outs.append(np.concatenate(host)[: min(bs, n - i)])
    return np.concatenate(outs)


def _old_route(s, caps, lens):
    """The replaced route of `generate_tokens`, run on Sampler `s`."""
    n, bs = caps.shape[0], s.batch_size
    launches = []
    for i in range(0, n, bs):
        c, l = caps[i: i + bs], lens[i: i + bs]
        pad = bs - c.shape[0]
        c = np.concatenate([c, np.zeros((pad, c.shape[1]), c.dtype)])
        l = np.concatenate([l, np.ones((pad,), l.dtype)])
        launches.append(s._launch(c, l, s._next_noise(bs)))
    return _concatenated(launches, n, bs)


def _recording(s):
    """Record the replica images of each batch `s` launches."""
    launches = []
    launch = s._launch

    def recorded(*args):
        imgs = launch(*args)
        launches.append(imgs)
        return imgs

    s._launch = recorded
    return launches


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]],
                         ids=["one", "two-replicas"])
@pytest.mark.parametrize("n", [1, BS - 1, BS, BS + 1, 2 * BS + 3])
def test_generate_equals_the_concatenated_route(n, devices):
    """Two calls of N captions against a twin Sampler's old route (the
    same noise stream), bit for bit."""
    s, twin = _sampler(devices), _sampler(devices)
    for seed in (0, 1):
        caps, lens = _tokens(n, seed)
        got = s.generate_tokens(caps, lens)
        want = _old_route(twin, caps, lens)
        assert got.shape == (n, 16, 16, 3) == want.shape
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]],
                         ids=["one", "two-replicas"])
def test_output_is_a_float32_c_contiguous_writable_array(devices):
    a = _sampler(devices).generate_tokens(*_tokens(BS + 1))
    assert isinstance(a, np.ndarray) and a.dtype == np.float32
    assert a.flags.c_contiguous and a.flags.writeable
    a[0, 0, 0, 0] = 2.0  # the caller's own array
    assert a[0, 0, 0, 0] == 2.0


def test_held_array_unchanged_by_later_calls():
    s = _sampler()
    held = s.generate_tokens(*_tokens(BS + 1))
    kept = held.copy()
    for seed in (1, 2):
        later = s.generate_tokens(*_tokens(BS + 1, seed))
        assert not np.shares_memory(held, later)
    assert np.array_equal(held, kept)


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]],
                         ids=["one", "two-replicas"])
def test_host_copies_count_every_batch(devices):
    """Three batches, then one: four, each by the CPU's route; the
    counter is the Sampler's own."""
    s = _sampler(devices)
    assert s.host_copies == {"pinned": 0, "pageable": 0}
    s.generate_tokens(*_tokens(2 * BS + 1))
    s.generate_tokens(*_tokens(BS))
    assert s.host_copies == {"pinned": 0, "pageable": 4}
    assert _sampler(devices).host_copies["pageable"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("devices", [None, ["cuda:0", "cuda:0"]],
                         ids=["one", "two-replicas-one-card"])
def test_cuda_batches_land_pinned_as_the_pageable_copy(devices):
    """On a card, at n_channels 32 (every DFBlock on K2): each batch
    copied by DMA into pinned rows, the images equal to a pageable
    `.cpu()` of the same launch bit for bit, and an array held from one
    call unchanged after two more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc) to build and launch the "
                    "kernels")
    bs, n = 8, 19
    s = _sampler(devices, device="cuda", batch_size=bs, n_channels=32,
                 image_size=32)
    launches = _recording(s)
    caps, lens = _tokens(n)
    held = s.generate_tokens(caps, lens)
    assert s.host_copies == {"pinned": 3, "pageable": 0}
    assert held.dtype == np.float32 and held.flags.c_contiguous
    assert held.flags.writeable and np.isfinite(held).all()
    assert np.array_equal(held, _concatenated(launches, n, bs))
    kept = held.copy()
    for seed in (1, 2):
        later = s.generate_tokens(*_tokens(n, seed))
        assert not np.shares_memory(held, later)
    assert s.host_copies == {"pinned": 9, "pageable": 0}
    assert np.array_equal(held, kept)
