"""The rest of the port's serving path on the CPU, as tests/test_serve.py
drives the JAX package's: POST /reload (pin and unpin), the weights-dir
watcher, request coalescing, the server's lifecycle, `build_sampler`'s
EMA weights and reload hooks, the CLI's checks, and data-parallel serving
(`Sampler(devices=[...])`) against the single sampler and against the JAX
`Sampler(mesh=make_mesh())`.

Where the JAX server answers a failed dispatch with 400, the port answers
500 (a server-side failure); every other status code is the JAX one.
"""
import base64
import io
import json
import os
import pickle
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gan_codes_tpu import config as jcfg
from gan_codes_tpu.models.generator import init_generator
from gan_codes_tpu.models.text_encoder import init_text_encoder
from gan_codes_tpu.parallel import make_mesh
from gan_codes_tpu.serve import Sampler as JaxSampler
from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch import generate, serve
from gan_codes_tpu_torch.data import make_synthetic_cub
from gan_codes_tpu_torch.models.generator import Generator
from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
from gan_codes_tpu_torch.models.torch_import import (
    generator_state_dict_from_jax, text_encoder_state_dict_from_jax)
from gan_codes_tpu_torch.train.checkpoint import CheckpointManager
from gan_codes_tpu_torch.train.state import create_train_state
from torch_port_env import one_thread_children  # noqa: E402,F401

WORD2CODE = {"<end>": 0, "<unk>": 1, "bird": 2, "red": 3, "blue": 4}
CAPS = np.tile(np.arange(1, 7, dtype=np.int64), (11, 1)) % 5


def _small_cfg(cls):
    return cls.GANConfig(
        generator=cls.GeneratorConfig(n_channels=4, image_size=16,
                                      sentence_dim=16),
        discriminator=cls.DiscriminatorConfig(n_channels=4, image_size=16,
                                              sentence_dim=16),
        text_encoder=cls.TextEncoderConfig(vocab_size=20, embed_dim=8,
                                           hidden_dim=16, max_len=6))


def _modules(cfg, seed=0):
    """Seeded port modules with every block gamma != 0."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = Generator(cfg.generator)
        te = RNNEncoder(cfg.text_encoder)
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith(".gamma"):
                p.fill_(0.5)
    return g, te


def make_sampler(batch_size=4, seed=0, devices=None, g_seed=0):
    cfg = _small_cfg(pcfg)
    g, te = _modules(cfg, g_seed)
    return serve.Sampler(cfg, g, te, WORD2CODE, batch_size=batch_size,
                         seed=seed, device="cpu", devices=devices)


def _zeros(sampler):
    return {k: torch.zeros_like(v)
            for k, v in sampler.generator.state_dict().items()}


def _start(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server):
    server.shutdown()
    server.server_close()


def _post(url, payload, path="/generate"):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


def _pixels(body):
    return np.asarray(Image.open(io.BytesIO(
        base64.b64decode(body["images"][0]))))


def _wait_for_epoch(url, epoch, seconds=15):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if _get(url, "/healthz")["epoch"] == epoch:
            return True
        time.sleep(0.05)
    return _get(url, "/healthz")["epoch"] == epoch


class TestReload:
    def test_reload_swaps_weights_metrics_and_epoch(self):
        """POST /reload swaps the served weights and moves /healthz's
        epoch; /metrics counts requests, images and reloads; a missing
        epoch is a 404, a bad body a 400."""
        sampler = make_sampler(batch_size=2)
        zeros = _zeros(sampler)

        def reloader(epoch=None):
            if epoch == 99:
                raise FileNotFoundError("No gen_99.pth in weights")
            return zeros, 7 if epoch is None else epoch

        server = serve.make_http_server(sampler, port=0, epoch=3,
                                        reloader=reloader)
        url = _start(server)
        try:
            assert _get(url, "/healthz")["epoch"] == 3
            code, _ = _post(url, {"prompts": ["a red bird"]})
            assert code == 200
            code, body = _post(url, {}, path="/reload")
            assert code == 200 and body["epoch"] == 7
            assert _get(url, "/healthz")["epoch"] == 7
            # all-zero weights: G's output is tanh(0) = 0 -> uint8 127/128
            code, body = _post(url, {"prompts": ["a red bird"]})
            assert set(np.unique(_pixels(body))) <= {127, 128}
            code, body = _post(url, {"epoch": 5}, path="/reload")
            assert code == 200 and body["epoch"] == 5
            code, body = _post(url, {"epoch": 99}, path="/reload")
            assert code == 404 and "gen_99" in body["error"]
            code, body = _post(url, {"epoch": "x"}, path="/reload")
            assert code == 400
            m = _get(url, "/metrics")
            assert m["generate_ok"] == 2 and m["images_total"] == 2
            assert m["reloads_total"] == 2 and m["epoch"] == 5
            assert m["generate_seconds_total"] > 0
            assert m["requests_total"] >= 8
        finally:
            _stop(server)

    def test_watcher_auto_reloads(self):
        """The watcher polls the latest epoch and swaps with no /reload
        call; it stops at server_close()."""
        sampler = make_sampler(batch_size=2)
        zeros = _zeros(sampler)
        current = {"epoch": 1, "params": sampler.generator.state_dict()}
        server = serve.make_http_server(
            sampler, port=0, epoch=1,
            reloader=lambda epoch=None: (current["params"],
                                         current["epoch"]),
            watch_interval=0.05, latest_epoch_fn=lambda: current["epoch"])
        url = _start(server)
        try:
            assert _get(url, "/healthz")["epoch"] == 1
            current["params"], current["epoch"] = zeros, 2
            assert _wait_for_epoch(url, 2)
            assert _get(url, "/metrics")["reloads_total"] == 1
            code, body = _post(url, {"prompts": ["a red bird"]})
            assert set(np.unique(_pixels(body))) <= {127, 128}
        finally:
            _stop(server)
        assert not server._watcher_thread.is_alive()

    def test_reload_pin_suppresses_watcher(self):
        """An explicit epoch pins: the watcher holds it against a newer
        latest; a bare reload unpins and the watcher follows again."""
        sampler = make_sampler(batch_size=2)
        keep = sampler.generator.state_dict()
        current = {"epoch": 5}

        def reloader(epoch=None):
            return keep, current["epoch"] if epoch is None else epoch

        server = serve.make_http_server(
            sampler, port=0, epoch=5, reloader=reloader,
            watch_interval=0.05, latest_epoch_fn=lambda: current["epoch"])
        url = _start(server)
        try:
            code, body = _post(url, {"epoch": 3}, path="/reload")
            assert code == 200 and body == {"status": "ok", "epoch": 3,
                                            "pinned": True}
            current["epoch"] = 6
            time.sleep(0.5)  # about 10 polls
            h = _get(url, "/healthz")
            assert h["epoch"] == 3 and h["pinned"] is True
            code, body = _post(url, {}, path="/reload")
            assert code == 200 and body["epoch"] == 6
            assert body["pinned"] is False
            current["epoch"] = 7
            assert _wait_for_epoch(url, 7)
            assert _get(url, "/metrics")["pinned"] is False
        finally:
            _stop(server)

    def test_failed_watch_reload_keeps_the_weights(self):
        """A reload the watcher cannot make (the trainer mid-write) keeps
        the served epoch and weights; the next poll retries."""
        sampler = make_sampler(batch_size=2)
        calls = {"n": 0}

        def reloader(epoch=None):
            calls["n"] += 1
            raise OSError("truncated file")

        server = serve.make_http_server(
            sampler, port=0, epoch=1, reloader=reloader,
            watch_interval=0.05, latest_epoch_fn=lambda: 2)
        url = _start(server)
        try:
            deadline = time.monotonic() + 15
            while calls["n"] < 3 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert calls["n"] >= 3
            m = _get(url, "/metrics")
            assert m["epoch"] == 1 and m["reloads_total"] == 0
            assert _post(url, {"prompts": ["a bird"]})[0] == 200
        finally:
            _stop(server)

    def test_reloader_failure_is_500_not_400(self):
        def bad_reloader(epoch=None):
            raise TypeError("wiring bug inside restore")

        server = serve.make_http_server(make_sampler(batch_size=2), port=0,
                                        reloader=bad_reloader)
        url = _start(server)
        try:
            code, body = _post(url, {}, path="/reload")
            assert code == 500 and "TypeError" in body["error"]
            code, body = _post(url, {"epoch": "x"}, path="/reload")
            assert code == 400
        finally:
            _stop(server)

    def test_reload_unavailable_without_reloader(self):
        server = serve.make_http_server(make_sampler(batch_size=2), port=0)
        url = _start(server)
        try:
            code, body = _post(url, {}, path="/reload")
            assert code == 400 and "reload not available" in body["error"]
        finally:
            _stop(server)

    def test_watch_validation(self):
        s = make_sampler(batch_size=2)
        with pytest.raises(ValueError, match="watch_interval"):
            serve.make_http_server(s, port=0, watch_interval=1.0)
        with pytest.raises(ValueError, match="watch_interval"):
            serve.make_http_server(s, port=0, watch_interval=0.0,
                                   reloader=lambda epoch=None: (None, 0),
                                   latest_epoch_fn=lambda: 0)


class TestServerLifecycle:
    def test_stalled_client_bounded_by_handler_timeout(self):
        server = serve.make_http_server(make_sampler(batch_size=2), port=0,
                                        handler_timeout=1.0)
        _start(server)
        try:
            s = socket.create_connection(
                ("127.0.0.1", server.server_address[1]))
            s.sendall(b"POST /nope HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: 1000000\r\n\r\nabc")  # then stall
            s.settimeout(15)
            t0 = time.monotonic()
            try:
                s.recv(65536)  # the server gives up within about 1 s
            except OSError:
                pass
            assert time.monotonic() - t0 < 8
            s.close()
        finally:
            server.shutdown()
            t0 = time.monotonic()
            server.server_close()  # joins the handler threads
            assert time.monotonic() - t0 < 8

    def test_backlog_holds_a_burst_of_max_inflight(self):
        """max_inflight connections arriving at once all connect before
        the accept loop runs; with socketserver's backlog of 5 the 7th
        waits for a SYN retry (1 s on Linux)."""
        server = serve.make_http_server(make_sampler(batch_size=2), port=0,
                                        max_inflight=32)
        conns = []
        try:
            for _ in range(32):
                conns.append(socket.create_connection(
                    ("127.0.0.1", server.server_address[1]), timeout=0.5))
        finally:
            for c in conns:
                c.close()
            server.server_close()
        assert len(conns) == 32

    def test_close_joins_inflight_handlers(self):
        sampler = make_sampler(batch_size=2)
        gate, entered = threading.Event(), threading.Event()
        real = sampler.generate_tokens

        def stub(caps, lens):
            entered.set()
            gate.wait(30)
            return real(caps, lens)

        sampler.generate_tokens = stub
        server = serve.make_http_server(sampler, port=0)
        url = _start(server)
        first = {}
        t1 = threading.Thread(target=lambda: first.update(
            resp=_post(url, {"prompts": ["a bird"]})))
        try:
            t1.start()
            assert entered.wait(30)
            server.shutdown()  # the accept loop stops; the handler runs on
            threading.Timer(0.5, gate.set).start()
            t0 = time.monotonic()
            server.server_close()
            assert time.monotonic() - t0 >= 0.4
        finally:  # a failed check still releases the handler and the port
            gate.set()
            _stop(server)
        t1.join(60)
        assert not t1.is_alive() and first["resp"][0] == 200

    def test_shed_503_readable_with_large_body(self):
        """The shed path drains an 8 MB body before answering, so the
        client reads the 503 instead of a reset."""
        sampler = make_sampler(batch_size=2)
        gate, entered = threading.Event(), threading.Event()
        real = sampler.generate_tokens

        def stub(caps, lens):
            entered.set()
            gate.wait(30)
            return real(caps, lens)

        sampler.generate_tokens = stub
        server = serve.make_http_server(sampler, port=0, max_inflight=1)
        url = _start(server)
        try:
            t1 = threading.Thread(target=_post, args=(
                url, {"prompts": ["a bird"]}), daemon=True)
            t1.start()
            assert entered.wait(30)
            code, body = _post(url, {"prompts": ["x"],
                                     "pad": "x" * (8 << 20)})
            assert code == 503 and "busy" in body["error"]
        finally:
            gate.set()
            _stop(server)


class TestCoalescer:
    def test_coalescer_batches_concurrent_requests(self):
        """Four concurrent one-prompt requests ride one or two dispatches;
        each client gets its own slice (its own noise row)."""
        sampler = make_sampler(batch_size=4)
        calls = {"n": 0}
        real = sampler.generate_tokens

        def counting(caps, lens):
            calls["n"] += 1
            return real(caps, lens)

        sampler.generate_tokens = counting
        server = serve.make_http_server(sampler, port=0,
                                        coalesce_window=1.0)
        url = _start(server)
        try:
            results = [None] * 4

            def post_one(i):
                results[i] = _post(url, {"prompts": ["a red bird"]})

            threads = [threading.Thread(target=post_one, args=(i,))
                       for i in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(120)
            assert all(r is not None and r[0] == 200 for r in results)
            assert all(r[1]["count"] == 1 for r in results)
            assert 1 <= calls["n"] <= 2
            assert len({r[1]["images"][0] for r in results}) == 4
            m = _get(url, "/metrics")
            assert m["coalesced_dispatches"] == calls["n"]
            assert m["generate_ok"] == 4 and m["images_total"] == 4
        finally:
            _stop(server)

    def test_coalescer_error_propagates_to_all_waiters(self):
        sampler = make_sampler(batch_size=4)

        def boom(caps, lens):
            raise RuntimeError("pipeline exploded")

        sampler.generate_tokens = boom
        server = serve.make_http_server(sampler, port=0,
                                        coalesce_window=0.5)
        url = _start(server)
        try:
            results = [None, None]

            def post_one(i):
                results[i] = _post(url, {"prompts": ["a bird"]})

            threads = [threading.Thread(target=post_one, args=(i,))
                       for i in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            for r in results:
                assert r[0] == 500 and "pipeline exploded" in r[1]["error"]
        finally:
            _stop(server)

    def test_stop_drains_the_queue_then_refuses(self):
        """stop() dispatches what is queued (every waiter answered), and a
        later submit fails at once instead of waiting."""
        sampler = make_sampler(batch_size=4)
        co = serve.RequestCoalescer(sampler, threading.Lock(), 5.0)
        caps, lens = np.full((1, 6), 2), np.full((1,), 2)
        got = []
        threads = [threading.Thread(
            target=lambda: got.append(co.submit(caps, lens)))
            for _ in range(2)]
        for th in threads:
            th.start()
        time.sleep(0.2)  # both queued inside the 5 s window
        t0 = time.monotonic()
        co.stop()
        for th in threads:
            th.join(30)
        assert time.monotonic() - t0 < 4.5
        assert len(got) == 2 and all(g.shape == (1, 16, 16, 3) for g in got)
        assert co.dispatches == 1
        with pytest.raises(RuntimeError, match="stopped"):
            co.submit(caps, lens)

    def test_coalescer_validation(self):
        with pytest.raises(ValueError, match="window_s"):
            serve.RequestCoalescer(make_sampler(batch_size=2), None, 0.0)


def _weights_dir(root, epochs=(3,), ema=True):
    """Reference-format gen_N.pth (and gen_ema_N.pth, other weights) +
    text_encoder.pth + captions.pickle; returns the three paths."""
    cfg = pcfg.GANConfig.for_image_size(16, n_channels=4,
                                        vocab_size=len(WORD2CODE))
    os.makedirs(os.path.join(root, "weights"), exist_ok=True)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    for n in epochs:
        g, te = _modules(cfg, seed=n)
        torch.save(g.state_dict(), os.path.join(root, "weights",
                                                f"gen_{n}.pth"))
        if ema:
            e, _ = _modules(cfg, seed=100 + n)
            torch.save(e.state_dict(), os.path.join(root, "weights",
                                                    f"gen_ema_{n}.pth"))
    torch.save(te.state_dict(), os.path.join(root, "text_encoder.pth"))
    code2word = {i: w for w, i in WORD2CODE.items()}
    with open(os.path.join(root, "data", "captions.pickle"), "wb") as f:
        pickle.dump(([], [], code2word, WORD2CODE), f)
    return (os.path.join(root, "data"), os.path.join(root, "text_encoder.pth"),
            os.path.join(root, "weights"))


class TestBuildSampler:
    def test_build_sampler_reload_latest(self, tmp_path):
        """The reload hook reads a newer gen_N.pth at the serving dtype,
        and an explicit older epoch; a missing one names its file."""
        args = _weights_dir(str(tmp_path), epochs=(3,))
        sampler, epoch = serve.build_sampler(*args, batch_size=2,
                                             dtype="bfloat16", device="cpu")
        assert epoch == 3 and sampler.latest_generator_epoch() == 3
        g5, _ = _modules(sampler.cfg, seed=5)
        torch.save(g5.state_dict(), os.path.join(args[2], "gen_5.pth"))
        assert sampler.latest_generator_epoch() == 5
        sd, ep = sampler.reload_generator()
        assert ep == 5 and sd["linear_in.weight"].dtype == torch.bfloat16
        assert torch.equal(sd["linear_in.weight"],
                           g5.linear_in.weight.detach().bfloat16())
        sampler.swap_generator_params(sd)
        assert np.isfinite(sampler.generate_prompts(["a red bird"])).all()
        assert sampler.reload_generator(epoch=3)[1] == 3
        with pytest.raises(FileNotFoundError, match="gen_9.pth"):
            sampler.reload_generator(epoch=9)

    def test_ema_serves_gen_ema_and_follows_its_names(self, tmp_path):
        """use_ema serves gen_ema_N.pth (its images are the EMA module's),
        and its hooks see only gen_ema_N names: a newer gen_N.pth whose
        EMA file is not written yet is not the latest."""
        args = _weights_dir(str(tmp_path), epochs=(1, 2))
        sampler, epoch = serve.build_sampler(*args, batch_size=2,
                                             use_ema=True, device="cpu")
        assert epoch == 2
        want, _ = _modules(sampler.cfg, seed=102)
        for k, v in want.state_dict().items():
            assert torch.equal(sampler.generator.state_dict()[k], v), k
        torch.save(want.state_dict(), os.path.join(args[2], "gen_3.pth"))
        assert sampler.latest_generator_epoch() == 2
        assert sampler.reload_generator()[1] == 2
        with pytest.raises(FileNotFoundError, match="gen_ema_3.pth"):
            sampler.reload_generator(epoch=3)
        bare = _weights_dir(str(tmp_path / "bare"), ema=False)
        with pytest.raises(FileNotFoundError, match=r"gen_ema_N\.pth"):
            serve.build_sampler(*bare, use_ema=True, device="cpu")

    def test_inference_mains_read_the_trainers_weights(self, tmp_path):
        """serve.main (EMA, data-parallel over the process's one CPU) and
        generate.main with no image size serve a 16px weights dir the
        port's trainer wrote (config.json, gen_N.pth, gen_ema_N.pth)."""
        root = str(tmp_path / "data")
        info = make_synthetic_cub(root, n_train=4, n_test=2, image_size=24)
        cfg = pcfg.GANConfig.for_image_size(16, n_channels=4,
                                            vocab_size=info["n_words"])
        weights = str(tmp_path / "weights")
        state = create_train_state(cfg, seed=0, device="cpu")
        CheckpointManager(weights).save(0, state, {"g_losses": [0.1]},
                                        config=cfg)
        te = RNNEncoder(cfg.text_encoder)
        pth = str(tmp_path / "text_encoder.pth")
        torch.save(te.state_dict(), pth)
        out = str(tmp_path / "served")
        paths = serve.main(root, pth, weights, out, ["a bird", "a bird"],
                           batch_size=2, use_ema=True, data_parallel=True,
                           device="cpu")
        assert len(paths) == 2
        assert np.asarray(Image.open(paths[0])).shape == (16, 16, 3)
        p = generate.main(root, pth, weights, str(tmp_path / "gen"),
                          prompt="a bird", use_ema=True, device="cpu")
        assert p is not None and os.path.exists(p)

    @pytest.mark.parametrize("flags, message", [
        (["--watch", "1"], "--watch requires --http"),
        (["--http", "0", "--watch", "0"], "--watch must be > 0"),
        (["--coalesce-ms", "50"], "--coalesce-ms requires --http"),
        (["--http", "0", "--coalesce-ms", "-1"], "--coalesce-ms must be > 0"),
    ])
    def test_cli_checks(self, flags, message, capsys):
        with pytest.raises(SystemExit) as e:
            serve._cli(flags + ["a bird"])
        assert e.value.code == 2
        assert message in capsys.readouterr().err


class TestSamplerDP:
    def test_dp_sampler_matches_single(self):
        """Two replicas, each on its rows of the padded batch, serve the
        images of one: the same seed draws the same noise."""
        single = make_sampler(batch_size=8, seed=3)
        dp = make_sampler(batch_size=8, seed=3, devices=["cpu", "cpu"])
        assert len(dp.replicas) == 2
        assert dp.replicas[0][1] is not dp.replicas[1][1]
        lens = np.full((11,), 6)
        a = single.generate_tokens(CAPS, lens)  # 11 items: one padded
        b = dp.generate_tokens(CAPS, lens)
        assert a.shape == b.shape == (11, 16, 16, 3)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)

    def test_batch_not_divisible_raises(self):
        with pytest.raises(ValueError, match="divisible"):
            make_sampler(batch_size=5, devices=["cpu", "cpu"])
        s = make_sampler(batch_size=4, devices=["cpu", "cpu"])
        with pytest.raises(ValueError, match="divisible"):
            s.pipeline(CAPS[:3], np.full((3,), 6), torch.zeros(3, 100))

    def test_dp_swap_matches_single(self):
        """A swap reaches every replica."""
        single = make_sampler(batch_size=8, seed=3)
        dp = make_sampler(batch_size=8, seed=3, devices=["cpu", "cpu"])
        g2, _ = _modules(single.cfg, seed=9)
        single.swap_generator_params(g2.state_dict())
        dp.swap_generator_params(g2.state_dict())
        for _, g, _ in dp.replicas:
            assert torch.equal(g.conv_out[1].weight, g2.conv_out[1].weight)
        lens = np.full((8,), 6)
        np.testing.assert_allclose(single.generate_tokens(CAPS[:8], lens),
                                   dp.generate_tokens(CAPS[:8], lens),
                                   atol=1e-5, rtol=1e-5)

    def test_dp_throughput_runs_every_replica(self):
        """throughput() times the replicated pipeline: every replica runs
        its rows of every timed batch, not one replica the whole batch."""
        s = make_sampler(batch_size=8, devices=["cpu", "cpu"])
        rows = []
        for _, g, _ in s.replicas:
            fwd = g.forward

            def counting(noise, sents, _fwd=fwd, _g=g):
                rows.append((id(_g), noise.shape[0]))
                return _fwd(noise, sents)
            g.forward = counting
        assert s.throughput(n_batches=2) > 0
        ids = [id(g) for _, g, _ in s.replicas]
        assert rows == [(i, 4) for _ in range(3) for i in ids]

    def test_dp_matches_jax_mesh_sampler(self):
        """The port's two replicas against the JAX Sampler sharded over
        its 8 CPU devices, on the same weights, tokens and explicit noise
        (through each pipeline); atol/rtol 1e-4."""
        jc = _small_cfg(jcfg)
        g = init_generator(jax.random.PRNGKey(4), jc.generator)
        for i, bp in enumerate(g["blocks"]):
            bp["gamma"] = jnp.asarray(0.2 + 0.2 * i, jnp.float32)
        te = init_text_encoder(jax.random.PRNGKey(1), jc.text_encoder)
        js = JaxSampler(jc, g, te, WORD2CODE, batch_size=8,
                        mesh=make_mesh())
        pc = _small_cfg(pcfg)
        pg, pte = Generator(pc.generator), RNNEncoder(pc.text_encoder)
        pg.load_state_dict(generator_state_dict_from_jax(
            jax.device_get(g)), strict=True)
        pte.load_state_dict(text_encoder_state_dict_from_jax(
            jax.device_get(te)), strict=True)
        ps = serve.Sampler(pc, pg, pte, WORD2CODE, batch_size=8,
                           devices=["cpu", "cpu"])
        rng = np.random.default_rng(0)
        caps = rng.integers(1, 20, (8, 6)).astype(np.int32)
        lens = rng.integers(1, 7, (8,)).astype(np.int32)
        noise = rng.standard_normal((8, 100)).astype(np.float32)
        want = js._pipeline(js._g_params, js._te_params, jnp.asarray(caps),
                            jnp.asarray(lens), jnp.asarray(noise))
        got = ps.pipeline(caps, lens, torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
