"""The port's serving path (gan_codes_tpu_torch.serve / generate) on the
CPU: the Sampler pipeline against the JAX Sampler's, the HTTP surface
(mirroring tests/test_serve.py), the batch CLI on reference-format .pth
files, and the port's two promises: it imports no JAX, and it runs on the
CPU only when asked."""
import base64
import dataclasses
import io
import json
import os
import pickle
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gan_codes_tpu import config as jcfg
from gan_codes_tpu import generate as jgenerate
from gan_codes_tpu.models.generator import init_generator
from gan_codes_tpu.models.text_encoder import init_text_encoder
from gan_codes_tpu.serve import Sampler as JaxSampler
from gan_codes_tpu.utils import image_io as jimage_io
from gan_codes_tpu_torch import config as pcfg
from gan_codes_tpu_torch import generate, sample, serve, train_entry
from gan_codes_tpu_torch.models.generator import Generator
from gan_codes_tpu_torch.models.text_encoder import RNNEncoder
from gan_codes_tpu_torch.models.torch_import import (
    generator_state_dict_from_jax, text_encoder_state_dict_from_jax)
from gan_codes_tpu_torch.train.state import create_train_state
from gan_codes_tpu_torch.train.trainer import Trainer
from gan_codes_tpu_torch.utils import image_io
from gan_codes_tpu_torch.utils.seeding import fix_seed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORD2CODE = {"<end>": 0, "<unk>": 1, "bird": 2, "red": 3, "blue": 4}


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


def make_sampler(batch_size=4, seed=0):
    cfg = _small_cfg(pcfg)
    g, te = _modules(cfg)
    return serve.Sampler(cfg, g, te, WORD2CODE, batch_size=batch_size,
                         seed=seed, device="cpu")


def _write_reference_files(root, image_size=16, seed=0):
    """gen_3.pth + text_encoder.pth + captions.pickle, reference format."""
    cfg = pcfg.GANConfig.for_image_size(image_size, n_channels=4,
                                        vocab_size=len(WORD2CODE))
    g, te = _modules(cfg, seed)
    os.makedirs(os.path.join(root, "weights"), exist_ok=True)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    torch.save(g.state_dict(), os.path.join(root, "weights", "gen_3.pth"))
    torch.save(te.state_dict(), os.path.join(root, "text_encoder.pth"))
    code2word = {i: w for w, i in WORD2CODE.items()}
    with open(os.path.join(root, "data", "captions.pickle"), "wb") as f:
        pickle.dump(([], [], code2word, WORD2CODE), f)
    return (os.path.join(root, "data"), os.path.join(root, "text_encoder.pth"),
            os.path.join(root, "weights"))


class TestSampler:
    def test_pipeline_matches_jax_sampler(self):
        """Same weights, tokens and explicit noise through both Samplers'
        pipelines (encode + generate); atol/rtol 1e-4."""
        jc = _small_cfg(jcfg)
        g = init_generator(jax.random.PRNGKey(4), jc.generator)
        for i, bp in enumerate(g["blocks"]):
            bp["gamma"] = jnp.asarray(0.2 + 0.2 * i, jnp.float32)
        te = init_text_encoder(jax.random.PRNGKey(1), jc.text_encoder)
        js = JaxSampler(jc, g, te, WORD2CODE, batch_size=4)

        pc = _small_cfg(pcfg)
        pg, pte = Generator(pc.generator), RNNEncoder(pc.text_encoder)
        pg.load_state_dict(generator_state_dict_from_jax(
            jax.device_get(g)), strict=True)
        pte.load_state_dict(text_encoder_state_dict_from_jax(
            jax.device_get(te)), strict=True)
        ps = serve.Sampler(pc, pg, pte, WORD2CODE, batch_size=4,
                           device="cpu")

        rng = np.random.default_rng(0)
        caps = rng.integers(1, 20, (4, 6)).astype(np.int32)
        lens = np.array([6, 1, 3, 5], np.int32)
        noise = rng.standard_normal((4, 100)).astype(np.float32)
        want = js._pipeline(js._g_params, js._te_params, jnp.asarray(caps),
                            jnp.asarray(lens), jnp.asarray(noise))
        got = ps.pipeline(caps, lens, torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)

    def test_token_batch_any_size_and_noise_stream(self):
        s = make_sampler(batch_size=4)
        caps = np.ones((6, 6), np.int32)  # 6 items through bs-4: padding
        lens = np.full((6,), 6, np.int32)
        a = s.generate_tokens(caps, lens)
        assert a.shape == (6, 16, 16, 3) and a.dtype == np.float32
        assert np.isfinite(a).all() and np.abs(a).max() <= 1.0
        b = s.generate_tokens(caps, lens)
        assert not np.allclose(a, b)  # fresh noise per batch
        # the stream is seeded: a twin reproduces it; warmup leaves it be
        twin = make_sampler(batch_size=4)
        assert twin.warmup() > 0
        np.testing.assert_array_equal(twin.generate_tokens(caps, lens), a)
        imgs = s.generate_prompts(["a red bird", "a blue bird, big."])
        assert imgs.shape == (2, 16, 16, 3)

    def test_swap_generator_params_and_throughput(self):
        s = make_sampler()
        assert s.throughput(n_batches=2) > 0
        caps, lens = np.ones((2, 6), np.int32), np.full((2,), 6, np.int32)
        zeros = {k: torch.zeros_like(v)
                 for k, v in s.generator.state_dict().items()}
        s.swap_generator_params(zeros)
        assert np.array_equal(s.generate_tokens(caps, lens),
                              np.zeros((2, 16, 16, 3), np.float32))
        with pytest.raises(ValueError, match="shapes"):
            s.swap_generator_params({k: torch.zeros(v.shape + (1,))
                                     for k, v in zeros.items()})
        with pytest.raises(ValueError, match="structure"):
            s.swap_generator_params({"not": torch.zeros(())})

    def test_generate_from_prompt(self):
        cfg = _small_cfg(pcfg)
        g, te = _modules(cfg)
        img = generate.generate_from_prompt("a red bird", g.eval(),
                                            te.eval(), cfg, WORD2CODE,
                                            device="cpu")
        assert img.shape == (16, 16, 3) and np.isfinite(img).all()

    def test_caption_and_image_helpers_match_jax(self, tmp_path):
        for prompt in ["A red bird.", "bird, " * 30, "unknown words"]:
            for a, b in zip(generate.preprocess_caption(prompt, WORD2CODE),
                            jgenerate.preprocess_caption(prompt, WORD2CODE)):
                np.testing.assert_array_equal(a, b)
        caps, lens = generate.preprocess_caption(" ,. ", WORD2CODE)
        assert not caps.any() and lens.tolist() == [1]
        a = fix_seed(5)
        first = np.random.rand()
        b = fix_seed(5)
        assert np.random.rand() == first
        assert torch.equal(torch.randn(4, generator=a),
                           torch.randn(4, generator=b))
        rng = np.random.default_rng(3)
        imgs = rng.uniform(-1.2, 1.2, (5, 8, 8, 3)).astype(np.float32)
        np.testing.assert_array_equal(image_io.denormalize_to_uint8(imgs),
                                      jimage_io.denormalize_to_uint8(imgs))
        a = image_io.save_image_grid(imgs, str(tmp_path / "a.png"))
        b = jimage_io.save_image_grid(imgs, str(tmp_path / "b.png"))
        np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                      np.asarray(Image.open(b)))


class TestHTTPServe:
    """The HTTP surface, as tests/test_serve.py::TestHTTPServe drives the
    JAX package's."""

    def _post(self, url, payload, path="/generate"):
        req = urllib.request.Request(
            url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def test_healthz_generate_and_errors(self):
        server = serve.make_http_server(make_sampler(), port=0, epoch=3)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                h = json.loads(r.read())
            assert h["status"] == "ok" and h["batch_size"] == 4
            assert h["epoch"] == 3 and h["image_size"] == 16

            code, body = self._post(url, {"prompts": ["a red bird",
                                                      "a blue bird"]})
            assert code == 200 and body["count"] == 2
            img = Image.open(io.BytesIO(base64.b64decode(body["images"][0])))
            assert img.size == (16, 16) and img.mode == "RGB"

            # token path: 5 items through the bs-4 pipeline
            code, body = self._post(
                url, {"captions": [[2, 3, 0, 0, 0, 0]] * 5,
                      "cap_lens": [2] * 5})
            assert code == 200 and body["count"] == 5
            # ragged widths normalized, lengths defaulted
            code, body = self._post(url, {"captions": [[2, 3], [4]]})
            assert code == 200 and body["count"] == 2

            code, body = self._post(url, {"prompts": ["a red bird"],
                                          "format": "jpeg", "quality": 90})
            assert code == 200 and body["format"] == "jpeg"
            img = Image.open(io.BytesIO(base64.b64decode(body["images"][0])))
            assert img.format == "JPEG" and img.size == (16, 16)
            code, body = self._post(url, {"prompts": ["x"],
                                          "format": "webp"})
            assert code == 400 and "format" in body["error"]

            code, body = self._post(url, {})
            assert code == 400 and "exactly one" in body["error"]
            code, body = self._post(url, {"prompts": ["x"],
                                          "captions": [[1]]})
            assert code == 400
            code, body = self._post(url, {"prompts": []})
            assert code == 400
            code, body = self._post(url, {"prompts": "a red bird"})
            assert code == 400 and "list" in body["error"]
            code, body = self._post(url, {"captions": [[2, 3]],
                                          "cap_lens": [0]})
            assert code == 400 and "cap_lens" in body["error"]
            code, body = self._post(url, {"captions": [[2, 3]],
                                          "cap_lens": [99]})
            assert code == 400 and "cap_lens" in body["error"]
            code, body = self._post(url, {"captions": [[]]})
            assert code == 400 and "cap_lens" in body["error"]
            # ids outside the vocabulary never reach the embedding
            code, body = self._post(url, {"captions": [[2, 999]]})
            assert code == 400 and "ids" in body["error"]

            with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
                m = json.loads(r.read())
            assert m["generate_ok"] == 4 and m["images_total"] == 10
            assert m["generate_error"] == 9
        finally:
            server.shutdown()
            server.server_close()
            t.join(30)
        assert not t.is_alive()

    def test_load_shedding_503(self):
        sampler = make_sampler(batch_size=2)
        gate, entered = threading.Event(), threading.Event()
        real = sampler.generate_tokens

        def stub(caps, lens):
            entered.set()
            gate.wait(30)
            return real(caps, lens)

        sampler.generate_tokens = stub
        server = serve.make_http_server(sampler, port=0, max_inflight=1)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            first = {}

            def blocked():
                first["resp"] = self._post(url, {"prompts": ["a bird"]})

            t1 = threading.Thread(target=blocked)
            t1.start()
            assert entered.wait(30)
            code, body = self._post(url, {"prompts": ["another"]})
            assert code == 503 and "busy" in body["error"]
            gate.set()
            t1.join(60)
            assert not t1.is_alive()
            assert first["resp"][0] == 200
        finally:
            gate.set()
            server.shutdown()
            server.server_close()

    def test_max_inflight_validated(self):
        with pytest.raises(ValueError, match="max_inflight"):
            serve.make_http_server(make_sampler(), port=0, max_inflight=0)


class TestServeMain:
    def test_serve_main_end_to_end(self, tmp_path):
        """The batch CLI on reference-format files: vocab from the data dir,
        text_encoder.pth, the latest gen_N.pth; 3 prompts through a bs-2
        sampler (padding) in bf16."""
        args = _write_reference_files(str(tmp_path))
        torch.save({}, os.path.join(args[2], "gen_1.pth"))  # older epoch
        out = str(tmp_path / "served")
        paths = serve.main(*args, out, ["a red bird", "a blue bird",
                                        "small bird"],
                           image_size=16, batch_size=2, dtype="bfloat16",
                           device="cpu")
        assert len(paths) == 3 and all(os.path.exists(p) for p in paths)
        assert os.path.exists(os.path.join(out, "serve_grid.png"))
        assert np.asarray(Image.open(paths[0])).shape == (16, 16, 3)

    def test_build_sampler_checks_architecture(self, tmp_path):
        args = _write_reference_files(str(tmp_path))
        s, epoch = serve.build_sampler(*args, device="cpu")
        assert epoch == 3 and s.cfg.generator.image_size == 16
        assert s.cfg.text_encoder.vocab_size == len(WORD2CODE)
        with pytest.raises(ValueError, match="16px"):
            serve.build_sampler(*args, image_size=32, device="cpu")
        # a JAX-written config.json is read, and must agree with the weights
        jc = jcfg.GANConfig.for_image_size(
            16, n_channels=4, generator_overrides={"use_pallas": True})
        with open(os.path.join(args[2], "config.json"), "w") as f:
            json.dump(dataclasses.asdict(jc), f)
        s, _ = serve.build_sampler(*args, device="cpu")
        assert s.cfg.generator.use_pallas
        jc = jcfg.GANConfig.for_image_size(16, n_channels=8)
        with open(os.path.join(args[2], "config.json"), "w") as f:
            json.dump(dataclasses.asdict(jc), f)
        with pytest.raises(ValueError, match="config.json"):
            serve.build_sampler(*args, device="cpu")


class TestGenerateAndSample:
    def test_generate_main_with_prompt(self, tmp_path, capsys):
        """`generate.main` through its CLI with --prompt on reference-format
        files: the newest gen_N.pth (gen_3; gen_1 is older and empty)
        gives `generate_from_prompt`'s image as a PNG; --ema takes
        gen_ema_3.pth instead; an empty prompt writes nothing."""
        args = _write_reference_files(str(tmp_path))
        torch.save({}, os.path.join(args[2], "gen_1.pth"))
        cfg = pcfg.GANConfig.for_image_size(16, n_channels=4,
                                            vocab_size=len(WORD2CODE))
        g, te = _modules(cfg)
        ema, _ = _modules(cfg, seed=1)
        torch.save(ema.state_dict(), os.path.join(args[2], "gen_ema_3.pth"))
        cli = ["--data", args[0], "--text-encoder", args[1], "--weights",
               args[2], "--prompt", "a red bird", "--device", "cpu"]
        pixels = []
        for model, extra in ((g, []), (ema, ["--ema"])):
            out = str(tmp_path / f"out{len(pixels)}")
            path = generate._cli(cli + ["--out", out] + extra)
            assert path == os.path.join(out, "sample_from_prompt.png")
            assert f"saved to {path}" in capsys.readouterr().out
            want = generate.generate_from_prompt(
                "a red bird", model.eval(), te.eval(), cfg, WORD2CODE,
                device="cpu")
            got = np.asarray(Image.open(path))
            np.testing.assert_array_equal(
                got, image_io.denormalize_to_uint8(want))
            pixels.append(got)
        assert not np.array_equal(*pixels)
        assert generate.main(*args, str(tmp_path / "none"), prompt="",
                             device="cpu") is None
        assert not os.path.exists(tmp_path / "none")

    def test_sample_writes_one_png_per_item(self, tmp_path):
        """`sample.sample`: one PNG per batch item, named after its file
        name ('/'-safe), the denormalized G output for noise from the
        given torch.Generator; the same seed gives the same images."""
        cfg = _small_cfg(pcfg)
        g, te = _modules(cfg)
        g, te = g.eval(), te.eval()
        batch = {"captions": np.asarray([[2, 3, 0, 0, 0, 0],
                                         [4, 2, 3, 1, 0, 0]]),
                 "cap_lens": np.asarray([2, 4]),
                 "file_names": ["001.Black_Bird/a", "002.Red_Bird/b"]}
        paths = sample.sample(g, te, cfg, batch, str(tmp_path / "s"),
                              rng=torch.Generator().manual_seed(3),
                              device="cpu")
        assert [os.path.basename(p) for p in paths] == [
            "001.Black_Bird_a.png", "002.Red_Bird_b.png"]
        with torch.no_grad():
            sents = te(torch.as_tensor(batch["captions"]),
                       torch.as_tensor(batch["cap_lens"]))
            want = sample.generate_images(
                g, cfg, sents, torch.Generator().manual_seed(3)).numpy()
        for path, img in zip(paths, want):
            np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                          image_io.denormalize_to_uint8(img))
        again = sample.sample(g, te, cfg, batch, str(tmp_path / "t"),
                              rng=torch.Generator().manual_seed(3),
                              device="cpu")
        assert open(again[1], "rb").read() == open(paths[1], "rb").read()

class TestPortPromises:
    def test_port_imports_no_jax(self):
        """Every module of the package, and chip_smoke.py, imported in a
        fresh interpreter: neither jax nor the JAX package is loaded, nor
        matplotlib (imported only inside the one image helper that needs
        it, so the package imports where matplotlib is not installed)."""
        code = (
            "import importlib, pkgutil, sys\n"
            "import gan_codes_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'gan_codes_tpu' or "
            "m.startswith('gan_codes_tpu.') or m == 'matplotlib']\n"
            "n = sum(m.startswith('gan_codes_tpu_torch') for m in sys.modules)\n"
            "print(n, bad)\n"
            "sys.exit(1 if bad else 0)\n")
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
        assert int(r.stdout.split()[0]) >= 15

    def test_entry_points_refuse_a_silent_cpu(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        cfg = _small_cfg(pcfg)
        g, te = _modules(cfg)
        args = _write_reference_files(str(tmp_path))
        calls = [
            lambda: serve.Sampler(cfg, g, te, WORD2CODE),
            lambda: serve.build_sampler(*args),
            lambda: serve.main(*args, str(tmp_path / "o"), ["a bird"]),
            lambda: generate.generate_from_prompt("a bird", g, te, cfg,
                                                  WORD2CODE),
            lambda: generate.main(*args, str(tmp_path / "o"), "a bird"),
            lambda: sample.sample(g, te, cfg, {
                "captions": np.ones((1, 6)), "cap_lens": np.ones(1),
                "file_names": ["x"]}, str(tmp_path / "o")),
            lambda: serve._cli(["--data", args[0], "--text-encoder", args[1],
                                "--weights", args[2], "--out",
                                str(tmp_path / "o"), "a bird"]),
            lambda: serve._cli(["--data", args[0], "--text-encoder", args[1],
                                "--weights", args[2], "--http", "0"]),
            lambda: create_train_state(cfg, seed=0),
            lambda: Trainer(cfg, te, str(tmp_path / "o"),
                            str(tmp_path / "o")),
            lambda: train_entry.train(args[0], args[1], str(tmp_path / "o"),
                                      str(tmp_path / "o")),
            lambda: train_entry.main(["--data", args[0], "--images",
                                      str(tmp_path / "o"), "--weights",
                                      str(tmp_path / "o")]),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert not os.path.exists(tmp_path / "o")
