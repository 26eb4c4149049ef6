"""Resident inference sampler and HTTP server (the port of
`gan_codes_tpu/serve.py`).

A `Sampler` keeps the generator and the text encoder resident on the device
and turns prompt or caption-token batches into images at a fixed batch size
(partial batches are padded, as the JAX package pads them to reuse its
compiled program). Every DFBlock of the generator runs through the
hand-written CUDA kernels (`ops/kernels/`). `build_sampler` loads the
reference-format weights, `make_http_server` serves them over HTTP, and
`main` is the batch CLI.

Precision: on CUDA the entry points turn TF32 off for fp32 convs and
matmuls (`utils/device.py::serving_device`), so fp32 serving is fp32.
`dtype="bfloat16"` casts the generator's parameters and the noise to
bf16; the text encoder's parameters are rounded to bf16 and it computes in
fp32, as the JAX package's Sampler does (its encoder casts the bf16
parameters back up to fp32).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import GANConfig
from .generate import load_vocab, preprocess_caption
from .models.generator import Generator
from .models.text_encoder import RNNEncoder
from .models.torch_import import load_generator, load_text_encoder
from .utils.device import serving_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Sampler:
    """Batched prompt -> image inference with resident modules.

    `generator` and `text_encoder` are moved to `device` (CUDA unless the
    caller passes "cpu"; raises without a card). The generator's parameter
    dtype is the serving dtype. Noise comes from a torch.Generator on the
    device seeded with `seed`, advanced once per dispatched batch."""

    def __init__(self, cfg: GANConfig, generator: Generator,
                 text_encoder: RNNEncoder,
                 word2code: Optional[Dict[str, int]] = None,
                 batch_size: int = 8, seed: int = 0,
                 device: str | torch.device = "cuda"):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = serving_device(device)
        self.cfg = cfg
        self.word2code = word2code
        self.batch_size = batch_size
        self.generator = generator.to(self.device).eval()
        self.text_encoder = text_encoder.to(self.device).eval()
        self._rng = torch.Generator(device=self.device).manual_seed(seed)

    @property
    def dtype(self) -> torch.dtype:
        return self.generator.linear_in.weight.dtype

    def _next_noise(self, n: int) -> torch.Tensor:
        return torch.randn((n, self.cfg.generator.latent_dim),
                           generator=self._rng, device=self.device)

    @torch.inference_mode()
    def pipeline(self, captions, cap_lens, noise) -> torch.Tensor:
        """Encode + generate one batch: captions [B, T], cap_lens [B] (each
        1..T), noise [B, latent_dim] -> images [B, H, W, 3] on the device,
        in the serving dtype. Noise is cast to the serving dtype."""
        caps = torch.as_tensor(np.asarray(captions, np.int64)).to(self.device)
        lens = torch.as_tensor(np.asarray(cap_lens, np.int64))
        sents = self.text_encoder(caps, lens)
        noise = torch.as_tensor(noise).to(self.device, self.dtype)
        return self.generator(noise, sents)

    def swap_generator_params(self, state_dict: Dict[str, torch.Tensor]
                              ) -> None:
        """Replace the served generator weights with a reference-keyed
        state_dict of the same architecture (cast to the serving dtype).

        Not thread-safe on its own: callers serialize against in-flight
        generates."""
        own = self.generator.state_dict()
        if set(state_dict) != set(own):
            missing = sorted(set(own) - set(state_dict))[:5]
            extra = sorted(set(state_dict) - set(own))[:5]
            raise ValueError(
                "new generator params have a different structure than the "
                f"served generator (missing {missing}, unexpected {extra})")
        errs = [f"{k}: {tuple(v.shape)} != {tuple(own[k].shape)}"
                for k, v in state_dict.items()
                if tuple(v.shape) != tuple(own[k].shape)]
        if errs:
            raise ValueError("new generator params' shapes do not match the "
                             "served generator's: " + "; ".join(errs[:5]))
        with torch.no_grad():
            for k, v in state_dict.items():
                own[k].copy_(v)

    def generate_tokens(self, captions: np.ndarray,
                        cap_lens: np.ndarray) -> np.ndarray:
        """Token batch [N, T] + lengths [N] -> float32 images
        [N, H, W, 3] in [-1, 1]. N may be anything: batches are padded to
        `batch_size` with length-1 rows."""
        captions = np.asarray(captions, np.int64)
        cap_lens = np.asarray(cap_lens, np.int64)
        n = captions.shape[0]
        bs = self.batch_size
        outs = []
        for i in range(0, n, bs):
            c = captions[i: i + bs]
            l = cap_lens[i: i + bs]
            pad = bs - c.shape[0]
            if pad:
                c = np.concatenate([c, np.zeros((pad, c.shape[1]), c.dtype)])
                l = np.concatenate([l, np.ones((pad,), l.dtype)])
            img = self.pipeline(c, l, self._next_noise(bs))
            outs.append(img[: bs - pad].float().cpu().numpy())
        return np.concatenate(outs, axis=0)[:n]

    def warmup(self) -> float:
        """Run the pipeline once on a dummy batch (loads the kernels and
        builds them if needed); returns the wall seconds. Uses a throwaway
        noise generator, so the served noise stream is unchanged."""
        t0 = time.perf_counter()
        max_len = self.cfg.text_encoder.max_len
        rng = torch.Generator(device=self.device).manual_seed(0)
        noise = torch.randn((self.batch_size, self.cfg.generator.latent_dim),
                            generator=rng, device=self.device)
        out = self.pipeline(np.ones((self.batch_size, max_len), np.int64),
                            np.ones((self.batch_size,), np.int64), noise)
        out.float().cpu()  # waits for the device
        return time.perf_counter() - t0

    def tokenize_prompts(
            self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Free-text prompts -> (captions [N, max_len], lengths [N])."""
        if self.word2code is None:
            raise ValueError("Sampler needs word2code for free-text prompts")
        caps, lens = [], []
        for prompt in prompts:
            c, l = preprocess_caption(prompt, self.word2code,
                                      self.cfg.text_encoder.max_len)
            caps.append(c[0])
            lens.append(l[0])
        return np.stack(caps), np.asarray(lens)

    def generate_prompts(self, prompts: Sequence[str]) -> np.ndarray:
        """Free-text prompts -> images."""
        return self.generate_tokens(*self.tokenize_prompts(prompts))

    def throughput(self, n_batches: int = 10) -> float:
        """Images per second through the pipeline at `batch_size`.

        One warmup batch, then `n_batches` batches (the caption batch
        rolled each time, so every batch encodes afresh), timed with CUDA
        events on a card and the host clock on the CPU."""
        bs = self.batch_size
        max_len = self.cfg.text_encoder.max_len
        rng = np.random.default_rng(0)
        captions = rng.integers(1, self.cfg.text_encoder.vocab_size,
                                (bs, max_len))
        cap_lens = rng.integers(1, max_len + 1, (bs,))
        noise = self._next_noise(bs)
        self.pipeline(captions, cap_lens, noise).float().cpu()
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for i in range(n_batches):
            out = self.pipeline(np.roll(captions, i, axis=0),
                                np.roll(cap_lens, i), noise)
        if cuda:
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            seconds = time.perf_counter() - t0
        if not torch.isfinite(out).all():
            raise RuntimeError("throughput run produced non-finite images")
        return bs * n_batches / seconds


def latest_generator_weights(weights_dir: str) -> Tuple[str, int]:
    """(path, N) of the `gen_N.pth` with the largest N in `weights_dir`."""
    found = []
    for name in os.listdir(weights_dir):
        m = re.fullmatch(r"gen_(\d+)\.pth", name)
        if m:
            found.append((int(m.group(1)), name))
    if not found:
        raise FileNotFoundError(f"no gen_N.pth in {weights_dir}")
    epoch, name = max(found)
    return os.path.join(weights_dir, name), epoch


def _arch(gcfg) -> tuple:
    return (gcfg.n_channels, gcfg.latent_dim, gcfg.sentence_dim,
            gcfg.affine_hidden, gcfg.image_size, gcfg.base_size)


def build_sampler(data_dir: str, encoder_weights_path: str,
                  gen_weights_dir: str, image_size: Optional[int] = None,
                  batch_size: int = 8, dtype: str = "float32",
                  seed: int = 0, device: str | torch.device = "cuda"
                  ) -> Tuple[Sampler, int]:
    """Load vocab and reference-format weights and build the Sampler;
    returns (sampler, N of the gen_N.pth served).

    Reads the vocab from `<data_dir>/captions.pickle`, the text encoder
    from `encoder_weights_path`, and the latest `gen_N.pth` in
    `gen_weights_dir`. The architecture comes from the weights' shapes; an
    optional JAX-written `config.json` beside them must agree with it and
    supplies the rest of the config. An explicit `image_size` is checked
    against the weights."""
    dev = serving_device(device)
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
    code2word, word2code = load_vocab(data_dir)
    gen_path, epoch = latest_generator_weights(gen_weights_dir)
    generator, gcfg = load_generator(gen_path)
    if image_size is not None and image_size != gcfg.image_size:
        raise ValueError(
            f"{gen_path} holds a {gcfg.image_size}px generator; it cannot "
            f"be served at {image_size}px. Drop --image-size (the size "
            "comes from the weights).")
    cfg_path = os.path.join(gen_weights_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = GANConfig.from_dict(json.load(f))
        if _arch(cfg.generator) != _arch(gcfg):
            raise ValueError(
                f"{cfg_path} describes generator {_arch(cfg.generator)} "
                f"(n_channels, latent, sentence, hidden, image_size, base) "
                f"but {gen_path} holds {_arch(gcfg)}")
    else:
        cfg = GANConfig.for_image_size(gcfg.image_size,
                                       n_channels=gcfg.n_channels)
        cfg = dataclasses.replace(cfg, generator=gcfg)
    text_encoder, tcfg = load_text_encoder(encoder_weights_path)
    tcfg = dataclasses.replace(tcfg, max_len=cfg.text_encoder.max_len)
    if word2code and max(word2code.values()) >= tcfg.vocab_size:
        raise ValueError(
            f"captions.pickle codes reach {max(word2code.values())} but "
            f"{encoder_weights_path} embeds only {tcfg.vocab_size} tokens")
    if tcfg.hidden_dim != cfg.generator.sentence_dim:
        raise ValueError(
            f"text encoder gives {tcfg.hidden_dim}-wide sentences, the "
            f"generator takes {cfg.generator.sentence_dim}")
    cfg = dataclasses.replace(cfg, text_encoder=tcfg)

    if dtype == "bfloat16":
        generator = generator.to(torch.bfloat16)
        with torch.no_grad():
            for p in text_encoder.parameters():
                p.copy_(p.to(torch.bfloat16))
    sampler = Sampler(cfg, generator, text_encoder, word2code=word2code,
                      batch_size=batch_size, seed=seed, device=dev)
    return sampler, epoch


def make_http_server(sampler: Sampler, host: str = "127.0.0.1",
                     port: int = 0, max_prompts: int = 1024,
                     max_body_bytes: int = 16 << 20,
                     max_inflight: int = 64,
                     epoch: Optional[int] = None,
                     handler_timeout: Optional[float] = 120.0):
    """HTTP server around a resident `Sampler` (stdlib only, JSON).

      GET  /healthz   -> {"status": "ok", "batch_size", "image_size",
                          "epoch"}
      GET  /metrics   -> request/shed/error/image counters and generate
                         latency sums
      POST /generate  <- {"prompts": ["a red bird", ...]}
                         or {"captions": [[ids...]], "cap_lens": [...]}
                         + optional "format": "png" (default) | "jpeg",
                           "quality": 1..100 (jpeg, default 95)
                      -> {"images": [<base64>, ...], "count": N,
                          "format": "png" | "jpeg"}

    Client errors answer 400. Dispatch is serialized through one lock (one
    device); /generate requests beyond `max_inflight` are shed with a 503
    instead of queueing. `handler_timeout` bounds every socket operation
    of a handler, and so how long a stalled client can hold a thread.
    Returns the bound `ThreadingHTTPServer` (port at
    `.server_address[1]`); call `.serve_forever()` to serve, then
    `.shutdown()` and `.server_close()`.
    """
    import base64
    import io
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from PIL import Image

    from .utils.image_io import denormalize_to_uint8

    if max_inflight < 1:
        raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
    lock = threading.Lock()
    inflight = threading.BoundedSemaphore(max_inflight)
    stats_lock = threading.Lock()
    stats = {"requests_total": 0, "generate_ok": 0, "generate_error": 0,
             "shed_total": 0, "images_total": 0,
             "generate_seconds_total": 0.0, "last_generate_seconds": 0.0}

    def bump(**deltas):
        with stats_lock:
            for k, v in deltas.items():
                stats[k] += v

    def encode_images(images: np.ndarray, fmt: str, quality: int
                      ) -> List[str]:
        kw = {"quality": quality} if fmt == "JPEG" else {}
        out = []
        for img in images:
            buf = io.BytesIO()
            Image.fromarray(denormalize_to_uint8(img)).save(buf, format=fmt,
                                                            **kw)
            out.append(base64.b64encode(buf.getvalue()).decode("ascii"))
        return out

    class Handler(BaseHTTPRequestHandler):
        timeout = handler_timeout

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            try:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True  # client gone

        def log_message(self, fmt, *args):  # access log to stderr
            print(f"[serve-http] {self.address_string()} {fmt % args}",
                  file=sys.stderr)

        def do_GET(self):
            bump(requests_total=1)
            if self.path == "/healthz":
                return self._send(
                    200, {"status": "ok", "batch_size": sampler.batch_size,
                          "image_size": sampler.cfg.generator.image_size,
                          "epoch": epoch})
            if self.path == "/metrics":
                with stats_lock:
                    snap = dict(stats)
                snap.update(epoch=epoch, max_inflight=max_inflight,
                            batch_size=sampler.batch_size)
                return self._send(200, snap)
            self._send(404, {"error": "unknown path"})

        def _drain_body(self):
            """Read the unread body (bounded) before an error response, so
            the client sees the status code instead of a reset."""
            try:
                n = min(int(self.headers.get("Content-Length", 0)),
                        max_body_bytes)
            except (TypeError, ValueError):
                return
            while n > 0:
                chunk = self.rfile.read(min(n, 1 << 16))
                if not chunk:
                    break
                n -= len(chunk)

        def do_POST(self):
            bump(requests_total=1)
            if self.path != "/generate":
                self._drain_body()
                return self._send(404, {"error": "unknown path"})
            if not inflight.acquire(blocking=False):
                self._drain_body()
                bump(shed_total=1)
                return self._send(503, {"error": "server busy: "
                                        f"{max_inflight} requests in flight"})
            try:
                self._generate()
            finally:
                inflight.release()

        def _parse(self) -> Tuple[np.ndarray, np.ndarray, str, int]:
            n = int(self.headers.get("Content-Length", 0))
            if not 0 < n <= max_body_bytes:
                self._drain_body()
                raise ValueError(f"Content-Length must be 1..{max_body_bytes}")
            req = json.loads(self.rfile.read(n))
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
            prompts = req.get("prompts")
            captions = req.get("captions")
            if (prompts is None) == (captions is None):
                raise ValueError("pass exactly one of 'prompts' or 'captions'")
            items = prompts if prompts is not None else captions
            if not isinstance(items, list) or \
                    not 0 < len(items) <= max_prompts:
                raise ValueError(f"need a list of 1..{max_prompts} items")
            fmt = str(req.get("format", "png")).lower()
            if fmt not in ("png", "jpeg"):
                raise ValueError("format must be 'png' or 'jpeg'")
            quality = int(req.get("quality", 95))
            if not 1 <= quality <= 100:
                raise ValueError("quality must be 1..100")
            if prompts is not None:
                caps, lens = sampler.tokenize_prompts([str(p) for p in prompts])
                return caps, lens, fmt, quality
            # token path: normalize to the [N, max_len] width and check the
            # lengths (0 or > max_len would encode garbage silently)
            max_len = sampler.cfg.text_encoder.max_len
            vocab = sampler.cfg.text_encoder.vocab_size
            caps = np.zeros((len(captions), max_len), np.int64)
            for i, c in enumerate(captions):
                row = np.asarray(c, np.int64).reshape(-1)[:max_len]
                caps[i, : len(row)] = row
            if (caps < 0).any() or (caps >= vocab).any():
                raise ValueError(f"caption ids must be in 0..{vocab - 1}")
            lens = np.asarray(
                req.get("cap_lens", [min(len(c), max_len) for c in captions]),
                np.int64).reshape(-1)
            if lens.shape != (len(captions),) or (lens < 1).any() \
                    or (lens > max_len).any():
                raise ValueError(
                    f"cap_lens must be {len(captions)} ints in 1..{max_len}")
            return caps, lens, fmt, quality

        def _generate(self):
            t0 = time.perf_counter()
            try:
                caps, lens, fmt, quality = self._parse()
            except (ValueError, TypeError) as e:
                bump(generate_error=1)
                return self._send(400, {"error": str(e)})
            try:
                with lock:
                    images = sampler.generate_tokens(caps, lens)
            except Exception as e:  # the server keeps serving; say why
                traceback.print_exc()
                bump(generate_error=1)
                return self._send(500, {"error": f"{type(e).__name__}: {e}"})
            encoded = encode_images(images, fmt.upper(), quality)
            # request latency: lock wait + pipeline + image encode
            dt = time.perf_counter() - t0
            with stats_lock:
                stats["generate_ok"] += 1
                stats["images_total"] += int(len(images))
                stats["generate_seconds_total"] += dt
                stats["last_generate_seconds"] = dt
            self._send(200, {"images": encoded, "count": int(len(images)),
                             "format": fmt})

    class Server(ThreadingHTTPServer):
        # Non-daemon handler threads: server_close() joins in-flight
        # handlers instead of exit killing them mid-response.
        daemon_threads = False

    return Server((host, port), Handler)


def main(data_dir: str, encoder_weights_path: str, gen_weights_dir: str,
         out_dir: str, prompts: Sequence[str],
         image_size: Optional[int] = None, batch_size: int = 8,
         dtype: str = "float32", seed: int = 0,
         device: str | torch.device = "cuda") -> List[str]:
    """Batch prompt -> image serving: N prompts through one resident
    Sampler; writes one PNG per prompt plus a grid and returns the
    per-prompt paths. Runs on CUDA unless `device="cpu"`."""
    from .utils import image_io

    sampler, epoch = build_sampler(
        data_dir, encoder_weights_path, gen_weights_dir,
        image_size=image_size, batch_size=batch_size, dtype=dtype,
        seed=seed, device=device)
    images = sampler.generate_prompts(list(prompts))
    paths = [image_io.save_image(img, out_dir, f"serve_{i:04d}")
             for i, img in enumerate(images)]
    image_io.save_image_grid(images, os.path.join(out_dir, "serve_grid.png"))
    print(f"Served {len(paths)} prompts (gen_{epoch}.pth) -> {out_dir}")
    return paths


def _cli(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import signal
    import threading

    ap = argparse.ArgumentParser(
        description="prompt -> image serving on one CUDA card "
                    "(batch CLI, or an HTTP server with --http)")
    ap.add_argument("--data", default="data",
                    help="dataset dir (vocab from captions.pickle)")
    ap.add_argument("--text-encoder", default="text_encoder.pth")
    ap.add_argument("--weights", default="gen_weights",
                    help="dir of reference-format gen_N.pth (latest N "
                         "served), optionally with the JAX config.json")
    ap.add_argument("--out", default="served_images")
    ap.add_argument("--image-size", type=int, default=None,
                    help="check the weights' size (default: from weights)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompts-file", default=None,
                    help="file with one prompt per line")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="run a resident HTTP server instead of the batch "
                         "CLI: GET /healthz, GET /metrics, POST /generate")
    ap.add_argument("--http-host", default="127.0.0.1",
                    help="bind address for --http (default loopback)")
    ap.add_argument("--max-inflight", type=int, default=64,
                    help="/generate requests beyond this are shed with 503")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the startup warmup batch")
    ap.add_argument("prompts", nargs="*", help="prompts on the command line")
    a = ap.parse_args(argv)
    if a.max_inflight < 1:
        ap.error(f"--max-inflight must be >= 1, got {a.max_inflight}")
    if a.http is None:
        prompts = list(a.prompts)
        if a.prompts_file:
            with open(a.prompts_file) as f:
                prompts += [l.strip() for l in f if l.strip()]
        if not prompts:
            ap.error("no prompts given (positional or --prompts-file)")
        main(a.data, a.text_encoder, a.weights, a.out, prompts,
             image_size=a.image_size, batch_size=a.batch_size,
             dtype=a.dtype, seed=a.seed)
        return

    sampler, epoch = build_sampler(
        a.data, a.text_encoder, a.weights, image_size=a.image_size,
        batch_size=a.batch_size, dtype=a.dtype, seed=a.seed)
    # bind before the warmup, so a port conflict fails fast
    server = make_http_server(sampler, host=a.http_host, port=a.http,
                              max_inflight=a.max_inflight, epoch=epoch)
    stopping = threading.Event()

    def _stop(signum, _frame):
        print(f"Signal {signum}: stopping server...", flush=True)
        stopping.set()
        # shutdown() must not run on the serve_forever thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    if not a.no_warmup:
        print(f"Pipeline warm in {sampler.warmup():.1f}s", flush=True)
    if not stopping.is_set():
        print(f"Serving gen_{epoch}.pth on "
              f"http://{a.http_host}:{server.server_address[1]} "
              f"(batch {a.batch_size}, {a.dtype}, {sampler.device})",
              flush=True)
    server.serve_forever()
    server.server_close()
    print("Server stopped", flush=True)


if __name__ == "__main__":
    _cli()
