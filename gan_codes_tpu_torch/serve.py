"""Resident inference sampler and HTTP server (the port of
`gan_codes_tpu/serve.py`).

A `Sampler` keeps the generator and the text encoder resident on the device
and turns prompt or caption-token batches into images at a fixed batch size
(partial batches are padded, as the JAX package pads them to reuse its
compiled program). Every DFBlock of the generator runs through the
hand-written CUDA kernels (`ops/kernels/`). `build_sampler` loads the
reference-format weights (`gen_N.pth`, or the EMA generator's
`gen_ema_N.pth`) and gives the sampler its reload hooks,
`make_http_server` serves them over HTTP (hot reload, a weights-dir
watcher and request coalescing included), and `main` is the batch CLI.
`Sampler(devices=[...])` serves data-parallel in one process: one replica
per device, each padded batch split row-major over them.

Precision: on CUDA the entry points turn TF32 off for fp32 convs and
matmuls (`utils/device.py::serving_device`), so fp32 serving is fp32.
`dtype="bfloat16"` casts the generator's parameters and the noise to
bf16; the text encoder's parameters are rounded to bf16 and it computes in
fp32, as the JAX package's Sampler does (its encoder casts the bf16
parameters back up to fp32).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
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
from .models.torch_import import (_cfg_from_generator, _maybe_unwrap,
                                  _weights_name, latest_generator_epoch,
                                  latest_generator_weights, load_generator,
                                  load_text_encoder, torch_load_ref)
from .parallel.mesh import local_devices
from .utils.device import serving_device
from .utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _on(device: torch.device):
    """`device` made the current card for the block (the CPU needs none)."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


class Sampler:
    """Batched prompt -> image inference with resident modules.

    `generator` and `text_encoder` are moved to `device` (CUDA unless the
    caller passes "cpu"; raises without a card). The generator's parameter
    dtype is the serving dtype. Noise comes from a torch.Generator on the
    device seeded with `seed`, advanced once per dispatched batch.

    `devices` (a list of devices, all CUDA or all the CPU; it replaces
    `device`) serves data-parallel, the counterpart of the JAX Sampler's
    `mesh`: one replica of the generator and the text encoder per entry,
    each made the current card while it runs, and each padded batch split
    row-major over them, so `batch_size` must be divisible by the count.
    A list may name one card twice. The batch's noise is drawn once on the
    first device, so the images do not depend on the replica count.

    Weight-reload hooks (set by `build_sampler`, which owns the weights
    directory; None on a Sampler built directly):
    `reload_generator(epoch=None) -> (state_dict, epoch)` reads a
    generator's weights at the serving dtype onto the device,
    `latest_generator_epoch()
    -> Optional[int]` is the cheap newest-epoch probe of the `--watch`
    poller.

    `host_copies` counts the batches `generate_tokens` has copied to the
    host, by route: "pinned" (by DMA into pinned memory, on a card) or
    "pageable" (any other)."""

    reload_generator = None
    latest_generator_epoch = None

    def __init__(self, cfg: GANConfig, generator: Generator,
                 text_encoder: RNNEncoder,
                 word2code: Optional[Dict[str, int]] = None,
                 batch_size: int = 8, seed: int = 0,
                 device: str | torch.device = "cuda",
                 devices: Optional[Sequence[str | torch.device]] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if devices is not None:
            devs = [serving_device(d) for d in devices]
            if not devs or len({d.type for d in devs}) != 1:
                raise ValueError("devices must name one or more devices, "
                                 f"all CUDA or all the CPU: {devices}")
            if batch_size % len(devs):
                raise ValueError(
                    f"batch_size {batch_size} not divisible by the "
                    f"{len(devs)} devices")
        else:
            devs = [serving_device(device)]
        self.device = devs[0]
        self.cfg = cfg
        self.word2code = word2code
        self.batch_size = batch_size
        # the copies are made before any replica moves
        mods = [(generator, text_encoder)] + [
            (copy.deepcopy(generator), copy.deepcopy(text_encoder))
            for _ in devs[1:]]
        self.replicas = [(dev, g.to(dev).eval(), te.to(dev).eval())
                         for dev, (g, te) in zip(devs, mods)]
        _, self.generator, self.text_encoder = self.replicas[0]
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self.host_copies = {"pinned": 0, "pageable": 0}

    @property
    def dtype(self) -> torch.dtype:
        return self.generator.linear_in.weight.dtype

    def _next_noise(self, n: int) -> torch.Tensor:
        return torch.randn((n, self.cfg.generator.latent_dim),
                           generator=self._rng, device=self.device)

    @torch.inference_mode()
    def _launch(self, captions, cap_lens, noise) -> List[torch.Tensor]:
        """Encode + generate one batch, each replica on its block of rows,
        without waiting for the devices: the replicas' images, each on its
        device. The row count must be divisible by the replica count."""
        caps = torch.as_tensor(np.asarray(captions, np.int64))
        lens = torch.as_tensor(np.asarray(cap_lens, np.int64))
        noise = torch.as_tensor(noise)
        k, rest = divmod(caps.shape[0], len(self.replicas))
        if rest:
            raise ValueError(f"{caps.shape[0]} rows not divisible by the "
                             f"{len(self.replicas)} replicas")
        outs = []
        for i, (dev, g, te) in enumerate(self.replicas):
            rows = slice(i * k, (i + 1) * k)
            with _on(dev):
                sents = te(caps[rows].to(dev), lens[rows])
                outs.append(g(noise[rows].to(dev, self.dtype), sents))
        return outs

    def pipeline(self, captions, cap_lens, noise) -> torch.Tensor:
        """Encode + generate one batch: captions [B, T], cap_lens [B] (each
        1..T), noise [B, latent_dim] -> images [B, H, W, 3] on the (first)
        device, in the serving dtype. Noise is cast to the serving dtype."""
        outs = self._launch(captions, cap_lens, noise)
        if len(outs) == 1:
            return outs[0]
        return torch.cat([o.to(self.device) for o in outs])

    def swap_generator_params(self, state_dict: Dict[str, torch.Tensor]
                              ) -> None:
        """Replace the served generator weights, in every replica, with a
        reference-keyed state_dict of the same architecture (cast to the
        serving dtype).

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
            for _, g, _ in self.replicas:
                mine = g.state_dict()
                for k, v in state_dict.items():
                    mine[k].copy_(v)

    def generate_tokens(self, captions: np.ndarray,
                        cap_lens: np.ndarray) -> np.ndarray:
        """Token batch [N, T] + lengths [N] -> float32 images
        [N, H, W, 3] in [-1, 1], a C-contiguous, writable array of the
        caller's own (a later call never writes into it). N may be
        anything: batches are padded to `batch_size` with length-1 rows.

        Each batch's images are copied once, into their rows of the
        returned array, and the padding rows never leave the device. On a
        card the array is pinned host memory (from torch's caching host
        allocator, so its pages are pinned once and reused after the
        array is freed): each replica's rows are copied into it by DMA on
        that replica's current stream without waiting, so the host
        launches the next batch while this one computes and copies, and
        the streams are synchronised once, after the last batch. On the
        CPU each batch is copied into its rows. `host_copies` counts
        the batches by the route their copy took, "pinned" or "pageable".

        Under a torch profiler the call is span `sampler.generate`, tiled
        by `sampler.assemble` (the output's allocation and the padding),
        `sampler.launch` (each batch's noise, encode and G enqueued) and
        `sampler.to_host` (each batch's copies enqueued, then the wait
        for the devices)."""
        with span("sampler.generate"):
            captions = np.asarray(captions, np.int64)
            cap_lens = np.asarray(cap_lens, np.int64)
            n = captions.shape[0]
            bs = self.batch_size
            k = bs // len(self.replicas)
            size = self.cfg.generator.image_size
            cuda = self.device.type == "cuda"
            with span("sampler.assemble"):
                host = torch.empty((n, size, size, 3), dtype=torch.float32,
                                   pin_memory=cuda)
            pinned = cuda and host.is_pinned()
            for i in range(0, n, bs):
                c = captions[i: i + bs]
                l = cap_lens[i: i + bs]
                pad = bs - c.shape[0]
                if pad:
                    with span("sampler.assemble"):
                        c = np.concatenate([c, np.zeros((pad, c.shape[1]),
                                                        c.dtype)])
                        l = np.concatenate([l, np.ones((pad,), l.dtype)])
                # every replica's rows launch before the first copy to the
                # host
                with span("sampler.launch"):
                    imgs = self._launch(c, l, self._next_noise(bs))
                with span("sampler.to_host"):
                    for j, o in enumerate(imgs):
                        lo = i + j * k
                        keep = min(k, n - lo)
                        if keep <= 0:
                            break
                        host[lo: lo + keep].copy_(o.float()[:keep],
                                                  non_blocking=pinned)
                self.host_copies["pinned" if pinned else "pageable"] += 1
            with span("sampler.to_host"):
                if cuda:
                    for dev in dict.fromkeys(d for d, _, _ in
                                             self.replicas):
                        torch.cuda.current_stream(dev).synchronize()
            return host.numpy()

    def warmup(self) -> float:
        """Run the pipeline once on a dummy batch (loads the kernels and
        builds them if needed); returns the wall seconds. Uses a throwaway
        noise generator, so the served noise stream is unchanged."""
        t0 = time.perf_counter()
        max_len = self.cfg.text_encoder.max_len
        rng = torch.Generator(device=self.device).manual_seed(0)
        noise = torch.randn((self.batch_size, self.cfg.generator.latent_dim),
                            generator=rng, device=self.device)
        for out in self._launch(np.ones((self.batch_size, max_len), np.int64),
                                np.ones((self.batch_size,), np.int64), noise):
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
        """Images per second through the pipeline at `batch_size`, every
        replica on its rows as served.

        One warmup batch, then `n_batches` batches (the caption batch
        rolled each time, so every batch encodes afresh), timed with CUDA
        events on each card (the slowest card's window counts) and with
        the host clock on the CPU."""
        bs = self.batch_size
        max_len = self.cfg.text_encoder.max_len
        rng = np.random.default_rng(0)
        captions = rng.integers(1, self.cfg.text_encoder.vocab_size,
                                (bs, max_len))
        cap_lens = rng.integers(1, max_len + 1, (bs,))
        noise = self._next_noise(bs)
        for out in self._launch(captions, cap_lens, noise):
            out.float().cpu()
        cards = [] if self.device.type != "cuda" else [
            (d, torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
            for d in dict.fromkeys(d for d, _, _ in self.replicas)]
        for d, start, _ in cards:
            start.record(torch.cuda.current_stream(d))
        t0 = time.perf_counter()
        for i in range(n_batches):
            outs = self._launch(np.roll(captions, i, axis=0),
                                np.roll(cap_lens, i), noise)
        for d, _, end in cards:
            end.record(torch.cuda.current_stream(d))
        seconds = time.perf_counter() - t0
        if cards:
            seconds = 0.0
            for _, start, end in cards:
                end.synchronize()
                seconds = max(seconds, start.elapsed_time(end) / 1e3)
        if not all(torch.isfinite(o).all() for o in outs):
            raise RuntimeError("throughput run produced non-finite images")
        return bs * n_batches / seconds


def _arch(gcfg) -> tuple:
    return (gcfg.n_channels, gcfg.latent_dim, gcfg.sentence_dim,
            gcfg.affine_hidden, gcfg.image_size, gcfg.base_size)


def build_sampler(data_dir: str, encoder_weights_path: str,
                  gen_weights_dir: str, image_size: Optional[int] = None,
                  batch_size: int = 8, use_ema: bool = False,
                  dtype: str = "float32", seed: int = 0,
                  device: str | torch.device = "cuda",
                  data_parallel: bool = False) -> Tuple[Sampler, int]:
    """Load vocab and reference-format weights and build the Sampler;
    returns (sampler, N of the gen_N.pth served).

    Reads the vocab from `<data_dir>/captions.pickle`, the text encoder
    from `encoder_weights_path`, and the latest `gen_N.pth` in
    `gen_weights_dir` (`use_ema`: the latest `gen_ema_N.pth`, the EMA
    generator the trainer writes beside it). The architecture comes from
    the weights' shapes; an optional JAX-written `config.json` beside them
    must agree with it and supplies the rest of the config. An explicit
    `image_size` is checked against the weights. `data_parallel` serves
    one replica on every card of the process (`Sampler(devices=...)`).

    The sampler's reload hooks read the same directory: `reload_generator
    (epoch=None)` the latest (or the given) epoch's weights at the serving
    dtype, on the (first) device, `latest_generator_epoch()` the newest
    epoch. Under `use_ema`
    both look at `gen_ema_N.pth` names: the trainer writes `gen_N.pth`
    first, so a watcher following `gen_N.pth` would ask for an EMA file
    that is not there yet."""
    dev = serving_device(device)
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
    code2word, word2code = load_vocab(data_dir)
    gen_path, epoch = latest_generator_weights(gen_weights_dir, use_ema)
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
        cfg = _cfg_from_generator(gcfg)
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
    devices = None
    if data_parallel:
        devices = local_devices(dev)
        print(f"Serving data-parallel over {len(devices)} devices: "
              f"{', '.join(map(str, devices))}")
    sampler = Sampler(cfg, generator, text_encoder, word2code=word2code,
                      batch_size=batch_size, seed=seed, device=dev,
                      devices=devices)

    def reload_generator(epoch: Optional[int] = None
                         ) -> Tuple[Dict[str, torch.Tensor], int]:
        path, epoch = latest_generator_weights(gen_weights_dir, use_ema,
                                               epoch)
        sd = _maybe_unwrap(torch_load_ref(path), "generator")
        # on the device already, so the swap under the dispatch lock
        # copies on the card instead of from host memory
        return {k: v.to(sampler.device, sampler.dtype) for k, v in
                sd.items()}, epoch

    sampler.reload_generator = reload_generator
    sampler.latest_generator_epoch = lambda: latest_generator_epoch(
        gen_weights_dir, use_ema)
    return sampler, epoch


class RequestCoalescer:
    """Dynamic request batching for the HTTP server (the JAX package's
    `RequestCoalescer`): concurrent /generate requests ride one dispatch
    instead of each paying a whole padded batch.

    Handler threads `submit(captions, lens)` and block; one dispatcher
    thread takes the first queued request, keeps gathering until it has
    `max_items` prompts (default the sampler's batch size) or `window_s`
    has passed, runs `generate_tokens` once under the dispatch lock, and
    hands each waiter its slice. A failed dispatch raises its exception in
    every request of the batch. `dispatches` counts the batches run, and
    `queue_seconds` sums their requests' waits from `submit` to the
    dispatch (the dispatch lock taken); under a profiler a request waits
    in span `serve.queue`."""

    _STOP = object()

    def __init__(self, sampler: Sampler, lock, window_s: float,
                 max_items: Optional[int] = None):
        import queue
        import threading

        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self._sampler = sampler
        self._lock = lock
        self._window = window_s
        self._max = max_items or sampler.batch_size
        self._q = queue.Queue()
        self._stopped = False
        self.dispatches = 0
        self.queue_seconds = 0.0
        self._thread = threading.Thread(target=self._run,
                                        name="request-coalescer",
                                        daemon=True)
        self._thread.start()

    def submit(self, captions: np.ndarray, lens: np.ndarray) -> np.ndarray:
        import threading

        if self._stopped:
            raise RuntimeError("coalescer stopped (server shutting down)")
        slot = {"dispatched": threading.Event(), "done": threading.Event(),
                "images": None, "error": None, "caps": captions,
                "lens": lens, "queued_at": time.perf_counter()}
        with span("serve.queue"):
            self._q.put(slot)
            dispatched = slot["dispatched"].wait(timeout=600)
        # a first dispatch builds the kernels; a dead dispatcher must
        # still not hold the handler forever
        if not (dispatched and slot["done"].wait(timeout=600)):
            raise RuntimeError("coalescer dispatch timed out")
        if slot["error"] is not None:
            raise slot["error"]
        return slot["images"]

    def _run(self):
        import queue

        while True:
            slot = self._q.get()
            if slot is self._STOP:
                return
            batch = [slot]
            n = len(slot["caps"])
            deadline = time.monotonic() + self._window
            while n < self._max:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is self._STOP:
                    self._q.put(self._STOP)  # the outer loop stops on it
                    break
                batch.append(nxt)
                n += len(nxt["caps"])
            try:
                caps = np.concatenate([b["caps"] for b in batch])
                lens = np.concatenate([b["lens"] for b in batch])
                with self._lock:
                    at = time.perf_counter()
                    for b in batch:
                        b["dispatched"].set()
                    images = self._sampler.generate_tokens(caps, lens)
                self.dispatches += 1
                self.queue_seconds += sum(at - b["queued_at"] for b in batch)
                i = 0
                for b in batch:
                    b["images"] = images[i: i + len(b["caps"])]
                    i += len(b["caps"])
            except Exception as e:  # every waiter of the batch gets it
                for b in batch:
                    b["error"] = e
            finally:
                for b in batch:
                    b["dispatched"].set()
                    b["done"].set()

    def stop(self, timeout: float = 30.0):
        """Stop after the queued requests are dispatched; joins the
        dispatcher. A later `submit` fails at once."""
        self._stopped = True
        self._q.put(self._STOP)
        self._thread.join(timeout)


def make_http_server(sampler: Sampler, host: str = "127.0.0.1",
                     port: int = 0, max_prompts: int = 1024,
                     max_body_bytes: int = 16 << 20,
                     max_inflight: int = 64,
                     epoch: Optional[int] = None,
                     reloader=None,
                     watch_interval: Optional[float] = None,
                     latest_epoch_fn=None,
                     handler_timeout: Optional[float] = 120.0,
                     coalesce_window: Optional[float] = None):
    """HTTP server around a resident `Sampler` (stdlib only, JSON).

      GET  /healthz   -> {"status": "ok", "batch_size", "image_size",
                          "epoch", "pinned"}
      GET  /metrics   -> request/shed/error/image/reload counters and
                         the sums of successful /generate requests'
                         seconds: in the handler, waiting for their
                         dispatch ("queue_seconds_total": the dispatch
                         lock, or the coalescer's queue), and encoding
                         their images (+ "coalesced_dispatches");
                         "pinned_batches_total": the sampler's batches
                         copied by DMA into pinned host memory
      POST /generate  <- {"prompts": ["a red bird", ...]}
                         or {"captions": [[ids...]], "cap_lens": [...]}
                         + optional "format": "png" (default) | "jpeg",
                           "quality": 1..100 (jpeg, default 95)
                      -> {"images": [<base64>, ...], "count": N,
                          "format": "png" | "jpeg"}
      POST /reload    <- {} or {"epoch": N}: swap in the weights
                         `reloader(epoch=None) -> (state_dict, epoch)`
                         reads (`build_sampler`'s hook: the latest, or
                         epoch N), without a restart
                      -> {"status": "ok", "epoch", "pinned"}

    Client errors answer 400, a failed dispatch 500. /reload answers 400
    without a reloader or on a bad body, 404 when the weights are not
    there, 500 when the restore fails otherwise; it restores outside the
    dispatch lock and swaps inside it, one reload at a time. An explicit
    epoch pins it (the watcher leaves it be, as an operator's rollback);
    a bare reload unpins.

    `watch_interval` (seconds, CLI `--watch`) starts a watcher thread that
    polls `latest_epoch_fn()` and swaps in a newer epoch unless pinned; a
    failed reload keeps the current weights. `coalesce_window` (seconds,
    CLI `--coalesce-ms`) gathers concurrent /generate requests into one
    dispatch (`RequestCoalescer`).

    Dispatch is serialized through one lock; /generate requests beyond
    `max_inflight` are shed with a 503 instead of queueing, and the
    listen backlog holds `max_inflight` connections arriving at once.
    `handler_timeout` bounds every socket operation of a handler, and so
    how long a stalled client can hold a thread. Returns the bound
    `ThreadingHTTPServer` (port at `.server_address[1]`); call
    `.serve_forever()` to serve, then `.shutdown()` and `.server_close()`,
    which stops the coalescer and the watcher and joins the handlers.
    """
    import base64
    import io
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from PIL import Image

    from .utils.image_io import denormalize_to_uint8

    if max_inflight < 1:
        raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
    if watch_interval is not None:
        if reloader is None or latest_epoch_fn is None:
            raise ValueError("watch_interval needs both reloader and "
                             "latest_epoch_fn (build_sampler provides them)")
        if watch_interval <= 0:
            raise ValueError(
                f"watch_interval must be > 0, got {watch_interval}")
    lock = threading.Lock()
    inflight = threading.BoundedSemaphore(max_inflight)
    reload_lock = threading.Lock()  # one restore at a time
    stats_lock = threading.Lock()
    stats = {"requests_total": 0, "generate_ok": 0, "generate_error": 0,
             "shed_total": 0, "images_total": 0, "reloads_total": 0,
             "generate_seconds_total": 0.0, "last_generate_seconds": 0.0,
             "queue_seconds_total": 0.0, "encode_seconds_total": 0.0}
    state = {"epoch": epoch, "pinned": False}
    coalescer = (RequestCoalescer(sampler, lock, coalesce_window)
                 if coalesce_window is not None else None)

    def bump(**deltas):
        with stats_lock:
            for k, v in deltas.items():
                stats[k] += v

    def do_reload(want: Optional[int] = None) -> int:
        """The reload of POST /reload and the watcher: the restore outside
        the dispatch lock, the swap inside it."""
        with reload_lock:
            params, ep = reloader(epoch=want)
            with lock:
                sampler.swap_generator_params(params)
                state["epoch"] = ep
        bump(reloads_total=1)
        return ep

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
                          "epoch": state["epoch"],
                          "pinned": state["pinned"]})
            if self.path == "/metrics":
                with stats_lock:
                    snap = dict(stats)
                snap.update(epoch=state["epoch"], pinned=state["pinned"],
                            max_inflight=max_inflight,
                            batch_size=sampler.batch_size,
                            pinned_batches_total=sampler.host_copies[
                                "pinned"])
                if coalescer is not None:
                    snap["coalesced_dispatches"] = coalescer.dispatches
                    snap["queue_seconds_total"] = coalescer.queue_seconds
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
            if self.path == "/reload":
                return self._reload()
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

        def _reload(self):
            if reloader is None:
                self._drain_body()
                return self._send(
                    400, {"error": "reload not available: server was built "
                          "without a weights-directory reloader"})
            try:  # the client's mistakes
                n = int(self.headers.get("Content-Length", 0))
                if not 0 <= n <= max_body_bytes:
                    self._drain_body()
                    raise ValueError(
                        f"Content-Length must be 0..{max_body_bytes}")
                req = json.loads(self.rfile.read(n)) if n else {}
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                want = req.get("epoch")
                if want is not None:
                    want = int(want)
            except (ValueError, TypeError) as e:
                return self._send(400, {"error": str(e)})
            try:  # the server's: weights missing or unreadable
                ep = do_reload(want)
                state["pinned"] = want is not None
            except FileNotFoundError as e:
                return self._send(404, {"error": str(e)})
            except Exception as e:
                traceback.print_exc()
                return self._send(500,
                                  {"error": f"{type(e).__name__}: {e}"})
            self._send(200, {"status": "ok", "epoch": ep,
                             "pinned": state["pinned"]})

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
            queued = 0.0  # the coalescer sums its own queue's waits
            try:
                if coalescer is not None:
                    images = coalescer.submit(caps, lens)
                else:
                    t_queue = time.perf_counter()
                    with span("serve.queue"):
                        lock.acquire()
                    queued = time.perf_counter() - t_queue
                    try:
                        images = sampler.generate_tokens(caps, lens)
                    finally:
                        lock.release()
            except Exception as e:  # the server keeps serving; say why
                traceback.print_exc()
                bump(generate_error=1)
                return self._send(500, {"error": f"{type(e).__name__}: {e}"})
            t_encode = time.perf_counter()
            with span("serve.encode"):
                encoded = encode_images(images, fmt.upper(), quality)
            # request latency: lock wait + pipeline + image encode
            t_end = time.perf_counter()
            dt = t_end - t0
            with stats_lock:
                stats["generate_ok"] += 1
                stats["images_total"] += int(len(images))
                stats["generate_seconds_total"] += dt
                stats["last_generate_seconds"] = dt
                stats["queue_seconds_total"] += queued
                stats["encode_seconds_total"] += t_end - t_encode
            self._send(200, {"images": encoded, "count": int(len(images)),
                             "format": fmt})

    watcher_stop = threading.Event()

    def watch_loop():
        while not watcher_stop.wait(watch_interval):
            try:
                if state["pinned"]:  # held until a bare POST /reload
                    continue
                ep = latest_epoch_fn()
                if ep is None or ep == state["epoch"]:
                    continue
                ep = do_reload()
                print(f"[serve-http] watcher: now serving epoch-{ep} "
                      "weights", file=sys.stderr, flush=True)
            except Exception as e:  # the next poll retries
                print(f"[serve-http] watcher: reload failed, keeping "
                      f"epoch {state['epoch']}: {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)

    class Server(ThreadingHTTPServer):
        # Non-daemon handler threads: server_close() joins in-flight
        # handlers instead of exit killing them mid-response.
        daemon_threads = False
        _watcher_thread = None
        # The listen backlog holds a burst of max_inflight connections
        # (socketserver's default is 5): a connection beyond the backlog
        # has its SYN dropped and the client retries only after a 1 s
        # timeout, which set a 16-request burst's tail on the card.
        request_queue_size = max(5, max_inflight)

        def server_close(self):
            watcher_stop.set()
            if coalescer is not None:
                # before the handlers are joined: they may be waiting in
                # submit(), and stop() dispatches what is queued
                coalescer.stop()
            super().server_close()
            if self._watcher_thread is not None:
                self._watcher_thread.join(timeout=30)

    server = Server((host, port), Handler)
    if watch_interval is not None:
        server._watcher_thread = threading.Thread(
            target=watch_loop, name="weight-watcher", daemon=True)
        server._watcher_thread.start()
    return server


def main(data_dir: str, encoder_weights_path: str, gen_weights_dir: str,
         out_dir: str, prompts: Sequence[str],
         image_size: Optional[int] = None, batch_size: int = 8,
         use_ema: bool = False, dtype: str = "float32", seed: int = 0,
         device: str | torch.device = "cuda",
         data_parallel: bool = False) -> List[str]:
    """Batch prompt -> image serving: N prompts through one resident
    Sampler; writes one PNG per prompt plus a grid and returns the
    per-prompt paths. `use_ema` serves `gen_ema_N.pth`, `data_parallel`
    every card of the process. Runs on CUDA unless `device="cpu"`."""
    from .utils import image_io

    sampler, epoch = build_sampler(
        data_dir, encoder_weights_path, gen_weights_dir,
        image_size=image_size, batch_size=batch_size, use_ema=use_ema,
        dtype=dtype, seed=seed, device=device, data_parallel=data_parallel)
    images = sampler.generate_prompts(list(prompts))
    paths = [image_io.save_image(img, out_dir, f"serve_{i:04d}")
             for i, img in enumerate(images)]
    image_io.save_image_grid(images, os.path.join(out_dir, "serve_grid.png"))
    print(f"Served {len(paths)} prompts ({_weights_name(epoch, use_ema)}) "
          f"-> {out_dir}")
    return paths


def _cli(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import signal
    import threading

    ap = argparse.ArgumentParser(
        description="prompt -> image serving on CUDA cards "
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
    ap.add_argument("--dp", action="store_true",
                    help="serve data-parallel over all cards (one replica "
                         "each, prompt batch split over them; the card "
                         "count must divide batch-size)")
    ap.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    ap.add_argument("--ema", action="store_true",
                    help="serve from the EMA generator (gen_ema_N.pth)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompts-file", default=None,
                    help="file with one prompt per line")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="run a resident HTTP server instead of the batch "
                         "CLI: GET /healthz, GET /metrics, POST /generate, "
                         "POST /reload")
    ap.add_argument("--http-host", default="127.0.0.1",
                    help="bind address for --http (default loopback)")
    ap.add_argument("--max-inflight", type=int, default=64,
                    help="/generate requests beyond this are shed with 503")
    ap.add_argument("--coalesce-ms", type=float, default=None,
                    metavar="MS",
                    help="with --http: dynamic request batching — gather "
                         "concurrent /generate requests for up to this "
                         "many milliseconds (or one full pipeline batch) "
                         "and run them as ONE padded dispatch")
    ap.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                    help="with --http: poll the weights dir at this "
                         "interval and auto-serve newer gen_N epochs as "
                         "the trainer writes them (hot swap, no restart)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the startup warmup batch")
    ap.add_argument("prompts", nargs="*", help="prompts on the command line")
    a = ap.parse_args(argv)
    if a.max_inflight < 1:
        ap.error(f"--max-inflight must be >= 1, got {a.max_inflight}")
    if a.watch is not None:
        if a.http is None:
            ap.error("--watch requires --http")
        if a.watch <= 0:
            ap.error(f"--watch must be > 0 seconds, got {a.watch}")
    if a.coalesce_ms is not None:
        if a.http is None:
            ap.error("--coalesce-ms requires --http")
        if a.coalesce_ms <= 0:
            ap.error(f"--coalesce-ms must be > 0, got {a.coalesce_ms}")
    if a.http is None:
        prompts = list(a.prompts)
        if a.prompts_file:
            with open(a.prompts_file) as f:
                prompts += [l.strip() for l in f if l.strip()]
        if not prompts:
            ap.error("no prompts given (positional or --prompts-file)")
        main(a.data, a.text_encoder, a.weights, a.out, prompts,
             image_size=a.image_size, batch_size=a.batch_size,
             use_ema=a.ema, dtype=a.dtype, seed=a.seed,
             data_parallel=a.dp)
        return

    sampler, epoch = build_sampler(
        a.data, a.text_encoder, a.weights, image_size=a.image_size,
        batch_size=a.batch_size, use_ema=a.ema, dtype=a.dtype, seed=a.seed,
        data_parallel=a.dp)
    # bind before the warmup, so a port conflict fails fast
    server = make_http_server(
        sampler, host=a.http_host, port=a.http, max_inflight=a.max_inflight,
        epoch=epoch, reloader=sampler.reload_generator,
        watch_interval=a.watch,
        latest_epoch_fn=sampler.latest_generator_epoch,
        coalesce_window=(a.coalesce_ms / 1000.0
                         if a.coalesce_ms is not None else None))
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
        print(f"Serving {_weights_name(epoch, a.ema)} on "
              f"http://{a.http_host}:{server.server_address[1]} "
              f"(batch {a.batch_size}, {a.dtype}, "
              f"{', '.join(str(d) for d, _, _ in sampler.replicas)})",
              flush=True)
    server.serve_forever()
    server.server_close()
    print("Server stopped", flush=True)


if __name__ == "__main__":
    _cli()
