"""HTTP serving: `make_http_server(build_sampler(...))` with the
coalescer, and clients in a process of its own (`serve_client.py`)
sending free-text prompts: a closed loop of `concurrency` requests in
flight where the mix gives it (the served images a second are the
cell's number), else an open loop at Poisson arrivals of `rate_per_s`
(its latencies are).

Set-up writes the seed's weights as reference-format files under $TMPDIR
(`gen_1.pth`, `text_encoder.pth`, a vocabulary `captions.pickle`), builds
the sampler and the server, warms the sampler and then the whole path
(bursts of requests through HTTP). The window is the client's: an open
loop's schedule, or a closed loop's `seconds` of sends and then the wait
for the answers still in flight; the latencies are the client's, from
when each request was due (was sent, in a closed loop). The
harness wraps the sampler's `generate_tokens` to log each dispatch's
captions in order (the dispatch lock orders them as the noise draws), so
the reference knows which draw of the sampler's noise stream, and which
row of it, each checked request rode. Its images are compared as they
arrive: PNGs decoded to uint8.
"""
from __future__ import annotations

import base64
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import threading
import urllib.request
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import checks, core, weights, workgen
from ..reference import dfgan
from ..trace import Trace, profiler, warm_profiler
from . import common

CLIENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "serve_client.py")


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


class DispatchTracer:
    """The profiler over a window's dispatches, started and stopped in the
    dispatching thread (the one that launches the kernels): it starts at
    the first dispatch after `begin()` and stops at the first after
    `end()` asks, which posts one request to bring that dispatch."""

    def __init__(self):
        self.want, self.prof, self.units = None, None, 0
        self.stopped = threading.Event()

    def at_dispatch(self) -> None:
        if self.want == "start":
            self.prof, self.want = profiler(), None
            self.prof.start()
        elif self.want == "stop":
            self.prof.stop()
            self.want = None
            self.stopped.set()
            return
        if self.prof is not None and not self.stopped.is_set():
            self.units += 1

    def begin(self) -> None:
        self.want = "start"

    def end(self, url: str, prompt: str):
        """The stopped profiler (None when no dispatch started it)."""
        if self.prof is None:
            self.want = None
            return None
        self.want = "stop"
        req = urllib.request.Request(
            url + "/generate", data=json.dumps({"prompts": [prompt]})
            .encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            r.read()
        if not self.stopped.wait(60):
            raise RuntimeError("the dispatch thread did not stop the "
                               "profiler")
        return self.prof


class Serving:
    """The server of a cell, up and warm, with its dispatch log."""

    def __init__(self, ctx: core.Context):
        from gan_codes_tpu_torch.serve import build_sampler, make_http_server

        self.ctx = ctx
        cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
        common.set_precision(cfg)
        root = ctx.workdir
        workgen.write_vocab(os.path.join(root, "data"),
                            cfg["text_encoder"]["vocab_size"])
        os.makedirs(os.path.join(root, "weights"))
        for module, path in (("generator", "weights/gen_1.pth"),
                             ("text_encoder", "text_encoder.pth")):
            sd = weights.make(cfg, module, ctx.seed, dev)
            torch.save({k: v.cpu() for k, v in sd.items()},
                       os.path.join(root, path))
        self.noise_seed = workgen.torch_seed(ctx.seed, "serve.noise")
        self.batch = int(mix["batch_size"])
        self.sampler, epoch = build_sampler(
            os.path.join(root, "data"), os.path.join(root,
                                                     "text_encoder.pth"),
            os.path.join(root, "weights"), batch_size=self.batch,
            seed=self.noise_seed, device=dev)
        self.log: List[np.ndarray] = []
        self.tracer = DispatchTracer()
        dispatch = self.sampler.generate_tokens

        def logged(caps, lens):
            self.tracer.at_dispatch()
            self.log.append(np.array(caps, copy=True))
            return dispatch(caps, lens)

        self.sampler.generate_tokens = logged
        self.server = make_http_server(
            self.sampler, port=0, epoch=epoch,
            max_inflight=int(mix["max_inflight"]),
            coalesce_window=float(mix["coalesce_ms"]) / 1e3)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="bench-server")
        self.thread.start()
        self.sampler.warmup()
        if ctx.trace:
            warm_profiler()
        t = cfg["text_encoder"]
        self.vocab = workgen.vocabulary(t["vocab_size"])

    def prompts(self, stream: str, n: int) -> Tuple[List[str], np.ndarray]:
        t = self.ctx.cfg["text_encoder"]
        caps, lens = workgen.token_batch(
            workgen.rng(self.ctx.seed, stream), n, t["vocab_size"],
            t["max_len"], self.ctx.mix["caption_words"])
        return workgen.prompts(caps, lens, self.vocab), caps

    def metrics(self) -> dict:
        with urllib.request.urlopen(self.url + "/metrics", timeout=30) as r:
            return json.loads(r.read())

    def window(self, rate: Optional[float], seconds: float, stream: str,
               keep: int = 0, trace: bool = False,
               concurrency: Optional[int] = None) -> dict:
        """One window: an open loop at `rate` requests a second, or with
        `concurrency` a closed loop of that many in flight. Returns the
        client's result, the server's counters over it, with `trace` the
        profiler's trace of its dispatches, and the checked requests'
        tokens (`keep` of the requests drawn from the seed, of those
        that a closed loop surely sends: the first `sample_from_per_s`
        a second)."""
        mix = self.ctx.mix
        per = int(mix["prompts_per_request"])
        if concurrency is None:
            due = workgen.poisson_arrivals(
                workgen.rng(self.ctx.seed, stream + ".arrivals"), rate,
                seconds)
            n = pool = len(due)
            loop = {"due": due.tolist()}
        else:
            n = int(seconds * float(mix["prompt_pool_per_s"])) + concurrency
            pool = min(n, int(seconds * float(mix["sample_from_per_s"])))
            loop = {"concurrency": concurrency, "seconds": seconds}
        texts, tokens = self.prompts(stream + ".prompts", n * per)
        warm, _ = self.prompts(stream + ".warmup",
                               self.batch * int(mix["warmup_bursts"]))
        picked = sorted(workgen.rng(self.ctx.seed, stream + ".sample").choice(
            pool, size=min(keep, pool), replace=False).tolist())
        job = {"url": self.url, "timeout_s": float(mix["timeout_s"]),
               "warmup": [warm[i:i + self.batch]
                          for i in range(0, len(warm), self.batch)],
               "prompts": [texts[i * per:(i + 1) * per] for i in range(n)],
               "keep": picked, **loop}
        jpath = os.path.join(self.ctx.workdir, f"{stream}.job.json")
        rpath = os.path.join(self.ctx.workdir, f"{stream}.result.json")
        with open(jpath, "w") as f:
            json.dump(job, f)
        client = subprocess.Popen([sys.executable, CLIENT, jpath, rpath],
                                  stdin=subprocess.PIPE,
                                  stdout=subprocess.PIPE, text=True)
        prof = None
        try:
            if client.stdout.readline().strip() != "ready":
                raise RuntimeError("the client's warm-up failed")
            before, d0 = self.metrics(), len(self.log)
            if trace:
                self.tracer = DispatchTracer()
                self.tracer.begin()
            self.ctx.start_window()
            client.stdin.write("go\n")
            client.stdin.flush()
            client.wait(timeout=seconds + float(mix["timeout_s"]) + 60)
            self.ctx.end_window()
        finally:
            if client.poll() is None:
                client.kill()
                client.wait()
        if client.returncode != 0:
            raise RuntimeError(f"the client exited {client.returncode}")
        after = self.metrics()
        if trace:
            prof = self.tracer.end(self.url, warm[0])
        with open(rpath) as f:
            res = json.load(f)
        sent = len(res["status"])
        if concurrency is not None and sent == n:
            raise RuntimeError(f"the closed loop sent all {n} prompts "
                               "before its window ended: raise "
                               "prompt_pool_per_s")
        picked = [i for i in picked if i < sent]
        res.update(
            metrics={k: after[k] - before.get(k, 0) for k in after
                     if isinstance(after[k], (int, float))
                     and not isinstance(after[k], bool)},
            dispatches=len(self.log) - d0,
            trace=Trace(prof, self.tracer.units) if prof else None,
            tokens=[tokens[i * per:(i + 1) * per] for i in picked],
            picked=picked)
        return res

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)


def latency_stats(res: dict, timeout_s: float, per: int = 1
                  ) -> Dict[str, float]:
    """The images served a second over the window (`per` a successful
    request); p50 and p95 (ms) over every request of the window, a failed
    one counted at the timeout; failures; and how late the sends ran."""
    lat = [l if s == 200 else timeout_s for s, l in
           zip(res["status"], res["latency_s"])]
    ok = sum(s == 200 for s in res["status"])
    return {"img_per_s": per * ok / res["end_s"],
            "p50_ms": 1e3 * percentile(lat, 50),
            "p95_ms": 1e3 * percentile(lat, 95),
            "failed": sum(s != 200 for s in res["status"]),
            "late_p95_ms": 1e3 * percentile(res["late_s"], 95)}


def run(ctx: core.Context) -> core.Window:
    mix = ctx.mix
    closed = "concurrency" in mix
    serving = Serving(ctx)
    try:
        res = serving.window(
            None if closed else float(mix["rate_per_s"]), ctx.seconds,
            "serve", keep=int(ctx.cell_file["sample_requests"]),
            trace=ctx.trace,
            concurrency=int(mix["concurrency"]) if closed else None)
    finally:
        serving.close()
    peak = common.memory_peak(ctx.device)
    per = int(mix["prompts_per_request"])
    stats = latency_stats(res, float(mix["timeout_s"]), per)
    half = len(res["latency_s"]) // 2
    load = (f"{mix['concurrency']} in flight" if closed
            else f"{mix['rate_per_s']}/s")
    ctx.log(f"[serve] {len(res['status'])} requests at {load}: "
            f"{json.dumps(stats)}; {res['dispatches']} dispatches; "
            f"{len(res['picked'])} checked; p95 of the first and second "
            f"half {1e3 * percentile(res['latency_s'][:half], 95):.1f} / "
            f"{1e3 * percentile(res['latency_s'][half:], 95):.1f} ms; "
            "answers a second by third "
            f"{core.thirds(res['end_at_s'], 0.0, res['end_s'])}")
    log, noise_seed, batch = serving.log, serving.noise_seed, serving.batch
    del serving
    common.free(ctx.device)
    gaps = compare(ctx, res, log, noise_seed, batch)
    ctx.log(f"[serve] widest pixel difference {gaps.pop('px_max_diff')} "
            "levels (logged, not held: the control reads the same)")
    m = res["metrics"]
    program = {"images": m.get("images_total", 0),
               "dispatches": m.get("coalesced_dispatches", 0),
               "batch_size": batch,
               "generate_ok": m.get("generate_ok", 0),
               "generate_s": m.get("generate_seconds_total", 0.0)}
    return core.Window(
        e2e={"serve_img_per_s": stats["img_per_s"],
             "serve_p50_ms": stats["p50_ms"], "serve_p95_ms": stats["p95_ms"]},
        attempted=len(res["status"]), failed=stats["failed"],
        program=program, trace=res["trace"], memory_peak_bytes=peak,
        checks=gaps, seconds=res["end_s"])


def _decode(png_b64: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(png_b64)))
                      .convert("RGB"))


def locate(log: List[np.ndarray], batch: int, row: np.ndarray
           ) -> Optional[Tuple[int, int]]:
    """(draw, row in the draw) of the dispatched caption equal to `row`:
    the k-th dispatch's rows ride the sampler's draws from the count of
    draws before it, `batch` rows a draw."""
    draw = 0
    for caps in log:
        hit = np.nonzero((caps == row).all(axis=1))[0]
        if hit.size:
            r = int(hit[0])
            return draw + r // batch, r % batch
        draw += -(-len(caps) // batch)
    return None


def compare(ctx: core.Context, res: dict, log: List[np.ndarray],
            noise_seed: int, batch: int) -> Dict[str, float]:
    """The checked requests' images against the reference's, as uint8:
    the share of values that differ and the widest difference. A checked
    request without an image, or whose caption no dispatch carried, reads
    1 and 255."""
    wanted = []   # (program uint8 image or None, tokens, (draw, row))
    for i, toks in zip(res["picked"], res["tokens"]):
        imgs = res["kept"].get(str(i))
        for j, row in enumerate(toks):
            wanted.append((None if imgs is None else _decode(imgs[j]), row,
                           locate(log, batch, row)))
    if not wanted or any(img is None or at is None for img, _, at in wanted):
        return {"px_diff_share": 1.0, "px_max_diff": 255.0}
    ref = images(ctx, noise_seed, batch, [(row, at) for _, row, at in wanted])
    return checks.pixel_gaps(np.stack([img for img, _, _ in wanted]), ref)


@torch.no_grad()
def images(ctx: core.Context, noise_seed: int, batch: int, rows,
           precision=common.reference_precision, autocast=None
           ) -> np.ndarray:
    """The reference's uint8 images of each (caption row, (draw, row of
    the draw)) in `rows`, the draws being the sampler's, `batch` rows
    each."""
    cfg, dev = ctx.cfg, ctx.device
    precision()
    gp = weights.make(cfg, "generator", ctx.seed, dev)
    tp = weights.make(cfg, "text_encoder", ctx.seed, dev)
    z = cfg["generator"]["latent_dim"]
    rng = torch.Generator(device=dev).manual_seed(noise_seed)
    draws = [torch.randn((batch, z), generator=rng, device=dev)
             for _ in range(max(d for _, (d, _) in rows) + 1)]
    toks = np.stack([row for row, _ in rows])
    caps = torch.from_numpy(toks).to(dev)
    lens = torch.from_numpy((toks > 0).sum(axis=1).clip(min=1))
    noise = torch.stack([draws[d][r] for _, (d, r) in rows])
    with autocast() if autocast else contextlib.nullcontext():
        out = dfgan.generator(gp, noise, dfgan.text_encode(tp, caps, lens))
    return checks.to_uint8(out.float().permute(0, 2, 3, 1).cpu().numpy())
