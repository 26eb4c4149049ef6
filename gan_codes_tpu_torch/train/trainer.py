"""The training engine: epoch loop, eval, checkpointing, sample dumps (the
port of `gan_codes_tpu/train/trainer.py`).

Capability parity with `DeepFusionGAN` (`src/deep_fusion_gan/model.py:
20-387`): owns G, D and the frozen text encoder, the TTUR Adam optimizers,
runs the 3-phase step per batch, evaluates per epoch, saves sample grids,
prompt-titled figures and full checkpoints (resume-safe, RNG and EMA
included), and prints the same per-epoch metric line.

On a card: uint8 batches go to the device from pinned memory,
non-blocking, and are normalized there; the step's metrics stay on the
device and come back to the host once per epoch. Batch i + 1's upload is
issued before step i, as the JAX trainer's `device_prefetch` does, always:
with one process on a card it runs on a side CUDA stream that the step's
stream waits for, elsewhere (the CPU, data parallelism) in the same order
on the step's; the steps and the trajectory are those of the plain loop.
`cfg.train.device_prefetch` (`--device-prefetch`) is kept so that the JAX
package's configs and command lines load, and changes nothing. Data order
and eval noise are keyed to the epoch, so a killed-and-resumed run equals
an uninterrupted one. `evaluate` computes IS and FID with the Inception
weights it was given (`eval/metrics.py`; the fakes, the reals and the
network stay on the device, the features come back), and records the
reference's failure sentinels, IS 1.0 and FID inf, without them.

Data parallelism (`mesh` given; `parallel/`): every rank starts from rank
0's state and steps through `make_train_step(cfg, mesh)` on its rows of
each global batch, so the per-epoch means come from the reduced metrics and
are the same on every rank. Rank 0 alone writes files (checkpoints, the
metrics log, sample dumps) and prints. Eval: each rank generates fakes for
its rows of the test batches, from its rows of eval noise drawn at the
global batch, and when the world is larger than one and Inception is
loaded every rank enters `compute_is_fid_multihost`, even with an empty
shard; the real side is cached as summed-moment inputs.

GALIP (`cfg` a `GALIPConfig`): the same loop, checkpoints and eval, with
GALIP's modules and step (`train/state.py`, `train/step.py`) and the CLIP
model in the text encoder's place.

Where the time goes is kept in `self.timers`, the device time of each step
and of each host-to-device copy (CUDA events on a card), and in
`self.host_seconds`, the host's seconds in `train_epoch` (which ends in the
epoch's one device sync), waiting for the loader inside it, evaluating and
checkpointing. Under a torch profiler two spans (`utils/profiling.py::
span`) mark the epoch loop's parts: `train.stage` (the wait for the
loader and the upload's enqueueing, on the host) and `train.step` (the step
function, on the host and the device).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import GANConfig, is_galip
from ..eval import metrics
from ..models.inception import inception_to
from ..parallel.dp import replicate
from ..parallel.mesh import Mesh
from ..utils import image_io
from ..utils.device import serving_device
from ..utils.profiling import MetricsLogger, StepTimer, span
from ..utils.seeding import fold_seed
from .checkpoint import CheckpointManager, empty_histories
from .state import TrainState, create_train_state
from .step import make_train_step


class Trainer:
    def __init__(self, cfg: GANConfig, text_encoder: torch.nn.Module,
                 checkpoint_dir: str, image_dir: str,
                 code2word: Optional[Dict[int, str]] = None,
                 inception_params=None, seed: Optional[int] = None,
                 device: str | torch.device = "cuda",
                 mesh: Optional[Mesh] = None, debug_nans: bool = False):
        """`text_encoder` maps (captions, cap_lens) to sentence embeddings
        and is frozen (for a `GALIPConfig`, the CLIP of `models/clip.py`,
        whose visual tower G's mapper and D's features share; the trainer
        counts its tokens a step in `clip_tokens`); it and
        `inception_params` (`models/inception.py`; None: IS/FID record
        their sentinels) are moved to `device` (CUDA
        unless the caller passes "cpu"; raises without a card), or under
        data parallelism to `mesh.device`. `debug_nans`: each step raises
        `FloatingPointError` at its first NaN (`train/step.py`)."""
        self.mesh = mesh
        self.primary = mesh is None or mesh.primary
        self.device = mesh.device if mesh is not None \
            else serving_device(device)
        self.cfg = cfg
        self.image_dir = image_dir
        self.code2word = code2word  # wired from the dataset (`train.py:31`)
        if self.primary:
            os.makedirs(image_dir, exist_ok=True)

        self.ckpt = CheckpointManager(checkpoint_dir,
                                      cfg.train.numbered_checkpoint_every,
                                      mesh=mesh)
        # rank 0 writes the log; the other ranks have none
        self.metrics_log = MetricsLogger(
            os.path.join(checkpoint_dir, "metrics_log.jsonl")) \
            if self.primary else None

        seed = cfg.train.seed if seed is None else seed
        galip = is_galip(cfg)
        self.state: TrainState = create_train_state(
            cfg, seed, device=self.device,
            clip=text_encoder if galip else None)
        self.text_encoder = text_encoder.to(self.device).eval()
        self.text_encoder.requires_grad_(False)
        if mesh is not None:
            replicate(mesh, self.state, self.text_encoder)
        self.inception_params = None if inception_params is None \
            else inception_to(inception_params, self.device)
        self._use_scipy_sqrtm = cfg.train.eval_sqrtm != "newton_schulz"
        # (test_loader, multihost, real side) for FID, _cached_real_side()
        self._real_fid_stats = None
        self._step_fn = make_train_step(cfg, mesh, debug_nans)
        # the batches' uploads run one ahead of the steps on a stream of
        # their own on a card with one process (as the JAX trainer's
        # device prefetch, `jax.process_count() == 1`), else on the step's
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" and (mesh is None
                                               or mesh.world == 1) else None
        self._eval_seed = seed + 1
        self._eval_rng = self._epoch_generator(0)
        # per-step scalar series of the last train_epoch (only retained when
        # cfg.train.log_every_steps > 0; consumed by fit's step-row flush)
        self._last_step_series = None
        self.timers = {"step": StepTimer(0, self.device),
                       "h2d": StepTimer(0, self.device)}
        self.host_seconds = {"train": 0.0, "data_wait": 0.0, "eval": 0.0,
                             "checkpoint": 0.0}
        # tokens through GALIP's CLIP towers in the last step (0: DF-GAN)
        self.clip_tokens = 0
        self._clip = text_encoder if galip else None

    def close(self) -> None:
        """Release the JSONL log file handle (idempotent)."""
        if self.metrics_log is not None:
            self.metrics_log.close()

    # ------------------------------------------------------------------

    def _epoch_generator(self, epoch: int) -> torch.Generator:
        """The eval noise generator of an epoch, seeded from (seed + 1,
        epoch) only (the JAX trainer's `fold_in(eval_base, epoch)`)."""
        return torch.Generator(device=self.device).manual_seed(
            fold_seed(self._eval_seed, epoch))

    def _device_batch(self, batch) -> Tuple[torch.Tensor, ...]:
        """Images and captions to the device (pinned, non-blocking on a
        card), images normalized there: uint8 / 127.5 - 1. Caption lengths
        stay on the host, where the packed LSTM reads them."""
        cuda = self.device.type == "cuda"

        def put(a):
            t = torch.from_numpy(np.asarray(a))
            if cuda:
                t = t.pin_memory()
            return t.to(self.device, non_blocking=cuda)

        images = put(batch["images"])
        captions = put(batch["captions"])
        cap_lens = torch.from_numpy(np.asarray(batch["cap_lens"]))
        if images.dtype == torch.uint8:
            images = images.float() / 127.5 - 1.0
        return images, captions, cap_lens

    def _stage(self, batches):
        """The loader's next batch on the device, or None at its end:
        (images, captions, cap_lens, ready). With the copy stream the
        upload runs there and `ready` is the event that ends it."""
        with span("train.stage"):
            t0 = time.perf_counter()
            batch = next(batches, None)
            self.host_seconds["data_wait"] += time.perf_counter() - t0
            if batch is None:
                return None
            stream = self._copy_stream
            with torch.cuda.stream(stream) if stream is not None \
                    else contextlib.nullcontext():
                with self.timers["h2d"]:  # its events on the upload's stream
                    staged = self._device_batch(batch)
                ready = None if stream is None else stream.record_event()
            return (*staged, ready)

    def _await(self, staged) -> Tuple[torch.Tensor, ...]:
        """The staged batch for the step's stream: it waits for the
        upload, and the caching allocator learns that the step's stream
        uses the tensors the side stream allocated."""
        *tensors, ready = staged
        if ready is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ready)
            for t in tensors:
                if t.is_cuda:
                    t.record_stream(compute)
        return tuple(tensors)

    def train_epoch(self, train_loader) -> Dict[str, float]:
        """One pass over the loader; returns each metric's mean over the
        epoch's steps (one host transfer for the whole epoch). Batch
        i + 1's upload is issued before step i."""
        metric_accum: Dict[str, List[torch.Tensor]] = {}
        batches = iter(train_loader)
        staged = self._stage(batches)
        while staged is not None:
            current = self._await(staged)
            staged = self._stage(batches)
            tokens = self._clip.tokens if self._clip is not None else 0
            with self.timers["step"], span("train.step", self.device):
                metrics = self._step_fn(self.state, self.text_encoder,
                                        *current)
            if self._clip is not None:
                self.clip_tokens = self._clip.tokens - tokens
            for k, v in metrics.items():
                metric_accum.setdefault(k, []).append(v)
        if not metric_accum:
            self._last_step_series = None
            return {}
        keys = list(metric_accum)
        host = torch.stack([torch.stack(metric_accum[k]).float()
                            for k in keys]).cpu().numpy().astype(np.float64)
        for timer in self.timers.values():  # the sync above made them due
            timer.resolve()
        out = dict(zip(keys, host))
        active = out.pop("d_gp_active", None)
        means = {k: float(np.mean(v)) for k, v in out.items()}
        self._last_step_series = dict(out) \
            if self.cfg.train.log_every_steps > 0 else None
        if active is not None:
            # Lazy regularization (gp_interval > 1): average d_gp_loss over
            # the steps where the GP phase ran. The step divides the
            # k-scaled penalty by k, so this masked mean equals the
            # reference's per-step coef * mean(norm^p) at any cadence.
            if self._last_step_series is not None:
                self._last_step_series["d_gp_active"] = active
            n_active = float(active.sum())
            means["d_gp_loss"] = (
                float((out["d_gp_loss"] * active).sum() / n_active)
                if n_active > 0 else 0.0)
        return means

    def _flush_step_rows(self, epoch: int) -> None:
        """Write every `log_every_steps`-th step's scalars as `kind="step"`
        JSONL rows, at epoch end, before the epoch row so rows stay
        time-ordered. The rows carry `epoch`, so a resume's
        `truncate_from(start_epoch)` drops replayed step rows together with
        their epoch row."""
        series = self._last_step_series
        k = self.cfg.train.log_every_steps
        if not series or k <= 0 or self.metrics_log is None:
            return
        n = len(next(iter(series.values())))
        first = int(self.state.step) - n  # global step idx before this epoch
        for i in range(k - 1, n, k):
            self.metrics_log.log(
                first + i + 1, kind="step", epoch=epoch,
                **{key: float(v[i]) for key, v in series.items()})
        self._last_step_series = None

    # ------------------------------------------------------------------

    @torch.no_grad()
    def generate(self, captions, cap_lens, use_ema: bool = False,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode captions + run G in float32 (the `sample.py:13-18`
        path); noise from the epoch's eval generator when not given (under
        data parallelism drawn at the global batch, this rank's rows)."""
        caps = torch.as_tensor(np.asarray(captions)).to(self.device)
        lens = torch.as_tensor(np.asarray(cap_lens))
        sents = self.text_encoder(caps, lens).float()
        if noise is None:
            b = sents.shape[0]
            world, rank = (1, 0) if self.mesh is None \
                else (self.mesh.world, self.mesh.rank)
            noise = torch.randn((b * world, self.cfg.generator.latent_dim),
                                generator=self._eval_rng,
                                device=self.device)[rank * b:(rank + 1) * b]
        g = self.state.g_ema if use_ema else self.state.generator
        return g(noise.to(self.device, torch.float32), sents)

    def evaluate(self, test_loader, use_ema: bool = False
                 ) -> Tuple[float, float, Optional[np.ndarray], object,
                            object]:
        """Per-epoch eval (`model.py:239-280`): generate fakes for up to
        `eval_max_batches` test batches and compute IS and FID against the
        batches' real images. Without Inception weights, or without data,
        the scores are the reference's failure sentinels (`src/evaluation/
        metrics.py:58-60,113-118`), IS 1.0 and FID inf (0.0 would read as
        a perfect FID). Returns (IS, FID, last fake batch on the host, its
        captions, its lengths). Under data parallelism with a world larger
        than one and Inception weights, the scores cover every rank's
        shard (a collective every rank enters, even with no batch)."""
        reals, fakes = [], []
        last = None
        for i, batch in enumerate(test_loader):
            if i >= self.cfg.train.eval_max_batches:
                break
            fake = self.generate(batch["captions"], batch["cap_lens"],
                                 use_ema=use_ema)
            if self.inception_params is not None:  # reals only for FID
                reals.append(self._device_batch(batch)[0])
                fakes.append(fake)
            last = (fake, batch["captions"], batch["cap_lens"])
        multihost = (self.inception_params is not None
                     and self.mesh is not None and self.mesh.world > 1)
        if last is None and not multihost:
            return 1.0, float("inf"), None, None, None
        is_score, fid_score = 1.0, float("inf")
        if self.inception_params is not None:
            s = self.cfg.generator.image_size
            empty = torch.zeros((0, s, s, 3), device=self.device)
            real_all = torch.cat(reals) if reals else empty
            fake_all = torch.cat(fakes) if fakes else empty
            real_side = self._cached_real_side(test_loader, real_all,
                                               multihost)
            if multihost:
                is_score, fid_score = metrics.compute_is_fid_multihost(
                    self.mesh, self.inception_params, fake_all, real_all,
                    real_moments=real_side)
            else:
                is_score, fid_score = metrics.compute_is_fid(
                    self.inception_params, fake_all, real_all,
                    real_stats=real_side,
                    use_scipy_sqrtm=self._use_scipy_sqrtm)
            if self.primary:
                print(f"Computed IS: {is_score:.4f}, FID: {fid_score:.4f}")
        if last is None:
            return is_score, fid_score, None, None, None
        fake, captions, cap_lens = last
        return is_score, fid_score, fake.float().cpu().numpy(), captions, \
            cap_lens

    def _cached_real_side(self, test_loader, real_all: torch.Tensor,
                          multihost: bool = False):
        """The real side for FID, computed once per loader when its images
        are the same every epoch: unshuffled and un-augmented
        (augmentation redraws per-item seeds each epoch): (mu, sigma,
        acts) on one process, this rank's summable moments under
        `multihost` (which never raise: a NaN travels as their flag).
        Keyed on the loader object and the mode, so another test loader
        does not reuse this one's, nor one mode the other's. None when
        caching does not apply (the FID path then computes the real side
        itself)."""
        deterministic = (
            getattr(test_loader, "shuffle", True) is False
            and getattr(getattr(test_loader, "dataset", None),
                        "augment", True) is False)
        if not deterministic:
            return None
        cached = self._real_fid_stats
        if (cached is None or cached[0] is not test_loader
                or cached[1] != multihost):
            if multihost:
                payload = metrics.activation_moments(self.inception_params,
                                                     real_all)
            else:
                try:
                    # the activations ride along, so compute_fid takes its
                    # exact low-rank cross term every epoch
                    payload = metrics.activation_stats(
                        self.inception_params, real_all, return_acts=True)
                except FloatingPointError:
                    # a deterministic loader gives the same NaN next
                    # epoch: cache the miss; compute_fid trips its own inf
                    # sentinel
                    payload = None
            self._real_fid_stats = (test_loader, multihost, payload)
        return self._real_fid_stats[2]

    def _save_samples(self, fake, captions, cap_lens, epoch: int) -> None:
        """Per-epoch image dumps (`model.py:329-387`): the PNG grid, then
        the prompt-titled figure. Each has its own guard, so a failing
        figure (matplotlib missing, say) still leaves the grid; neither
        stops training. Rank 0 alone writes them."""
        if not self.primary:
            return
        fake_np = np.asarray(fake)
        try:
            image_io.save_image_grid(
                fake_np, os.path.join(self.image_dir,
                                      f"fake_sample_epoch_{epoch}.png"))
        except Exception as e:  # a dump must not end the run
            print(f"Error saving the sample grid: {e!r}")
        try:
            prompts = [image_io.decode_caption(captions[i], cap_lens[i],
                                               self.code2word)
                       for i in range(min(4, fake_np.shape[0]))]
            image_io.save_images_with_prompts(
                fake_np, prompts,
                os.path.join(self.image_dir,
                             f"samples_with_text_epoch_{epoch}.jpg"))
        except Exception as e:  # a dump must not end the run
            print(f"Error saving images with text: {e!r}")

    # ------------------------------------------------------------------

    def fit(self, train_loader, test_loader=None,
            num_epochs: Optional[int] = None, start_epoch: int = 0,
            histories: Optional[Dict[str, List[float]]] = None,
            auto_resume: bool = True) -> Dict[str, List[float]]:
        num_epochs = num_epochs or self.cfg.train.num_epochs
        histories = histories if histories is not None else empty_histories()

        if auto_resume and start_epoch == 0 and self.ckpt.has_checkpoint():
            self.ckpt.verify_config(self.cfg)  # loud fail on semantic drift
            self.state, last_epoch, histories = self.ckpt.restore(self.state)
            start_epoch = last_epoch + 1
            if self.primary:
                print(f"Resuming from epoch {start_epoch}")
            # restored-metric print parity (`model.py:127-128`)
            if self.primary and histories.get("fid_scores"):
                print(f"Last checkpoint FID: "
                      f"{histories['fid_scores'][-1]:.4f}, "
                      f"IS: {histories['is_scores'][-1]:.4f}")

        # Epochs >= start_epoch are about to be (re)played: drop their stale
        # rows so the JSONL keeps one row per epoch. Unconditional: a crash
        # before the first checkpoint restarts at 0 yet may have logged.
        if self.metrics_log is not None:
            self.metrics_log.truncate_from(start_epoch)

        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            # Epoch-keyed data order and eval noise: a killed-and-resumed
            # run is bit-identical to an uninterrupted one. The eval loader
            # is pinned too (its per-item seeds choose the captions).
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            if test_loader is not None and hasattr(test_loader, "set_epoch"):
                test_loader.set_epoch(epoch)
            self._eval_rng = self._epoch_generator(epoch)
            t_train = time.perf_counter()
            epoch_metrics = self.train_epoch(train_loader)
            self.host_seconds["train"] += time.perf_counter() - t_train

            histories["g_losses"].append(epoch_metrics.get("g_loss", 0.0))
            histories["d_losses"].append(epoch_metrics.get("d_loss", 0.0))
            histories["d_gp_losses"].append(epoch_metrics.get("d_gp_loss",
                                                              0.0))
            histories["txtimg_losses"].append(
                epoch_metrics.get("txtimg_loss", 0.0))

            eval_loader = test_loader if test_loader is not None \
                else train_loader
            # Eval cadence (TrainConfig.eval_every_epochs): skipped epochs
            # record the sentinels so histories stay one entry per epoch;
            # the final epoch always evaluates; 0 = only the final epoch.
            t_eval = time.perf_counter()
            k_eval = self.cfg.train.eval_every_epochs
            if ((k_eval > 0 and (epoch + 1) % k_eval == 0)
                    or epoch == num_epochs - 1):
                is_score, fid_score, fake, caps, lens = self.evaluate(
                    eval_loader, use_ema=self.cfg.train.eval_use_ema)
            else:
                is_score, fid_score, fake, caps, lens = (
                    1.0, float("inf"), None, None, None)
            histories["is_scores"].append(is_score)
            histories["fid_scores"].append(fid_score)
            if fake is not None:
                self._save_samples(fake, caps, lens, epoch)
            self.host_seconds["eval"] += time.perf_counter() - t_eval

            # The reference saves every epoch (`model.py:300-312`); with
            # checkpoint_every_epochs = k only every k-th and the final
            # epoch (a crash replays at most k-1 epochs; resume stays
            # bit-exact). Numbered-checkpoint epochs save regardless.
            t_ckpt = time.perf_counter()
            every = self.cfg.train.checkpoint_every_epochs
            if ((epoch + 1) % every == 0 or epoch == num_epochs - 1
                    or (epoch + 1) % self.ckpt.numbered_every == 0):
                self.ckpt.save(epoch, self.state, histories, config=self.cfg)
            self.host_seconds["checkpoint"] += time.perf_counter() - t_ckpt

            dt = time.time() - t0
            self._flush_step_rows(epoch)
            if not self.primary:
                continue
            self.metrics_log.log(
                int(self.state.step), epoch=epoch, epoch_seconds=dt,
                g_loss=histories["g_losses"][-1],
                d_loss=histories["d_losses"][-1],
                d_gp_loss=histories["d_gp_losses"][-1],
                txtimg_loss=histories["txtimg_losses"][-1],
                is_score=is_score, fid_score=fid_score)
            print(f"Epoch {epoch + 1}: "
                  f"G Loss: {histories['g_losses'][-1]:.4f}, "
                  f"D Loss: {histories['d_losses'][-1]:.4f}, "
                  f"D GP Loss: {histories['d_gp_losses'][-1]:.4f}, "
                  f"Text-Image Loss: {histories['txtimg_losses'][-1]:.4f}, "
                  f"IS: {is_score:.4f}, FID: {fid_score:.4f} "
                  f"[{dt:.1f}s]")

        return histories
