"""Checkpoint / resume with `torch.save` (the port of
`gan_codes_tpu/train/checkpoint.py`).

The reference's checkpoint contents (`src/deep_fusion_gan/model.py:298-327`)
plus what the JAX package adds so that resume is bit-exact: the step, G, D,
the EMA G, both Adam states and the state of `TrainState.rng`. The layout
in the checkpoint directory follows the JAX package's:

  * `checkpoint`, the latest full training state (one `torch.save` file);
  * `checkpoint_epoch_{N}`, a copy every `numbered_every` epochs;
  * `gen_{N}.pth`, the generator's state_dict in the reference's format
    (`serve.build_sampler` serves it unchanged), and `gen_ema_{N}.pth`,
    the EMA generator's (the JAX `gen_N` tree holds both);
  * `histories.json`, the six metric histories and the last epoch: the
    resume commit point, written last;
  * `config.json`, the run's `GANConfig` (the JAX package reads it too).

Every file is written to a temporary name and renamed into place. Loading
uses `torch.load(weights_only=True)`.

Data parallelism (`mesh` given): rank 0 writes every file, then all ranks
wait at a barrier. Rank 0 decides whether there is a checkpoint and
whether the config matches, and broadcasts its verdict, so every rank
takes the same branch and a mismatch raises on every rank. `restore`
loads the directory on every rank, so it must be shared (as Orbax
requires in JAX), takes the epoch and histories from rank 0, and then
replicates rank 0's state.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel.dp import replicate
from ..parallel.mesh import Mesh, barrier, broadcast, broadcast_json
from ..utils.jsonio import restore_nonfinite, sanitize_nonfinite
from .state import TrainState

HISTORY_KEYS = ("g_losses", "d_losses", "d_gp_losses", "is_scores",
                "fid_scores", "txtimg_losses")

# Config fields that may legitimately differ between the run that wrote a
# checkpoint and the run resuming from it (extending training, moving the
# dataset, changing save cadence). Everything else changing silently would
# either fail to load or, worse, train with different semantics, so restore
# fails loudly on it. The same set as the JAX package's.
CONFIG_RESUME_MUTABLE = frozenset({
    "train.num_epochs",
    "train.checkpoint_every_epochs",
    "train.numbered_checkpoint_every",
    "train.eval_use_ema",
    "train.eval_max_batches",
    "train.eval_every_epochs",
    "train.eval_sqrtm",
    "data.data_dir",
    # Pure-performance knobs (exact math): the JAX package's TPU compile
    # and (below) train.device_prefetch, kept in the config and ignored by
    # the port, and one the port acts on without changing a result,
    # generator.remat_blocks.
    "train.xla_scoped_vmem_kib",
    "generator.remat_blocks",
    "generator.lane_pad",
    "generator.lane_pad_min_ch",
    "discriminator.lane_pad",
    "discriminator.lane_pad_min_ch",
    "generator.image_pad",
    "train.image_pad",
    "train.steps_per_dispatch",
    # Logging cadence only: what gets written to the metrics JSONL, not
    # what gets computed.
    "train.log_every_steps",
    "train.device_prefetch",
})


def empty_histories() -> Dict[str, List[float]]:
    return {k: [] for k in HISTORY_KEYS}


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def config_mismatches(saved: Dict[str, Any], current: Dict[str, Any]
                      ) -> List[str]:
    """Human-readable list of semantic config differences (allowlisted
    resume-mutable fields excluded)."""
    flat_saved, flat_cur = _flatten(saved), _flatten(current)
    lines = []
    for path in sorted(set(flat_saved) | set(flat_cur)):
        if path in CONFIG_RESUME_MUTABLE:
            continue
        a, b = flat_saved.get(path, "<absent>"), flat_cur.get(path, "<absent>")
        if a != b:
            lines.append(f"  {path}: checkpoint={a!r} current={b!r}")
    return lines


def _adam_state_dict(opt) -> Dict[str, Any]:
    """`opt`'s Adam state_dict as a run with host-side step counts saves
    it (`capturable` off, the counts on the CPU), whichever way this run
    counts them (`ClipAdam.set_capturable`): a checkpoint does not tell
    whether its steps ran as CUDA graphs."""
    sd = opt.adam.state_dict()
    sd["state"] = {i: dict(st, step=st["step"].cpu())
                   for i, st in sd["state"].items()}
    sd["param_groups"] = [dict(g, capturable=False)
                          for g in sd["param_groups"]]
    return sd


def state_to_dict(state: TrainState) -> Dict[str, Any]:
    """Everything `TrainState` holds, as one dict of tensors and plain
    values (what `checkpoint` files contain)."""
    return {"step": int(state.step),
            "generator": state.generator.state_dict(),
            "discriminator": state.discriminator.state_dict(),
            "g_ema": state.g_ema.state_dict(),
            "g_opt": _adam_state_dict(state.g_opt),
            "d_opt": _adam_state_dict(state.d_opt),
            "rng": state.rng.get_state()}


def load_state_dict(state: TrainState, blob: Dict[str, Any]) -> None:
    """Load a `state_to_dict` dict into `state`, in place. An int "rng" is
    a seed (what the importers of `models/torch_import.py` write, whose
    stream could not be carried): the step's generator restarts from it
    on whichever device resumes the run. Adam counts its steps on the
    host after the load, whatever the blob's groups say
    (`ClipAdam.set_capturable`; the step's CUDA graphs count them on the
    card again when they next capture)."""
    state.generator.load_state_dict(blob["generator"])
    state.discriminator.load_state_dict(blob["discriminator"])
    state.g_ema.load_state_dict(blob["g_ema"])
    for opt, key in ((state.g_opt, "g_opt"), (state.d_opt, "d_opt")):
        opt.adam.load_state_dict(blob[key])
        opt.set_capturable(False)
    if isinstance(blob["rng"], int):
        state.rng.manual_seed(blob["rng"])
    else:
        state.rng.set_state(blob["rng"].cpu())
    state.step = int(blob["step"])


class CheckpointManager:
    """Latest + numbered checkpoints + generator-only weights."""

    def __init__(self, directory: str, numbered_every: int = 10,
                 mesh: Optional[Mesh] = None):
        self.directory = os.path.abspath(directory)
        self.numbered_every = numbered_every
        self.mesh = mesh
        self.primary = mesh is None or mesh.primary
        if self.primary:
            os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _save(self, name: str, obj: Any) -> None:
        """torch.save to a temporary name, then rename into place: a crash
        mid-write leaves the previous file."""
        tmp = self._path(name + ".tmp")
        torch.save(obj, tmp)
        os.replace(tmp, self._path(name))

    # -- full training checkpoints ------------------------------------------

    def save(self, epoch: int, state: TrainState,
             histories: Dict[str, List[float]],
             config: Any = None) -> None:
        if self.primary:
            self.write(epoch, state_to_dict(state), histories, config)
        barrier(self.mesh)

    def write(self, epoch: int, blob: Dict[str, Any],
              histories: Dict[str, List[float]], config: Any = None) -> None:
        """The files of `save` from a `state_to_dict` dict, written by
        this process alone (rank 0's part of `save`, and the importers')."""
        self._save("checkpoint", blob)
        if (epoch + 1) % self.numbered_every == 0:
            self._save(f"checkpoint_epoch_{epoch}", blob)
        self.save_generator(epoch, blob["generator"], blob["g_ema"])
        # histories.json is the resume commit point (it names the epoch
        # restore() returns), so it lands only after the state files are
        # complete: a crash before it leaves the previous epoch's
        # histories and resume replays the epoch (never skips one).
        self._write_json("histories.json", {"epoch": epoch, **histories})
        if config is not None:
            self.save_config(config)

    def save_config(self, config: Any) -> None:
        """Persist the run's GANConfig as config.json (atomic write) so
        inference entry points can rebuild the exact model later."""
        self._write_json("config.json", dataclasses.asdict(config))

    def save_generator(self, epoch: int, generator: Dict[str, Any],
                       g_ema: Dict[str, Any]) -> None:
        """Generator-only weights for inference (`model.py:321-327`): the
        state_dicts `generator` as `gen_{epoch}.pth`, in the reference's
        format, and `g_ema` as `gen_ema_{epoch}.pth`."""
        self._save(f"gen_{epoch}.pth", generator)
        self._save(f"gen_ema_{epoch}.pth", g_ema)

    def _write_json(self, name: str, obj: Any) -> None:
        """Atomic JSON write; non-finite floats (the FID inf sentinel) are
        stringified, since bare `Infinity` tokens are invalid JSON."""
        tmp = self._path(name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(sanitize_nonfinite(obj), f, allow_nan=False)
        os.replace(tmp, self._path(name))

    def has_checkpoint(self) -> bool:
        """Whether there is a checkpoint to resume; rank 0's view under
        data parallelism (broadcast)."""
        local = self.primary and os.path.exists(self._path("checkpoint")) \
            and os.path.exists(self._path("histories.json"))
        if self.mesh is None or not self.mesh.distributed:
            return local
        flag = torch.tensor([int(local)], dtype=torch.int64,
                            device=self.mesh.device)
        return bool(broadcast(self.mesh, flag).item())

    def load_config(self):
        """The `GANConfig` (or `GALIPConfig`) this checkpoint was trained
        with, or None when the directory has no config.json."""
        path = self._path("config.json")
        if not os.path.exists(path):
            return None
        from ..config import config_from_dict

        with open(path) as f:
            return config_from_dict(json.load(f))

    def verify_config(self, config: Any) -> None:
        """Fail loudly if `config` differs semantically from the config the
        checkpoint was written with (resume-mutable fields excluded). No-op
        when the directory has no config.json."""
        if config is None:
            return
        lines = None
        if self.primary:
            saved = self.load_config()
            # Round-trip through GANConfig so fields added after the
            # checkpoint was written take their default instead of reading
            # as "<absent>".
            lines = [] if saved is None else config_mismatches(
                dataclasses.asdict(saved), dataclasses.asdict(config))
        lines = broadcast_json(self.mesh, lines)  # rank 0's verdict
        if lines:
            raise ValueError(
                "Config mismatch between the checkpoint in "
                f"{self.directory} and the current run:\n" + "\n".join(lines)
                + "\nRebuild the run with the checkpoint's config (or use a "
                "fresh checkpoint directory).")

    def restore(self, state: TrainState
                ) -> Tuple[TrainState, int, Dict[str, List[float]]]:
        """Load the latest checkpoint into `state` (in place) and return
        (state, last completed epoch, histories); under data parallelism
        every rank loads it, then takes rank 0's state and histories."""
        blob = torch.load(self._path("checkpoint"), map_location="cpu",
                          weights_only=True)
        load_state_dict(state, blob)
        hist = None
        if self.primary:
            with open(self._path("histories.json")) as f:
                hist = restore_nonfinite(json.load(f))
        hist = broadcast_json(self.mesh, hist)
        if self.mesh is not None:
            replicate(self.mesh, state)
        epoch = int(hist.pop("epoch"))
        histories = {k: list(hist.get(k, [])) for k in HISTORY_KEYS}
        return state, epoch, histories
