"""Typed configuration, field for field the JAX package's.

The seven dataclasses carry the same fields, defaults and derived
properties as `gan_codes_tpu/config.py`, so `GANConfig.from_dict` reads the
`config.json` that the JAX package's checkpoints write, and
`dataclasses.asdict` gives the same dictionary.

Some fields only steer the JAX package's TPU compilation: `use_pallas`,
`fuse_upsample`, `lane_pad`, `lane_pad_min_ch` and `image_pad` of the
generator, `lane_pad`/`lane_pad_min_ch` of the discriminator,
`xla_scoped_vmem_kib`, `image_pad` and `steps_per_dispatch` of training.
They are exact-math by the JAX package's own contract, so none of them
changes a result; the port parses and keeps them so that a config
round-trips, and its own path ignores them (it always runs its kernels on
CUDA). So does training's `device_prefetch`: the port's trainer always
uploads the next batch while a step runs (`train/trainer.py`). One
exact-math field does act here: the generator's `remat_blocks` recomputes
each block in the backward (`models/generator.py`; less activation
memory, a longer step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


def _log2_int(x: int) -> int:
    l = int(math.log2(x))
    if 2**l != x:
        raise ValueError(f"expected a power of two, got {x}")
    return l


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """One-stage text-to-image generator (reference
    `src/generator/model.py:8-46`); the spatial ladder follows `image_size`."""

    n_channels: int = 32
    latent_dim: int = 100
    sentence_dim: int = 256
    affine_hidden: int = 256
    image_size: int = 256
    base_size: int = 4
    use_pallas: bool = False
    fuse_upsample: bool = True
    remat_blocks: bool = False
    lane_pad: int = 0
    lane_pad_min_ch: int = 0
    image_pad: int = 0

    @property
    def n_up_blocks(self) -> int:
        return _log2_int(self.image_size) - _log2_int(self.base_size)

    @property
    def block_channels(self) -> Tuple[Tuple[int, int], ...]:
        """(in, out) channels per upsampling block + the final non-up block
        (ladder 256,256,256,256 -> 128 -> 64 -> (out) 32 at n_channels=32)."""
        nc = self.n_channels
        n_up = self.n_up_blocks
        if n_up < 2:
            raise ValueError("image_size must be at least 4x base_size")
        ladder = [(8 * nc, 8 * nc)] * (n_up - 2) + [(8 * nc, 4 * nc),
                                                     (4 * nc, 2 * nc)]
        ladder.append((2 * nc, nc))
        return tuple(ladder)

    @property
    def seed_channels(self) -> int:
        return 8 * self.n_channels


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """Matching-aware discriminator (reference
    `src/discriminator/model.py:8-58`)."""

    n_channels: int = 32
    sentence_dim: int = 256
    image_size: int = 256
    final_size: int = 4
    lane_pad: int = 0
    lane_pad_min_ch: int = 0

    @property
    def n_down_blocks(self) -> int:
        return _log2_int(self.image_size) - _log2_int(self.final_size)

    @property
    def block_channels(self) -> Tuple[Tuple[int, int], ...]:
        nc = self.n_channels
        mults = [1, 2, 4, 8, 16, 16, 16]
        n = self.n_down_blocks
        if n + 1 > len(mults):
            raise ValueError(f"image_size {self.image_size} too large")
        return tuple((mults[i] * nc, mults[i + 1] * nc) for i in range(n))

    @property
    def embed_channels(self) -> int:
        return self.block_channels[-1][1]


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    """Frozen DAMSM-style biLSTM encoder (reference
    `src/text_encoder/model.py:6-31`)."""

    vocab_size: int = 5450
    embed_dim: int = 300
    hidden_dim: int = 256  # total across directions
    max_len: int = 18
    dropout: float = 0.5
    bidirectional: bool = True

    @property
    def per_direction_hidden(self) -> int:
        return self.hidden_dim // (2 if self.bidirectional else 1)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """TTUR Adam + global-norm clip (reference `model.py:42-53`)."""

    g_lr: float = 1e-4
    d_lr: float = 4e-4
    beta1: float = 0.0
    beta2: float = 0.9
    eps: float = 1e-8
    grad_clip_g: float = 5.0
    grad_clip_d: float = 5.0


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Hinge + MA-GP knobs (reference `model.py:77-85,173-231`)."""

    gp_coef: float = 2.0
    gp_power: int = 6
    gp_norm_clip: float = 10.0
    gp_eps: float = 1e-8
    damsm_weight: float = 0.0
    nan_guard: bool = True
    gp_compute_dtype: str = "float32"
    gp_interval: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop knobs (reference `src/train.py:20-57`)."""

    batch_size: int = 24
    num_epochs: int = 600
    seed: int = 123321
    eval_max_batches: int = 32
    eval_every_epochs: int = 1
    eval_sqrtm: str = "scipy"
    checkpoint_every_epochs: int = 1
    numbered_checkpoint_every: int = 10
    ema_decay: float = 0.999
    eval_use_ema: bool = False
    compute_dtype: str = "float32"
    data_axis: str = "data"
    xla_scoped_vmem_kib: Optional[int] = None
    image_pad: int = 0
    steps_per_dispatch: int = 1
    device_prefetch: bool = False
    log_every_steps: int = 0

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """CUB pipeline knobs (reference `src/objects/dataset.py`)."""

    data_dir: str = "data"
    image_size: int = 256
    embeddings_num: int = 10
    max_caption_len: int = 18
    resize_ratio: float = 76.0 / 64.0
    bbox_radius_factor: float = 0.75


@dataclasses.dataclass(frozen=True)
class GANConfig:
    """Top-level config bundling every subsystem."""

    generator: GeneratorConfig = dataclasses.field(
        default_factory=GeneratorConfig)
    discriminator: DiscriminatorConfig = dataclasses.field(
        default_factory=DiscriminatorConfig)
    text_encoder: TextEncoderConfig = dataclasses.field(
        default_factory=TextEncoderConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)

    @staticmethod
    def from_dict(d: dict) -> "GANConfig":
        """Inverse of `dataclasses.asdict`; unknown keys are ignored and
        missing keys take the field default."""
        def build(cls, sub: Optional[dict]):
            known = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in (sub or {}).items() if k in known})

        return GANConfig(
            generator=build(GeneratorConfig, d.get("generator")),
            discriminator=build(DiscriminatorConfig, d.get("discriminator")),
            text_encoder=build(TextEncoderConfig, d.get("text_encoder")),
            optim=build(OptimConfig, d.get("optim")),
            loss=build(LossConfig, d.get("loss")),
            train=build(TrainConfig, d.get("train")),
            data=build(DataConfig, d.get("data")),
        )

    @staticmethod
    def for_image_size(image_size: int, n_channels: int = 32,
                       vocab_size: int = 5450,
                       loss_overrides: Optional[dict] = None,
                       generator_overrides: Optional[dict] = None,
                       discriminator_overrides: Optional[dict] = None,
                       **train_overrides) -> "GANConfig":
        return GANConfig(
            generator=GeneratorConfig(n_channels=n_channels,
                                      image_size=image_size,
                                      **(generator_overrides or {})),
            discriminator=DiscriminatorConfig(
                n_channels=n_channels, image_size=image_size,
                **(discriminator_overrides or {})),
            text_encoder=TextEncoderConfig(vocab_size=vocab_size),
            loss=LossConfig(**loss_overrides) if loss_overrides
            else LossConfig(),
            train=TrainConfig(**train_overrides) if train_overrides
            else TrainConfig(),
            data=DataConfig(image_size=image_size),
        )
