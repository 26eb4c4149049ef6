"""What the drivers share: the port's configuration and precision from a
benchmark configuration, the device's peak memory, and freeing the
program's state before the reference runs."""
from __future__ import annotations

import gc

import torch

PRECISION = {"float32": "highest", "tf32": "high"}


def port_config(cfg: dict):
    """The port's `GANConfig` for a benchmark configuration."""
    from gan_codes_tpu_torch.config import (DataConfig, DiscriminatorConfig,
                                            GANConfig, GeneratorConfig,
                                            LossConfig, OptimConfig,
                                            TextEncoderConfig, TrainConfig)

    g, d, t = cfg["generator"], cfg["discriminator"], cfg["text_encoder"]
    return GANConfig(
        generator=GeneratorConfig(**g),
        discriminator=DiscriminatorConfig(
            n_channels=d["n_channels"], sentence_dim=g["sentence_dim"],
            image_size=g["image_size"], final_size=d["final_size"]),
        text_encoder=TextEncoderConfig(**t),
        optim=OptimConfig(**cfg["optim"]), loss=LossConfig(**cfg["loss"]),
        train=TrainConfig(**cfg["train"]),
        data=DataConfig(image_size=g["image_size"],
                        max_caption_len=t["max_len"]))


def set_precision(cfg: dict) -> None:
    """The process's fp32 product precision, through the port's own
    switch (`--matmul-precision`)."""
    from gan_codes_tpu_torch.utils.device import set_matmul_precision

    set_matmul_precision(PRECISION[cfg["precision"]])


def reference_precision() -> None:
    """fp32 with TF32 off, for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def memory_peak(device: str) -> int:
    return torch.cuda.max_memory_allocated() if device.startswith("cuda") \
        else 0


def free(device: str) -> None:
    """Collect what the program left (torch's Adam sits in a reference
    cycle) and return the cache, before the reference runs."""
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
