"""Batch inference: encode captions, generate, save PNGs (the port of
`gan_codes_tpu/sample.py`).

Capability parity with `src/sample.py:13-43`: fresh Gaussian noise per
call from an explicit `torch.Generator`, denormalize (x+1)*127.5 -> uint8
HWC PNG named after the dataset file name.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .config import GANConfig
from .models.generator import Generator
from .models.text_encoder import RNNEncoder
from .utils import image_io
from .utils.device import serving_device


def generate_images(generator: Generator, cfg: GANConfig,
                    sentence_embeds: torch.Tensor,
                    generator_rng: torch.Generator) -> torch.Tensor:
    """Fresh noise from `generator_rng` (on the embeddings' device) -> G
    forward (reference `sample.py:13-18`); the noise takes G's dtype."""
    noise = torch.randn((sentence_embeds.shape[0], cfg.generator.latent_dim),
                        generator=generator_rng,
                        device=sentence_embeds.device)
    return generator(noise.to(generator.linear_in.weight.dtype),
                     sentence_embeds)


@torch.inference_mode()
def sample(generator: Generator, text_encoder: RNNEncoder, cfg: GANConfig,
           batch, save_dir: str, rng: Optional[torch.Generator] = None,
           device: str | torch.device = "cuda") -> List[str]:
    """Generate one image per batch item and save PNGs (reference
    `sample.py:31-43`). `batch` is a loader batch (its images are ignored;
    captions, cap_lens and file_names are used). Runs on `device` (CUDA
    unless the caller asks for the CPU; raises without a card), where the
    modules must already live; `rng` is a torch.Generator there (seed 0
    when None)."""
    dev = serving_device(device)
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    sents = text_encoder(
        torch.as_tensor(np.asarray(batch["captions"], np.int64)).to(dev),
        torch.as_tensor(np.asarray(batch["cap_lens"], np.int64)))
    fakes = generate_images(generator, cfg, sents, rng).float().cpu().numpy()
    return [image_io.save_image(fakes[i], save_dir, name)
            for i, name in enumerate(batch["file_names"])]
