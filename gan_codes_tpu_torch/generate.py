"""Prompt -> image generation (the port of `gan_codes_tpu/generate.py`).

Reference `src/test_generate.py:12-84`: tokenize a free-text prompt
(lowercase, strip '.'/',', OOV -> <unk> -> 0, pad to 18), encode it with the
frozen text encoder, generate one image from fresh noise.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import GANConfig
from .models.generator import Generator
from .models.text_encoder import RNNEncoder
from .utils.device import serving_device


def preprocess_caption(caption: str, word2code: Dict[str, int],
                       max_len: int = 18) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize + encode a prompt (reference `test_generate.py:12-19`).

    A prompt with no words encodes as one padding token (length 1)."""
    tokens = caption.lower().replace(".", "").replace(",", "").split()
    encoded = [word2code.get(w, word2code.get("<unk>", 0))
               for w in tokens][:max_len]
    cap_len = max(1, len(encoded))
    arr = np.zeros((1, max_len), dtype=np.int32)
    arr[0, :len(encoded)] = encoded
    return arr, np.asarray([cap_len], dtype=np.int32)


def load_vocab(data_dir: str) -> Tuple[Dict[int, str], Dict[str, int]]:
    """code2word/word2code from captions.pickle, a 4-tuple (train captions,
    test captions, code2word, word2code) (reference
    `test_generate.py:30-32`). The file is the dataset's own; unpickle only
    a trusted one."""
    with open(os.path.join(data_dir, "captions.pickle"), "rb") as f:
        _, _, code2word, word2code = pickle.load(f)
    return code2word, word2code


@torch.inference_mode()
def generate_from_prompt(prompt: str, generator: Generator,
                         text_encoder: RNNEncoder, cfg: GANConfig,
                         word2code: Dict[str, int],
                         rng: Optional[torch.Generator] = None,
                         device: str | torch.device = "cuda") -> np.ndarray:
    """One [-1, 1] HWC float32 image for the prompt.

    Runs on `device` (CUDA unless the caller asks for the CPU; raises
    without a card); the modules must already live there. `rng` is a
    torch.Generator on that device (seed 0 when None)."""
    dev = serving_device(device)
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    captions, cap_lens = preprocess_caption(prompt, word2code,
                                            cfg.text_encoder.max_len)
    sents = text_encoder(torch.from_numpy(captions).to(dev),
                         torch.from_numpy(cap_lens))
    dt = generator.linear_in.weight.dtype
    noise = torch.randn((1, cfg.generator.latent_dim), generator=rng,
                        device=dev).to(dt)
    img = generator(noise, sents)
    return img[0].float().cpu().numpy()
