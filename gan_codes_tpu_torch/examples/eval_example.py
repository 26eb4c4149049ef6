"""Evaluation / sampling walkthrough (mirrors the reference's
eval_example.ipynb; the port's counterpart of `examples/eval_example.py`):
load a trained generator, sample a test batch to PNGs, and generate an
image from a free-text caption (`gen_own_bird` cell).

    python -m gan_codes_tpu_torch.examples.eval_example --data DATA_DIR \\
        --weights gen_weights --image-size 32 [--device cpu]

Runs on CUDA unless `--device cpu` is given, and raises without a card.
"""
import argparse
import os

import torch

from ..config import DataConfig, GANConfig
from ..data.dataset import CUBDataset
from ..data.loader import DataLoader
from ..generate import generate_from_prompt, load_vocab
from ..models.text_encoder import RNNEncoder
from ..models.torch_import import (latest_generator_weights, load_generator,
                                   load_text_encoder)
from ..sample import sample
from ..utils import image_io
from ..utils.device import serving_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--weights", required=True, help="gen_weights dir")
    p.add_argument("--text-encoder", default=None)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--out", default="eval_out")
    p.add_argument("--caption",
                   default="this bird has a red beak and a white belly")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    a = p.parse_args(argv)
    dev = serving_device(a.device)

    code2word, word2code = load_vocab(a.data)
    cfg = GANConfig.for_image_size(a.image_size, vocab_size=len(code2word))

    if a.text_encoder and os.path.exists(a.text_encoder):
        text_encoder, _ = load_text_encoder(a.text_encoder, cfg.text_encoder)
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            text_encoder = RNNEncoder(cfg.text_encoder)
    text_encoder = text_encoder.to(dev).eval()

    path, epoch = latest_generator_weights(a.weights)
    generator, _ = load_generator(path, cfg.generator)
    generator = generator.to(dev)
    print(f"Loaded generator from epoch {epoch}")

    # batch sampling on the test split (reference eval cell 6)
    ds = CUBDataset(DataConfig(data_dir=a.data, image_size=a.image_size),
                    "test", augment=False)
    batch = next(iter(DataLoader(ds, min(8, len(ds)), shuffle=False)))
    paths = sample(generator, text_encoder, cfg, batch,
                   os.path.join(a.out, "batch"), device=dev)
    print(f"Wrote {len(paths)} sampled images")

    # free-text generation (reference gen_own_bird cell 9)
    img = generate_from_prompt(a.caption, generator, text_encoder, cfg,
                               word2code, device=dev)
    path = image_io.save_image(img, a.out, "own_bird")
    print(f"Wrote {path}")


if __name__ == "__main__":
    main()
