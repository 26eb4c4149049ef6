"""Synthetic CUB-format fixture generator for tests and smoke runs (the
port of `gan_codes_tpu/data/synthetic.py`; the same seed writes the same
files).

Writes a directory with the exact on-disk layout the reference consumes
(`src/objects/dataset.py:16-96`): captions.pickle, per-split
filenames.pickle, bounding_boxes.txt, images.txt, and JPEG images under
birds/. Used by the data and trainer tests and the smoke run on the card.
"""
from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np
from PIL import Image

VOCAB = ["<pad>", "<unk>", "this", "bird", "has", "a", "red", "blue", "yellow",
         "small", "large", "beak", "wing", "tail", "crown", "white", "black",
         "spotted", "striped", "bright"]


def make_synthetic_cub(root: str, n_train: int = 8, n_test: int = 4,
                       image_size: int = 64, embeddings_num: int = 10,
                       seed: int = 0) -> dict:
    """Create a tiny CUB-format dataset; returns info dict."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "birds", "001.Synthetic"), exist_ok=True)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    os.makedirs(os.path.join(root, "test"), exist_ok=True)

    word2code = {w: i for i, w in enumerate(VOCAB)}
    code2word = {i: w for i, w in enumerate(VOCAB)}

    n_total = n_train + n_test
    names: List[str] = []
    bbox_lines, image_lines = [], []
    for i in range(n_total):
        name = f"001.Synthetic/img_{i:04d}"
        names.append(name)
        h = int(rng.integers(image_size, image_size * 2))
        w = int(rng.integers(image_size, image_size * 2))
        arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(root, "birds", f"{name}.jpg"))
        bw = int(rng.integers(image_size // 2, w))
        bh = int(rng.integers(image_size // 2, h))
        bx = int(rng.integers(0, max(1, w - bw)))
        by = int(rng.integers(0, max(1, h - bh)))
        image_lines.append(f"{i + 1} {name}.jpg")
        bbox_lines.append(f"{i + 1} {bx} {by} {bw} {bh}")

    with open(os.path.join(root, "images.txt"), "w") as f:
        f.write("\n".join(image_lines) + "\n")
    with open(os.path.join(root, "bounding_boxes.txt"), "w") as f:
        f.write("\n".join(bbox_lines) + "\n")

    def make_captions(n_images: int) -> List[List[int]]:
        caps = []
        for _ in range(n_images * embeddings_num):
            length = int(rng.integers(3, 24))  # some exceed max_len=18
            caps.append(rng.integers(2, len(VOCAB), size=length).tolist())
        return caps

    train_captions = make_captions(n_train)
    test_captions = make_captions(n_test)
    with open(os.path.join(root, "captions.pickle"), "wb") as f:
        pickle.dump((train_captions, test_captions, code2word, word2code), f)
    with open(os.path.join(root, "train", "filenames.pickle"), "wb") as f:
        pickle.dump(names[:n_train], f)
    with open(os.path.join(root, "test", "filenames.pickle"), "wb") as f:
        pickle.dump(names[n_train:], f)

    return {"n_words": len(VOCAB), "n_train": n_train, "n_test": n_test,
            "root": root}
