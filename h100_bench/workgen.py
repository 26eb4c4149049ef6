"""The general traffic generator: every input a cell sends, drawn from
`--seed` and the parameters of its traffic mix (`traffic/<mix>.json`).

Seeds: a run's seed may be any whole number; each stream of inputs takes
its own numpy `SeedSequence` of (seed, stream name), so the streams are
independent and repeat for a seed. The same seed gives the same captions,
prompts, arrival times and CUB tree, whatever the host.

Captions follow CUB-200-2011's shape (10 per image, about 15 words on
average, a 5,450-word vocabulary, at most 18 tokens kept); the words
themselves are drawn uniformly (assumed: no public word statistics are at
hand here).
"""
from __future__ import annotations

import os
import pickle
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

FIRST_WORD = 2          # ids 0 ("<end>", the padding) and 1 ("<unk>")


def rng(seed: int, stream: str) -> np.random.Generator:
    """The numpy generator of one named stream of a run."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2**64, zlib.crc32(stream.encode())]))


def torch_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for a `torch.Generator` of one named stream."""
    return int(rng(seed, stream).integers(0, 2**63 - 1))


def vocabulary(size: int) -> List[str]:
    """`size` distinct lowercase words; index 0 pads, 1 is unknown."""
    return ["<end>", "<unk>"] + [f"w{i}" for i in range(FIRST_WORD, size)]


def caption_lengths(g: np.random.Generator, n: int, words: dict
                    ) -> np.ndarray:
    """Word counts of `n` captions: a normal of the mix's mean and sd,
    rounded and clipped to [min, max]."""
    x = np.rint(g.normal(words["mean"], words["sd"], n))
    return np.clip(x, words["min"], words["max"]).astype(np.int64)


def captions(g: np.random.Generator, n: int, vocab_size: int, words: dict
             ) -> List[List[int]]:
    """`n` captions of word ids, full length (a dataset keeps 18)."""
    lens = caption_lengths(g, n, words)
    ids = g.integers(FIRST_WORD, vocab_size, int(lens.sum()))
    return [c.tolist() for c in np.split(ids, np.cumsum(lens)[:-1])]


def token_batch(g: np.random.Generator, n: int, vocab_size: int,
                max_len: int, words: dict) -> Tuple[np.ndarray, np.ndarray]:
    """`n` captions as the model takes them: ids [n, max_len] (0 pads)
    and lengths [n], each caption cut to its first `max_len` words."""
    caps = np.zeros((n, max_len), np.int64)
    lens = np.zeros((n,), np.int64)
    for i, c in enumerate(captions(g, n, vocab_size, words)):
        c = c[:max_len]
        caps[i, :len(c)] = c
        lens[i] = len(c)
    return caps, lens


def prompts(tokens: np.ndarray, lens: np.ndarray, vocab: List[str]
            ) -> List[str]:
    """Free-text prompts whose words are the given ids."""
    return [" ".join(vocab[t] for t in row[:n]) for row, n in
            zip(tokens, lens)]


def poisson_arrivals(g: np.random.Generator, rate: float, seconds: float
                     ) -> np.ndarray:
    """Arrival times in [0, seconds) of a Poisson process of `rate` per
    second."""
    n = int(rate * seconds * 1.5 + 50)
    t = np.cumsum(g.exponential(1.0 / rate, n))
    while t[-1] < seconds:  # rare: draw on
        t = np.concatenate([t, t[-1] + np.cumsum(
            g.exponential(1.0 / rate, n))])
    return t[t < seconds]


def write_cub_tree(root: str, seed: int, mix: dict, vocab_size: int
                   ) -> Dict[str, int]:
    """A CUB-200-2011-layout tree under `root` (after the port's
    `data/synthetic.py`): `birds/<name>.jpg`, `images.txt`,
    `bounding_boxes.txt`, `captions.pickle` and each split's
    `filenames.pickle`. `mix["images"]` train images at CUB's sizes
    (`width`, `height` ranges), smooth random content with a bounding box
    of `bbox_share` of each side, `captions_per_image` captions each. The
    test split is empty. The same seed writes the same bytes."""
    g = rng(seed, "cub_tree")
    n = int(mix["images"])
    os.makedirs(os.path.join(root, "birds", "001.Bench"), exist_ok=True)
    for split in ("train", "test"):
        os.makedirs(os.path.join(root, split), exist_ok=True)
    names = [f"001.Bench/img_{i:05d}" for i in range(n)]
    w_lo, w_hi = mix["width"]
    h_lo, h_hi = mix["height"]
    b_lo, b_hi = mix["bbox_share"]
    widths = g.integers(w_lo, w_hi + 1, n)
    heights = g.integers(h_lo, h_hi + 1, n)
    coarse = [g.integers(0, 256, (max(2, h // 8), max(2, w // 8), 3),
                         dtype=np.uint8) for w, h in zip(widths, heights)]
    bw = (widths * g.uniform(b_lo, b_hi, n)).astype(np.int64)
    bh = (heights * g.uniform(b_lo, b_hi, n)).astype(np.int64)
    bx = (g.uniform(0, 1, n) * (widths - bw)).astype(np.int64)
    by = (g.uniform(0, 1, n) * (heights - bh)).astype(np.int64)

    def write(i: int) -> None:
        from PIL import Image

        img = Image.fromarray(coarse[i]).resize(
            (int(widths[i]), int(heights[i])), Image.BICUBIC)
        img.save(os.path.join(root, "birds", f"{names[i]}.jpg"),
                 quality=int(mix["jpeg_quality"]))

    with ThreadPoolExecutor(int(mix.get("writer_threads", 8))) as pool:
        list(pool.map(write, range(n)))
    with open(os.path.join(root, "images.txt"), "w") as f:
        f.writelines(f"{i + 1} {nm}.jpg\n" for i, nm in enumerate(names))
    with open(os.path.join(root, "bounding_boxes.txt"), "w") as f:
        f.writelines(f"{i + 1} {bx[i]} {by[i]} {bw[i]} {bh[i]}\n"
                     for i in range(n))
    vocab = vocabulary(vocab_size)
    caps = captions(g, n * int(mix["captions_per_image"]), vocab_size,
                    mix["caption_words"])
    with open(os.path.join(root, "captions.pickle"), "wb") as f:
        pickle.dump((caps, [], dict(enumerate(vocab)),
                     {w: i for i, w in enumerate(vocab)}), f)
    with open(os.path.join(root, "train", "filenames.pickle"), "wb") as f:
        pickle.dump(names, f)
    with open(os.path.join(root, "test", "filenames.pickle"), "wb") as f:
        pickle.dump([], f)
    return {"images": n, "captions": len(caps)}


def write_vocab(root: str, vocab_size: int) -> None:
    """A `captions.pickle` holding only the vocabulary (what a server
    reads)."""
    vocab = vocabulary(vocab_size)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "captions.pickle"), "wb") as f:
        pickle.dump(([], [], dict(enumerate(vocab)),
                     {w: i for i, w in enumerate(vocab)}), f)
