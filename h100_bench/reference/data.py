"""CUB-200-2011's training pipeline, plain numpy and PIL: which images
and captions make each batch of an epoch, and how each is decoded.

The same rules as the reference repository's `src/objects/dataset.py`
(bbox crop of radius 0.75 x max(w, h), shorter side to 256 x 76/64,
bilinear, a random 256 crop and a random horizontal flip, one of the ten
captions, kept whole up to 18 words, else 18 of them at random in their
order) and the order of the port's loader, which it documents: epoch e
draws its permutation and one seed per item from numpy's
`default_rng([seed, e])`, and each item draws its crop, flip and caption
from `default_rng(item seed)`, in that order. Read from the tree's raw
files, so the batch is worked out again, not taken from the program.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image


class CubReference:
    def __init__(self, root: str, image_size: int, batch_size: int,
                 seed: int, captions_per_image: int = 10,
                 max_len: int = 18, resize_ratio: float = 76.0 / 64.0,
                 radius: float = 0.75):
        self.root, self.size, self.batch_size = root, image_size, batch_size
        self.seed, self.per_image, self.max_len = seed, captions_per_image, \
            max_len
        self.resized = int(image_size * resize_ratio)
        self.radius = radius
        with open(os.path.join(root, "captions.pickle"), "rb") as f:
            self.captions = pickle.load(f)[0]
        with open(os.path.join(root, "train", "filenames.pickle"), "rb") as f:
            self.names: List[str] = pickle.load(f)
        boxes = np.loadtxt(os.path.join(root, "bounding_boxes.txt"),
                           dtype=np.float64, ndmin=2)[:, 1:].astype(np.int64)
        with open(os.path.join(root, "images.txt")) as f:
            files = [ln.split()[1] for ln in f if len(ln.split()) >= 2]
        self.bbox: Dict[str, np.ndarray] = {
            fn[:-len(".jpg")]: boxes[i] for i, fn in enumerate(files)}

    def epoch_batches(self, epoch: int) -> List[Tuple[np.ndarray,
                                                      np.ndarray]]:
        """Each batch's (item indices, item seeds) of an epoch, whole
        batches only."""
        g = np.random.default_rng([self.seed, epoch])
        n = len(self.names)
        order = g.permutation(n)
        order = order[:(n // self.batch_size) * self.batch_size]
        idx = [order[i:i + self.batch_size]
               for i in range(0, len(order), self.batch_size)]
        return [(b, g.integers(0, 2**63 - 1, size=len(b))) for b in idx]

    def _image(self, name: str, g: np.random.Generator) -> np.ndarray:
        img = Image.open(os.path.join(self.root, "birds", f"{name}.jpg"))
        img = img.convert("RGB")
        if name in self.bbox:
            x, y, w, h = (int(v) for v in self.bbox[name])
            r = int(max(w, h) * self.radius)
            cx, cy = int((2 * x + w) / 2), int((2 * y + h) / 2)
            img = img.crop((max(0, cx - r), max(0, cy - r),
                            min(img.size[0], cx + r),
                            min(img.size[1], cy + r)))
        w, h = img.size
        scale = self.resized / min(w, h)
        img = img.resize((max(1, round(w * scale)), max(1, round(h * scale))),
                         Image.BILINEAR)
        a = np.asarray(img, dtype=np.uint8)
        s = self.size
        top = int(g.integers(0, a.shape[0] - s + 1)) if a.shape[0] > s else 0
        left = int(g.integers(0, a.shape[1] - s + 1)) if a.shape[1] > s else 0
        a = a[top:top + s, left:left + s]
        if a.shape[:2] != (s, s):
            a = np.pad(a, ((0, s - a.shape[0]), (0, s - a.shape[1]), (0, 0)))
        if g.random() < 0.5:
            a = a[:, ::-1]
        return np.ascontiguousarray(a)

    def _caption(self, idx: int, g: np.random.Generator
                 ) -> Tuple[np.ndarray, int]:
        shift = int(g.integers(0, self.per_image))
        cap = np.asarray(self.captions[idx * self.per_image + shift],
                         np.int64)
        out = np.zeros((self.max_len,), np.int64)
        if len(cap) <= self.max_len:
            out[:len(cap)] = cap
            return out, max(len(cap), 1)
        out[:] = cap[np.sort(g.permutation(len(cap))[:self.max_len])]
        return out, self.max_len

    def batch(self, epoch: int, index: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch `index` of `epoch`: images uint8 [B, H, W, 3], captions
        [B, 18], lengths [B]."""
        items, seeds = self.epoch_batches(epoch)[index]
        imgs, caps, lens = [], [], []
        for i, s in zip(items.tolist(), seeds.tolist()):
            g = np.random.default_rng(s)
            imgs.append(self._image(self.names[i], g))
            c, n = self._caption(i, g)
            caps.append(c)
            lens.append(n)
        return np.stack(imgs), np.stack(caps), np.asarray(lens, np.int64)
