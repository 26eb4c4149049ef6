"""CUB-200-2011 caption/bbox dataset, format-compatible with the reference
(the port of `gan_codes_tpu/data/dataset.py`, numpy and PIL only, reading
the port's own `config.DataConfig`).

Capability parity with DFGANDataset (`src/objects/dataset.py:15-144`):
  * `captions.pickle` = (train_captions, test_captions, code2word, word2code)
  * per-split `<split>/filenames.pickle`
  * `bounding_boxes.txt` + `images.txt` (whitespace-separated, same columns)
  * per item: bbox-centered crop with radius r = 0.75 * max(bw, bh) clamped to
    the image, resize-shorter-side to imsize*76/64 -> random crop -> random
    horizontal flip, a random 1-of-10 caption padded/truncated to 18 tokens
    (random *sorted* subsample when longer); with a `CLIPDataConfig`
    (GALIP) CLIP's framing instead, to 77 tokens (`frame_clip`).

Differences from the reference, as in the JAX package:
  * images come out as uint8 HWC; the trainer normalizes them to [-1, 1]
    on the device (4x less host->device traffic than fp32 NCHW);
  * no per-batch length sorting (the packed LSTM takes unsorted batches);
  * the pipeline is a plain-Python iterable with background prefetch
    (`loader.py`), not a torch DataLoader.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from ..config import EOT_TOKEN, SOT_TOKEN, CLIPDataConfig, DataConfig


def load_bbox_table(bbox_path: str, images_path: str) -> Dict[str, List[int]]:
    """Parse bounding_boxes.txt + images.txt into {stem: [x, y, w, h]}.

    Same join as the reference `_load_bbox` (`objects/dataset.py:65-77`):
    row i of bounding_boxes.txt belongs to row i of images.txt.
    """
    bboxes = np.loadtxt(bbox_path, dtype=np.float64)[:, 1:].astype(np.int64)
    names: List[str] = []
    with open(images_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                names.append(parts[1])
    return {name[:-4]: bboxes[i].tolist() for i, name in enumerate(names)}


def frame_clip(ids: np.ndarray, context: int, sot: int, eot: int
               ) -> Tuple[np.ndarray, int]:
    """CLIP's framing of one caption's BPE ids (a `CLIPDataConfig`):
    start-of-text, the first context - 2 ids, end-of-text, zeros to
    `context` (as `clip.tokenize(truncate=True)` frames a long caption);
    returns (ids [context], the framed length). The text tower reads the
    sentence at the end-of-text token, the largest id."""
    ids = np.asarray(ids, dtype=np.int64)[:context - 2]
    out = np.zeros((context,), dtype=np.int64)
    out[0], out[1:len(ids) + 1], out[len(ids) + 1] = sot, ids, eot
    return out, len(ids) + 2


class CUBDataset:
    """Indexable dataset over one split of a CUB-format directory."""

    def __init__(self, cfg: DataConfig, split: str = "train",
                 augment: bool = True):
        if split not in ("train", "test"):
            raise ValueError("split must be 'train' or 'test'")
        self.cfg = cfg
        self.split = split
        self.augment = augment
        self.image_size = cfg.image_size
        self.resized_size = int(cfg.image_size * cfg.resize_ratio)

        data_dir = cfg.data_dir
        self.images_dir = os.path.join(data_dir, "birds")
        captions_path = os.path.join(data_dir, "captions.pickle")
        filenames_path = os.path.join(data_dir, split, "filenames.pickle")

        with open(captions_path, "rb") as f:
            train_captions, test_captions, code2word, word2code = pickle.load(f)
        self.captions = train_captions if split == "train" else test_captions
        self.code2word: Dict[int, str] = code2word
        self.word2code: Dict[str, int] = word2code

        with open(filenames_path, "rb") as f:
            self.file_names: List[str] = pickle.load(f)

        # bbox files are a CUB-ism; COCO-style datasets (BASELINE config 4)
        # ship the same pickles without them — crop falls back to full frame.
        # Multi-location fallback mirrors the reference's search order
        # (`objects/dataset.py:36-47`: data_dir, ../data, cwd/data), and a
        # missing file WARNS loudly — silently training full-frame changes
        # the data distribution.
        # Both files must come from the SAME directory: bounding_boxes.txt
        # row i joins to images.txt row i, so mixing copies from different
        # directories would silently apply wrong crops to every image.
        aux_dir = self._find_aux_dir(data_dir,
                                     ("bounding_boxes.txt", "images.txt"))
        if aux_dir:
            self.bbox = load_bbox_table(
                os.path.join(aux_dir, "bounding_boxes.txt"),
                os.path.join(aux_dir, "images.txt"))
        else:
            print("Warning: bounding_boxes.txt/images.txt not found under "
                  f"{data_dir!r}, ../data, or ./data — bbox cropping DISABLED, "
                  "training on full frames")
            self.bbox = {}
        self.n_words = len(self.code2word)
        self._print_info(captions_path, filenames_path)

    @staticmethod
    def _find_aux_dir(data_dir: str, names: Tuple[str, ...]) -> Optional[str]:
        """First directory in the reference's search order
        (`objects/dataset.py:36-47`: data_dir, ../data, cwd/data) containing
        ALL of `names` — row-joined files must come from one copy."""
        for cand in (data_dir, os.path.join("..", "data"),
                     os.path.join(os.getcwd(), "data")):
            if all(os.path.isfile(os.path.join(cand, n)) for n in names):
                return cand
        return None

    def _print_info(self, captions_path: str, filenames_path: str) -> None:
        """Dataset info dump (reference `objects/dataset.py:58-63`)."""
        print(f"Total filenames: {len(self.bbox)}")
        print(f"Load captions from: {captions_path}")
        print(f"Load file names from: {filenames_path} ({len(self.file_names)})")
        print(f"Dictionary size: {self.n_words}")
        print(f"Embeddings number: {self.cfg.embeddings_num}")

    def __len__(self) -> int:
        return len(self.file_names)

    # -- caption handling (parity with `objects/dataset.py:98-133`) ---------

    def _encode_caption(self, caption_idx: int,
                        rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        caption = np.asarray(self.captions[caption_idx], dtype=np.int64)
        max_len = self.cfg.max_caption_len
        if isinstance(self.cfg, CLIPDataConfig):
            return frame_clip(caption, max_len, SOT_TOKEN, EOT_TOKEN)
        padded = np.zeros((max_len,), dtype=np.int64)
        if len(caption) <= max_len:
            padded[: len(caption)] = caption
            return padded, max(int(len(caption)), 1)
        keep = rng.permutation(len(caption))[:max_len]
        padded[:] = caption[np.sort(keep)]
        return padded, max_len

    def random_caption(self, idx: int,
                       rng: np.random.Generator) -> Tuple[np.ndarray, int]:
        shift = int(rng.integers(0, self.cfg.embeddings_num))
        return self._encode_caption(idx * self.cfg.embeddings_num + shift, rng)

    # -- image handling (parity with `objects/dataset.py:112-128`) ----------

    def _bbox_crop(self, image: Image.Image, bbox: Sequence[int]) -> Image.Image:
        width, height = image.size
        r = int(max(bbox[2], bbox[3]) * self.cfg.bbox_radius_factor)
        cx = int((2 * bbox[0] + bbox[2]) / 2)
        cy = int((2 * bbox[1] + bbox[3]) / 2)
        x1, x2 = max(0, cx - r), min(width, cx + r)
        y1, y2 = max(0, cy - r), min(height, cy + r)
        return image.crop((x1, y1, x2, y2))

    def load_image(self, idx: int, rng: np.random.Generator) -> np.ndarray:
        """Decode + crop + augment one image; returns uint8 [H, W, 3]."""
        name = self.file_names[idx]
        image = Image.open(os.path.join(self.images_dir, f"{name}.jpg"))
        image = image.convert("RGB")
        bbox = self.bbox.get(name)
        if bbox is not None:
            image = self._bbox_crop(image, bbox)

        # Resize shorter side to imsize*76/64 (torchvision Resize semantics,
        # bilinear), then random-crop imsize, then random horizontal flip
        # (`src/utils.py:15-19`).
        w, h = image.size
        short = min(w, h)
        scale = self.resized_size / short
        image = image.resize((max(1, round(w * scale)), max(1, round(h * scale))),
                             Image.BILINEAR)
        arr = np.asarray(image, dtype=np.uint8)

        hh, ww = arr.shape[:2]
        out = self.image_size
        if self.augment:
            top = int(rng.integers(0, hh - out + 1)) if hh > out else 0
            left = int(rng.integers(0, ww - out + 1)) if ww > out else 0
        else:
            top, left = max(0, (hh - out) // 2), max(0, (ww - out) // 2)
        arr = arr[top: top + out, left: left + out]
        if arr.shape[0] != out or arr.shape[1] != out:  # short side < out edge case
            pad_h, pad_w = out - arr.shape[0], out - arr.shape[1]
            arr = np.pad(arr, ((0, pad_h), (0, pad_w), (0, 0)))
        if self.augment and rng.random() < 0.5:
            arr = arr[:, ::-1]
        return np.ascontiguousarray(arr)

    def __getitem__(self, idx: int):
        """Single-item access with fresh RNG (for tests); training uses the
        batched loader which passes one RNG per epoch."""
        rng = np.random.default_rng()
        image = self.load_image(idx, rng)
        caption, cap_len = self.random_caption(idx, rng)
        return image, caption, cap_len, self.file_names[idx]
