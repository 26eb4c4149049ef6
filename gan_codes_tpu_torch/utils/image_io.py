"""Image save helpers (reference `src/sample.py:21-28`,
`src/deep_fusion_gan/model.py:329-387`); the port's own copy of the JAX
package's `utils/image_io.py`. matplotlib is imported only inside
`save_images_with_prompts`, the one helper that needs it."""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image


def denormalize_to_uint8(image: np.ndarray) -> np.ndarray:
    """[-1, 1] float NHWC/HWC -> uint8 (reference `sample.py:23-24`)."""
    arr = (np.asarray(image, dtype=np.float32) + 1.0) * 127.5
    return np.clip(arr, 0, 255).astype(np.uint8)


def save_image(image: np.ndarray, save_dir: str, file_name: str) -> str:
    """Save one [-1, 1] HWC image as PNG, '/'-safe name."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{file_name.replace('/', '_')}.png")
    Image.fromarray(denormalize_to_uint8(image)).save(path)
    return path


def save_image_grid(images: np.ndarray, path: str,
                    n_cols: Optional[int] = None, pad: int = 2) -> str:
    """Save a batch [B, H, W, 3] in [-1, 1] as one PNG grid."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = denormalize_to_uint8(images)
    b, h, w, c = arr.shape
    cols = n_cols or int(math.ceil(math.sqrt(b)))
    rows = int(math.ceil(b / cols))
    grid = np.zeros((rows * (h + pad) + pad, cols * (w + pad) + pad, c),
                    dtype=np.uint8)
    for i in range(b):
        r, cc = divmod(i, cols)
        y, x = pad + r * (h + pad), pad + cc * (w + pad)
        grid[y: y + h, x: x + w] = arr[i]
    Image.fromarray(grid).save(path)
    return path


def save_images_with_prompts(images: np.ndarray, prompts: Sequence[str],
                             path: str, max_images: int = 4) -> str:
    """Save <=4 images titled with their prompts via matplotlib
    (reference `model.py:329-374`)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = min(max_images, images.shape[0])
    fig, axes = plt.subplots(n, 1, figsize=(12, 3 * n), squeeze=False)
    for i in range(n):
        img = (np.asarray(images[i], np.float32) + 1.0) / 2.0
        axes[i][0].imshow(np.clip(img, 0, 1))
        axes[i][0].set_title(f"Prompt: {prompts[i]}", fontsize=10)
        axes[i][0].axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
    return path


def decode_caption(caption: np.ndarray, cap_len: int, code2word) -> str:
    """Decode token ids to a prompt string (reference `model.py:340-352`)."""
    words = []
    for j in range(int(cap_len)):
        idx = int(caption[j])
        words.append(code2word[idx] if code2word and idx in code2word
                     else f"[{idx}]")
    return " ".join(words)
