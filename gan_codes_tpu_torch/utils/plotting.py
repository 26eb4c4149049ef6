"""Loss and metric curve plots (reference `src/utils.py:38-80`; the port's
copy of the JAX package's `utils/plotting.py`). matplotlib is imported
inside the functions, so the package imports without it."""
from __future__ import annotations

from typing import List, Optional, Sequence


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_losses(g_losses: List[float], d_losses: List[float],
                d_gp_losses: List[float],
                path_save: str = "losses.png") -> str:
    plt = _plt()
    plt.figure(dpi=256)
    plt.plot(g_losses, label="G loss")
    plt.plot(d_losses, label="D loss")
    plt.plot(d_gp_losses, label="D MA-GP loss")
    plt.xlabel("Number of epochs")
    plt.ylabel("Loss value")
    plt.legend()
    plt.title("DF-GAN losses")
    plt.tight_layout()
    plt.savefig(path_save)
    plt.close()
    return path_save


def plot_metrics(fid: List[float], iscore: List[float],
                 epochs: Optional[Sequence[int]] = None,
                 path_save: str = "metrics.png") -> str:
    plt = _plt()
    plt.figure(dpi=256)
    plt.plot(fid, label="FID")
    plt.plot(iscore, label="Inception Score")
    if epochs is not None:
        import numpy as np
        plt.xticks(np.arange(len(epochs)), list(epochs))
    plt.xlabel("Epoch")
    plt.ylabel("Metric value")
    plt.legend()
    plt.title("Deep Fusion GAN metrics values per epochs")
    plt.tight_layout()
    plt.savefig(path_save)
    plt.close()
    return path_save
