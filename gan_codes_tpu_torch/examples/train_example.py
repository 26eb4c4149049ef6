"""Training walkthrough (mirrors the reference's train_example.ipynb; the
port's counterpart of `examples/train_example.py`).

Runs a short training session on a synthetic CUB-format dataset, then plots
the loss curves. Swap `make_synthetic_cub` for a real CUB data directory to
reproduce the reference's full run (256px, batch 24, 600 epochs).

    python -m gan_codes_tpu_torch.examples.train_example [--device cpu]

Runs on CUDA unless `--device cpu` is given, and raises without a card.
The fixture's images are 1.5x the training size (48px at the default 32px).
"""
import argparse
import importlib.util
import os
import tempfile

from ..data.synthetic import make_synthetic_cub
from ..train_entry import train
from ..utils.device import serving_device
from ..utils.plotting import plot_losses, plot_metrics


def main(work: str = None, device: str = "cuda", image_size: int = 32,
         batch_size: int = 4, n_train: int = 8, n_test: int = 4) -> str:
    """Trains 2 epochs into `work` (a new temporary directory when None)
    and returns it: `data/`, `gen_images/`, `gen_weights/` and, where
    matplotlib is installed, `losses.png` and `metrics.png`."""
    serving_device(device)
    work = work or tempfile.mkdtemp(prefix="dfgan_example_")
    data_dir = os.path.join(work, "data")
    info = make_synthetic_cub(data_dir, n_train=n_train, n_test=n_test,
                              image_size=image_size * 3 // 2)
    print(f"Synthetic dataset: {info}")

    histories = train(
        data_path=data_dir,
        encoder_weights_path=None,          # random-init text encoder
        image_save_path=os.path.join(work, "gen_images"),
        gen_path_save=os.path.join(work, "gen_weights"),
        image_size=image_size, batch_size=batch_size, num_epochs=2,
        device=device,
    )

    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no loss or metric plots")
    else:
        plot_losses(histories["g_losses"], histories["d_losses"],
                    histories["d_gp_losses"],
                    path_save=os.path.join(work, "losses.png"))
        plot_metrics(histories["fid_scores"], histories["is_scores"],
                     path_save=os.path.join(work, "metrics.png"))
    print(f"Artifacts in {work}")
    return work


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    main(**vars(ap.parse_args()))
