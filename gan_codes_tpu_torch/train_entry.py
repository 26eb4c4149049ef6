"""Full training entry point (the port of `gan_codes_tpu/train_entry.py`).

Capability parity with `src/train.py:8-73`: fix the seed, build the train
and test loaders, construct the trainer with the dataset's vocabulary,
resume from the latest checkpoint if there is one, fit, print the
per-epoch metric table. Paths and hyperparameters come from flags:

    python -m gan_codes_tpu_torch.train_entry --data DATA_DIR \\
        --text-encoder text_encoder.pth --images gen_images \\
        --weights gen_weights [--device cpu]

It runs on CUDA unless `--device cpu` is given, and raises without a
card. `--inception` names a torchvision InceptionV3 `state_dict` file for
the per-epoch IS/FID; without it they record the sentinels IS 1.0 / FID
inf. Not ported yet: data parallelism (`--dp`, `--multihost`; ROADMAP
Queue 1 item 12). Not ported: the JAX package's TPU dispatch knobs,
which are exact math and have no meaning here (`--steps-per-dispatch`,
`--device-prefetch`, `--compile-cache`, `--xla-vmem-kib`, the lane and
image padding, the mesh layouts).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from .config import DataConfig, GANConfig
from .data.dataset import CUBDataset
from .data.loader import DataLoader
from .models.inception import load_torch_inception
from .models.text_encoder import RNNEncoder
from .models.torch_import import load_text_encoder
from .train.trainer import Trainer
from .utils.device import serving_device
from .utils.seeding import fix_seed


def train(data_path: str, encoder_weights_path: Optional[str],
          image_save_path: str = "gen_images",
          gen_path_save: str = "gen_weights",
          image_size: int = 256, batch_size: int = 24,
          num_epochs: int = 600, seed: int = 123321,
          inception_weights_path: Optional[str] = None,
          compute_dtype: str = "float32", damsm_weight: float = 0.0,
          gp_compute_dtype: str = "float32", eval_use_ema: bool = False,
          gp_interval: int = 1, ckpt_every: int = 1, n_channels: int = 32,
          eval_augment: bool = False, log_every_steps: int = 0,
          eval_every: int = 1, eval_sqrtm: str = "scipy",
          device: str | torch.device = "cuda"):
    """Train (or resume) a DF-GAN on a CUB-format directory; returns the
    metric histories."""
    dev = serving_device(device)
    fix_seed(seed, device=dev)

    os.makedirs(image_save_path, exist_ok=True)
    os.makedirs(gen_path_save, exist_ok=True)

    data_cfg = DataConfig(data_dir=data_path, image_size=image_size)
    train_ds = CUBDataset(data_cfg, "train")
    # The reference applies RandomCrop/Flip to the TEST loader too
    # (`src/utils.py:13-24`); deterministic eval is the default here,
    # --eval-augment reproduces the reference protocol.
    test_ds = CUBDataset(data_cfg, "test", augment=eval_augment)
    print(f"Test set size: {len(test_ds)} images")

    cfg = GANConfig.for_image_size(
        image_size, n_channels=n_channels, vocab_size=train_ds.n_words,
        loss_overrides={"damsm_weight": damsm_weight,
                        "gp_compute_dtype": gp_compute_dtype,
                        "gp_interval": gp_interval},
        batch_size=batch_size, num_epochs=num_epochs, seed=seed,
        compute_dtype=compute_dtype, eval_use_ema=eval_use_ema,
        checkpoint_every_epochs=ckpt_every, log_every_steps=log_every_steps,
        eval_every_epochs=eval_every, eval_sqrtm=eval_sqrtm)

    train_loader = DataLoader(train_ds, batch_size, seed=seed)
    test_loader = DataLoader(test_ds, batch_size, shuffle=False, seed=seed)

    if encoder_weights_path and os.path.exists(encoder_weights_path):
        text_encoder, _ = load_text_encoder(encoder_weights_path,
                                            cfg.text_encoder)
    else:
        print("Warning: no pretrained text encoder; using random init")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            text_encoder = RNNEncoder(cfg.text_encoder)
    inception_params = None
    if inception_weights_path and os.path.exists(inception_weights_path):
        inception_params = load_torch_inception(inception_weights_path)
    else:
        print("Warning: no Inception weights; IS/FID disabled")

    trainer = Trainer(cfg, text_encoder, gen_path_save, image_save_path,
                      code2word=train_ds.code2word,
                      inception_params=inception_params, seed=seed,
                      device=dev)
    try:
        histories = trainer.fit(train_loader, test_loader,
                                num_epochs=num_epochs, auto_resume=True)
    finally:
        trainer.close()

    for epoch in range(len(histories["g_losses"])):
        print(f"Epoch {epoch + 1}: "
              f"G Loss: {histories['g_losses'][epoch]:.4f}, "
              f"D Loss: {histories['d_losses'][epoch]:.4f}, "
              f"D GP Loss: {histories['d_gp_losses'][epoch]:.4f}, "
              f"Text-Image Loss: {histories['txtimg_losses'][epoch]:.4f}, "
              f"IS: {histories['is_scores'][epoch]:.4f}, "
              f"FID: {histories['fid_scores'][epoch]:.4f}")
    return histories


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(
        description="Train the DF-GAN with the PyTorch/CUDA port")
    p.add_argument("--data", required=True)
    p.add_argument("--text-encoder", default=None)
    p.add_argument("--inception", default=None,
                   help="torchvision InceptionV3 state_dict (.pth) for the "
                        "per-epoch IS/FID (absent: IS 1.0 / FID inf)")
    p.add_argument("--images", default="gen_images")
    p.add_argument("--weights", default="gen_weights")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=24)
    p.add_argument("--epochs", type=int, default=600)
    p.add_argument("--seed", type=int, default=123321)
    p.add_argument("--n-channels", type=int, default=32,
                   help="base channel width of G/D (the reference's 32; "
                        "must match a resumed checkpoint's width)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--gp-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="MA-GP phase D-forward dtype (norm math stays fp32)")
    p.add_argument("--damsm-weight", type=float, default=0.0,
                   help="weight of the DAMSM cosine term in the G loss "
                        "(0.0 = the reference's logged-only quirk)")
    p.add_argument("--eval-ema", action="store_true",
                   help="evaluate + sample with the EMA generator")
    p.add_argument("--eval-augment", action="store_true",
                   help="apply train-time RandomCrop/Flip augmentation to "
                        "the test loader too (the reference's eval "
                        "protocol, src/utils.py:13-24); default is "
                        "deterministic eval")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="save the checkpoint every N epochs (1 = the "
                        "reference's every-epoch saves; a crash replays at "
                        "most N-1 epochs, resume stays bit-exact)")
    p.add_argument("--gp-interval", type=int, default=1,
                   help="lazy regularization: run MA-GP every N steps with "
                        "the coefficient scaled by N (1 = reference "
                        "every-step semantics)")
    p.add_argument("--eval-every", type=int, default=1,
                   help="run eval + sample dumps every N epochs (last epoch "
                        "always; skipped epochs log the reference sentinels "
                        "IS 1.0 / FID inf). 0 = final epoch only")
    p.add_argument("--eval-sqrtm", default="scipy",
                   choices=["scipy", "newton_schulz"],
                   help="FID matrix square root where the exact low-rank "
                        "path does not apply (more than 2048 eval images a "
                        "side): scipy on the host (the reference's path) or "
                        "Newton-Schulz in float64 on the device")
    p.add_argument("--log-every-steps", type=int, default=0,
                   help="also write every Nth step's loss scalars as "
                        "kind='step' JSONL rows (0 = per-epoch rows only; "
                        "no extra host syncs)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    a = p.parse_args(argv)
    return train(a.data, a.text_encoder, a.images, a.weights, a.image_size,
                 a.batch_size, a.epochs, a.seed, a.inception, a.dtype,
                 damsm_weight=a.damsm_weight, gp_compute_dtype=a.gp_dtype,
                 eval_use_ema=a.eval_ema, gp_interval=a.gp_interval,
                 ckpt_every=a.ckpt_every, n_channels=a.n_channels,
                 eval_augment=a.eval_augment,
                 log_every_steps=a.log_every_steps, eval_every=a.eval_every,
                 eval_sqrtm=a.eval_sqrtm, device=a.device)


if __name__ == "__main__":
    main()
