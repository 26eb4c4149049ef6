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
inf.

Data parallelism: one process per card, started by `torchrun`:

    torchrun --nproc-per-node 8 -m gan_codes_tpu_torch.train_entry --dp ...

`--dp` on one node takes `--batch-size` as the global batch; `--multihost`
(which implies `--dp`) takes it as the batch of one node, so the global
batch is batch_size x nodes. Each process takes batch_size /
LOCAL_WORLD_SIZE rows of its node's batch, on the card LOCAL_RANK (NCCL;
gloo with `--device cpu`). The checkpoint directory must be one every
node sees. `--dp` outside torchrun is a world of one process.
`--deterministic` runs cuDNN on its deterministic algorithms, so a run
repeats bit for bit on the card and a resumed run equals its
uninterrupted twin (the default algorithms add in an order that varies
from run to run, which a few Adam steps can grow from the last bit into
percents of a loss); the step is slower for it (`PERF.md` §5).
`--mesh-layout` and `--mesh-slices` take only their defaults (`flat`, 0),
so scripts written for the JAX CLI still parse; any other value is an
error, since they shape the JAX package's TPU mesh and NCCL picks its own
rings.

The JAX CLI's options that mean something on the card:

* `--matmul-precision {default,high,highest}` (JAX's
  `jax_default_matmul_precision`): "high" and "default" run fp32 convs
  and matmuls as one TF32 product, in cuDNN, cuBLAS and the kernels K2
  and K3 (`utils/device.py::set_matmul_precision`); absent or "highest"
  keeps fp32 (TF32 off; K2 and K3 in 3xTF32). Unlike JAX on a TPU, where
  the absent flag means one bf16 pass, the absent flag here is the
  reference's CUDA fp32. The setting holds for the run and is restored
  after it. bf16 compute is unchanged by it.
* `--remat-g`: recompute each generator block in the backward
  (`GeneratorConfig.remat_blocks`): less activation memory, a longer step,
  the same gradients.
* `--device-prefetch` (`TrainConfig.device_prefetch`): accepted and
  recorded, and changes nothing: the port's trainer always uploads batch
  i + 1 while step i runs (on a side CUDA stream with one process on a
  card), with the plain loop's trajectory.
* `--debug-nans` (JAX's `jax_debug_nans`): each step raises
  `FloatingPointError` at its first NaN, naming the phase and the tensor,
  before the NaN guard hides it; the run then exits non-zero.

GALIP (`--config FILE`, a `GALIPConfig` as JSON with `"architecture":
"galip"`): trains GALIP (`models/galip.py`) with the sizes, losses and
optimizer of the file; `--batch-size`, `--epochs`, `--seed`, the
precision and the data flags apply as for DF-GAN; `--text-encoder` names
OpenAI's CLIP weights (`ViT-B-32.pt`, its state_dict or TorchScript
archive); without them the CLIP is seeded at random. `captions.pickle`
then holds CLIP BPE ids, framed to 77 tokens by the dataset:

    python -m gan_codes_tpu_torch.train_entry --data DATA_DIR \\
        --config h100_bench/configs/galip-cub224-tf32.json \\
        --text-encoder ViT-B-32.pt --batch-size 64 \\
        --matmul-precision high --images gen_images --weights gen_weights

Not ported: the JAX package's TPU compilation and dispatch knobs, which are
exact math and have no meaning here: `--compile-cache`, `--xla-vmem-kib`,
the lane and image padding, and `--steps-per-dispatch` (its counterpart
on the card is no flag: DF-GAN's step on one card replays as CUDA graphs
from its second step on, `train/step.py::DFGANStep`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

import torch

from .config import DataConfig, GANConfig, config_from_dict, is_galip
from .data.dataset import CUBDataset
from .data.loader import DataLoader
from .models.clip import CLIP, load_openai_state_dict
from .models.inception import load_torch_inception
from .models.text_encoder import RNNEncoder
from .models.torch_import import load_text_encoder
from .parallel.dp import loader_shard
from .parallel.mesh import close_mesh, init_mesh
from .train.trainer import Trainer
from .utils.device import (MATMUL_PRECISIONS, serving_device,
                           set_matmul_precision)
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
          device: str | torch.device = "cuda",
          data_parallel: bool = False, multihost: bool = False,
          deterministic: bool = False,
          matmul_precision: Optional[str] = None, remat_g: bool = False,
          device_prefetch: bool = False, debug_nans: bool = False,
          config_path: Optional[str] = None):
    """Train (or resume) a DF-GAN on a CUB-format directory; returns the
    metric histories. `data_parallel` / `multihost` / `deterministic` /
    `matmul_precision` / `remat_g` / `device_prefetch` / `debug_nans`: the
    module docstring's `--dp` / `--multihost` / `--deterministic` /
    `--matmul-precision` / `--remat-g` / `--device-prefetch` /
    `--debug-nans` (cuDNN's flag and the precision are set for the call
    and restored after it). `config_path`: `--config`, a GALIP config
    file; `encoder_weights_path` then names CLIP's weights."""
    cudnn_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = cudnn_deterministic or deterministic
    mesh = init_mesh(device) if data_parallel or multihost else None
    # the precision this call replaced, once it has set one (after the
    # device is resolved: serving_device keeps a set precision)
    replaced = None
    try:
        dev = mesh.device if mesh is not None else serving_device(device)
        if matmul_precision is not None:
            replaced = (set_matmul_precision(matmul_precision),)
        primary = mesh is None or mesh.primary
        shard = {}
        if mesh is not None:
            if mesh.nodes > 1 and not multihost:
                raise ValueError(f"--dp over {mesh.nodes} nodes needs "
                                 "--multihost (--batch-size is then a node's "
                                 "batch)")
            shard = loader_shard(mesh)
        fix_seed(seed, device=dev)

        if primary:
            os.makedirs(image_save_path, exist_ok=True)
            os.makedirs(gen_path_save, exist_ok=True)

        galip = None
        if config_path is not None:
            with open(config_path) as f:
                galip = config_from_dict(json.load(f))
            if not is_galip(galip):
                raise ValueError(f"--config {config_path}: only a GALIP "
                                 "config (\"architecture\": \"galip\") "
                                 "is read; DF-GAN takes its sizes from the "
                                 "flags")
            if remat_g:
                raise ValueError("--remat-g recomputes DF-GAN's generator "
                                 "blocks; GALIP (--config) has no such "
                                 "path")
            image_size = galip.generator.image_size
            data_cfg = dataclasses.replace(galip.data, data_dir=data_path,
                                           image_size=image_size)
        else:
            data_cfg = DataConfig(data_dir=data_path, image_size=image_size)
        train_ds = CUBDataset(data_cfg, "train")
        # The reference applies RandomCrop/Flip to the TEST loader too
        # (`src/utils.py:13-24`); deterministic eval is the default here,
        # --eval-augment reproduces the reference protocol.
        test_ds = CUBDataset(data_cfg, "test", augment=eval_augment)
        if primary:
            print(f"Test set size: {len(test_ds)} images")

        cfg = GANConfig.for_image_size(
            image_size, n_channels=n_channels, vocab_size=train_ds.n_words,
            loss_overrides={"damsm_weight": damsm_weight,
                            "gp_compute_dtype": gp_compute_dtype,
                            "gp_interval": gp_interval},
            batch_size=batch_size, num_epochs=num_epochs, seed=seed,
            generator_overrides={"remat_blocks": remat_g},
            compute_dtype=compute_dtype, eval_use_ema=eval_use_ema,
            checkpoint_every_epochs=ckpt_every,
            log_every_steps=log_every_steps, eval_every_epochs=eval_every,
            eval_sqrtm=eval_sqrtm, device_prefetch=device_prefetch)

        if galip is not None:
            cfg = dataclasses.replace(
                galip, data=data_cfg,
                train=dataclasses.replace(
                    cfg.train, ema_decay=galip.train.ema_decay))

        train_loader = DataLoader(train_ds, batch_size, seed=seed, **shard)
        test_loader = DataLoader(test_ds, batch_size, shuffle=False, seed=seed,
                                 **shard)

        if galip is not None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                text_encoder = CLIP(cfg.text_encoder)
            if encoder_weights_path and os.path.exists(encoder_weights_path):
                load_openai_state_dict(text_encoder, load_clip_state_dict(
                    encoder_weights_path))
            elif primary:
                print("Warning: no CLIP weights (ViT-B-32.pt); using a "
                      "seeded random CLIP")
        elif encoder_weights_path and os.path.exists(encoder_weights_path):
            text_encoder, _ = load_text_encoder(encoder_weights_path,
                                                cfg.text_encoder)
        else:
            if primary:
                print("Warning: no pretrained text encoder; using random init")
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                text_encoder = RNNEncoder(cfg.text_encoder)
        inception_params = None
        if inception_weights_path and os.path.exists(inception_weights_path):
            inception_params = load_torch_inception(inception_weights_path)
        elif primary:
            print("Warning: no Inception weights; IS/FID disabled")

        trainer = Trainer(cfg, text_encoder, gen_path_save, image_save_path,
                          code2word=train_ds.code2word,
                          inception_params=inception_params, seed=seed,
                          device=dev, mesh=mesh, debug_nans=debug_nans)
        try:
            histories = trainer.fit(train_loader, test_loader,
                                    num_epochs=num_epochs, auto_resume=True)
        finally:
            trainer.close()

        for epoch in range(len(histories["g_losses"]) if primary else 0):
            print(f"Epoch {epoch + 1}: "
                  f"G Loss: {histories['g_losses'][epoch]:.4f}, "
                  f"D Loss: {histories['d_losses'][epoch]:.4f}, "
                  f"D GP Loss: {histories['d_gp_losses'][epoch]:.4f}, "
                  f"Text-Image Loss: {histories['txtimg_losses'][epoch]:.4f}, "
                  f"IS: {histories['is_scores'][epoch]:.4f}, "
                  f"FID: {histories['fid_scores'][epoch]:.4f}")
        return histories
    finally:
        close_mesh(mesh)
        torch.backends.cudnn.deterministic = cudnn_deterministic
        if replaced is not None:
            set_matmul_precision(replaced[0])


def load_clip_state_dict(path: str):
    """CLIP's state_dict from OpenAI's file: a TorchScript archive (as
    `ViT-B-32.pt` ships) or a plain `torch.save` of the state_dict."""
    try:
        return torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        return torch.load(path, map_location="cpu", weights_only=True)


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
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over the processes torchrun starts, "
                        "one per card; --batch-size is the global batch")
    p.add_argument("--multihost", action="store_true",
                   help="data-parallel over several nodes (implies --dp); "
                        "--batch-size is one node's batch")
    p.add_argument("--deterministic", action="store_true",
                   help="cuDNN's deterministic algorithms: runs repeat bit "
                        "for bit on the card (a slower step)")
    p.add_argument("--matmul-precision", default=None,
                   choices=list(MATMUL_PRECISIONS),
                   help="fp32 convs and matmuls, as JAX's "
                        "jax_default_matmul_precision: 'high' and "
                        "'default' run one TF32 product (cuDNN, cuBLAS "
                        "and the kernels K2, K3); absent or 'highest' "
                        "fp32 (the reference's CUDA fp32)")
    p.add_argument("--remat-g", action="store_true",
                   help="recompute each G block in the backward instead "
                        "of keeping its activations (same gradients)")
    p.add_argument("--device-prefetch", action="store_true",
                   help="accepted for the JAX CLI's scripts; the "
                        "trainer always uploads batch i+1 while step i "
                        "runs (on a side CUDA stream with one process)")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast: raise FloatingPointError at a step's "
                        "first NaN, naming the phase and tensor")
    p.add_argument("--config", default=None,
                   help="a GALIP config file (JSON with \"architecture\": "
                        "\"galip\", e.g. h100_bench/configs/"
                        "galip-cub224-tf32.json): trains GALIP; "
                        "--text-encoder then names CLIP's weights "
                        "(ViT-B-32.pt), and the sizes come from the file")
    p.add_argument("--mesh-layout", default="flat",
                   help="the JAX package's TPU mesh layout; only the "
                        "default 'flat' (NCCL picks its own rings)")
    p.add_argument("--mesh-slices", type=int, default=0,
                   help="the JAX package's virtual slice count; only the "
                        "default 0")
    a = p.parse_args(argv)
    if a.mesh_layout != "flat":
        p.error(f"--mesh-layout {a.mesh_layout}: the layout of the JAX "
                "package's TPU mesh has no meaning here (NCCL picks its own "
                "rings); only the default 'flat' is accepted")
    if a.mesh_slices != 0:
        p.error(f"--mesh-slices {a.mesh_slices}: the JAX package's TPU "
                "slice count has no meaning here (NCCL picks its own "
                "rings); only the default 0 is accepted")
    return train(a.data, a.text_encoder, a.images, a.weights, a.image_size,
                 a.batch_size, a.epochs, a.seed, a.inception, a.dtype,
                 damsm_weight=a.damsm_weight, gp_compute_dtype=a.gp_dtype,
                 eval_use_ema=a.eval_ema, gp_interval=a.gp_interval,
                 ckpt_every=a.ckpt_every, n_channels=a.n_channels,
                 eval_augment=a.eval_augment,
                 log_every_steps=a.log_every_steps, eval_every=a.eval_every,
                 eval_sqrtm=a.eval_sqrtm, device=a.device,
                 data_parallel=a.dp, multihost=a.multihost,
                 deterministic=a.deterministic,
                 matmul_precision=a.matmul_precision, remat_g=a.remat_g,
                 device_prefetch=a.device_prefetch,
                 debug_nans=a.debug_nans, config_path=a.config)


if __name__ == "__main__":
    main()
