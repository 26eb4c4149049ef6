"""One-command validation harness for the FID-parity north star (the
port's counterpart of `tools/validate_pretrained.py`).

The pretrained DAMSM `text_encoder.pth`, torchvision's InceptionV3 weights
and the CUB data are not in the repository, so the north-star check (FID
on CUB within +-2 of the reference at matched steps) cannot run yet. This
tool makes it one command the day the files are there, and proves itself
end to end on schema-correct random weights now:

    python -m gan_codes_tpu_torch.tools.validate_pretrained --self-test
    python -m gan_codes_tpu_torch.tools.validate_pretrained \\
        --text-encoder text_encoder.pth --inception inception_v3.pth \\
        [--cub-dir CUB_DIR] [--n-images 64]
    python -m gan_codes_tpu_torch.tools.validate_pretrained \\
        --check-weights WEIGHTS_DIR

The port's leg runs on `--device` (CUDA by default; raises without a
card, `--device cpu` runs it on the CPU); the reference leg runs on the
CPU in float32. The reference leg is this module's own functional copy of
the reference semantics (the torchvision Inception3 graph with its batch
norms unfolded; the generator's forward on a raw reference-format
state_dict), independent of the port's models. Checks, each printed with
its delta and [PASS] / [FAIL]:

  (a) sentence embeddings: the port's `RNNEncoder` against the reference
      encoder (`src/text_encoder/model.py:33-56`, a packed biLSTM run
      from the raw state_dict) on unsorted lengths; max|delta| < 5e-4;
  (b) FID: the port's `eval/metrics.py::compute_fid` against the
      reference pipeline (`src/evaluation/metrics.py:62-118`: [-1,1] ->
      [0,1] clamp, bilinear resize to 299, Inception3, scipy's `sqrtm`)
      on the same images; within 0.5 absolute or 1% relative;
  (c) IS (`metrics.py:7-60`, splits=1, logits clamped to +-50): within
      1% relative;
  --check-weights: a port weights dir's newest generator on the device
      (through kernel K2 on the card) against the reference forward of
      its state_dict; max|delta| < 5e-4.

Images come from the CUB test split with `--cub-dir`, otherwise from a
seeded synthetic set; both legs see the same arrays, so the deltas
isolate the graphs' numerics. Exit code 0 only when every check passes;
then it prints the matched-steps procedure for the +-2 FID comparison.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DataConfig, GANConfig
from ..eval import metrics
from ..models.inception import (inception_to, load_torch_inception,
                                random_torchvision_state_dict)
from ..models.torch_import import (latest_generator_weights, load_generator,
                                   load_text_encoder, torch_load_ref)
from ..utils.device import serving_device

# Tolerances (the JAX tool's): the same weights and inputs through two
# float32 graphs. The FID tolerance is far inside the +-2 north-star budget.
TOL_SENT_ABS = 5e-4       # max |delta| on sentence embeddings
TOL_IS_REL = 0.01         # 1% relative on IS
TOL_FID_ABS = 0.5         # absolute on FID (or 1% relative)
TOL_GEN_ABS = 5e-4        # max |delta| on generated images


class Results:
    """The checks of one run, in order."""

    def __init__(self):
        self.checks: List[Tuple[str, bool]] = []

    def check(self, name: str, ok: bool, detail: str) -> None:
        self.checks.append((name, bool(ok)))
        print(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)

    def failed(self) -> List[str]:
        return [n for n, ok in self.checks if not ok]

    def summary(self) -> str:
        failed = self.failed()
        return (f"{len(self.checks) - len(failed)}/{len(self.checks)} checks "
                f"passed" + (f"; FAILED: {failed}" if failed else ""))


# ---------------------------------------------------------------------------
# The reference leg: functional torch on the CPU, float32, raw state_dicts.
# The Inception3 graph (transform_input=False, eval mode) and the generator
# forward are this module's copies of the repository's test oracle.
# ---------------------------------------------------------------------------

def _iv3_conv_bn(sd, name, x, stride=1, padding=0):
    x = F.conv2d(x, sd[f"{name}.conv.weight"], stride=stride, padding=padding)
    x = F.batch_norm(x, sd[f"{name}.bn.running_mean"],
                     sd[f"{name}.bn.running_var"], sd[f"{name}.bn.weight"],
                     sd[f"{name}.bn.bias"], training=False, eps=1e-3)
    return F.relu(x)


def _iv3_a(sd, n, x):
    b1 = _iv3_conv_bn(sd, f"{n}.branch1x1", x)
    b5 = _iv3_conv_bn(sd, f"{n}.branch5x5_2",
                      _iv3_conv_bn(sd, f"{n}.branch5x5_1", x), padding=2)
    b3 = _iv3_conv_bn(sd, f"{n}.branch3x3dbl_1", x)
    b3 = _iv3_conv_bn(sd, f"{n}.branch3x3dbl_2", b3, padding=1)
    b3 = _iv3_conv_bn(sd, f"{n}.branch3x3dbl_3", b3, padding=1)
    bp = _iv3_conv_bn(sd, f"{n}.branch_pool",
                      F.avg_pool2d(x, 3, stride=1, padding=1))
    return torch.cat([b1, b5, b3, bp], 1)


def _iv3_b(sd, n, x):
    b3 = _iv3_conv_bn(sd, f"{n}.branch3x3", x, stride=2)
    bd = _iv3_conv_bn(sd, f"{n}.branch3x3dbl_1", x)
    bd = _iv3_conv_bn(sd, f"{n}.branch3x3dbl_2", bd, padding=1)
    bd = _iv3_conv_bn(sd, f"{n}.branch3x3dbl_3", bd, stride=2)
    return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)


def _iv3_c(sd, n, x):
    b1 = _iv3_conv_bn(sd, f"{n}.branch1x1", x)
    b7 = _iv3_conv_bn(sd, f"{n}.branch7x7_1", x)
    b7 = _iv3_conv_bn(sd, f"{n}.branch7x7_2", b7, padding=(0, 3))
    b7 = _iv3_conv_bn(sd, f"{n}.branch7x7_3", b7, padding=(3, 0))
    bd = _iv3_conv_bn(sd, f"{n}.branch7x7dbl_1", x)
    bd = _iv3_conv_bn(sd, f"{n}.branch7x7dbl_2", bd, padding=(3, 0))
    bd = _iv3_conv_bn(sd, f"{n}.branch7x7dbl_3", bd, padding=(0, 3))
    bd = _iv3_conv_bn(sd, f"{n}.branch7x7dbl_4", bd, padding=(3, 0))
    bd = _iv3_conv_bn(sd, f"{n}.branch7x7dbl_5", bd, padding=(0, 3))
    bp = _iv3_conv_bn(sd, f"{n}.branch_pool",
                      F.avg_pool2d(x, 3, stride=1, padding=1))
    return torch.cat([b1, b7, bd, bp], 1)


def _iv3_d(sd, n, x):
    b3 = _iv3_conv_bn(sd, f"{n}.branch3x3_1", x)
    b3 = _iv3_conv_bn(sd, f"{n}.branch3x3_2", b3, stride=2)
    b7 = _iv3_conv_bn(sd, f"{n}.branch7x7x3_1", x)
    b7 = _iv3_conv_bn(sd, f"{n}.branch7x7x3_2", b7, padding=(0, 3))
    b7 = _iv3_conv_bn(sd, f"{n}.branch7x7x3_3", b7, padding=(3, 0))
    b7 = _iv3_conv_bn(sd, f"{n}.branch7x7x3_4", b7, stride=2)
    return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


def _iv3_e(sd, n, x):
    b1 = _iv3_conv_bn(sd, f"{n}.branch1x1", x)
    b3 = _iv3_conv_bn(sd, f"{n}.branch3x3_1", x)
    b3 = torch.cat([
        _iv3_conv_bn(sd, f"{n}.branch3x3_2a", b3, padding=(0, 1)),
        _iv3_conv_bn(sd, f"{n}.branch3x3_2b", b3, padding=(1, 0))], 1)
    bd = _iv3_conv_bn(sd, f"{n}.branch3x3dbl_1", x)
    bd = _iv3_conv_bn(sd, f"{n}.branch3x3dbl_2", bd, padding=1)
    bd = torch.cat([
        _iv3_conv_bn(sd, f"{n}.branch3x3dbl_3a", bd, padding=(0, 1)),
        _iv3_conv_bn(sd, f"{n}.branch3x3dbl_3b", bd, padding=(1, 0))], 1)
    bp = _iv3_conv_bn(sd, f"{n}.branch_pool",
                      F.avg_pool2d(x, 3, stride=1, padding=1))
    return torch.cat([b1, b3, bd, bp], 1)


@torch.no_grad()
def inception_v3_pool_features(sd, x: torch.Tensor) -> torch.Tensor:
    """[B,3,299,299] in [0,1] -> [B,2048] pool features (Inception3.forward
    up to avgpool, transform_input=False, eval)."""
    x = _iv3_conv_bn(sd, "Conv2d_1a_3x3", x, stride=2)
    x = _iv3_conv_bn(sd, "Conv2d_2a_3x3", x)
    x = _iv3_conv_bn(sd, "Conv2d_2b_3x3", x, padding=1)
    x = F.max_pool2d(x, 3, 2)
    x = _iv3_conv_bn(sd, "Conv2d_3b_1x1", x)
    x = _iv3_conv_bn(sd, "Conv2d_4a_3x3", x)
    x = F.max_pool2d(x, 3, 2)
    for n in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _iv3_a(sd, n, x)
    x = _iv3_b(sd, "Mixed_6a", x)
    for n in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _iv3_c(sd, n, x)
    x = _iv3_d(sd, "Mixed_7a", x)
    x = _iv3_e(sd, "Mixed_7b", x)
    x = _iv3_e(sd, "Mixed_7c", x)
    return F.adaptive_avg_pool2d(x, 1).flatten(1)


@torch.no_grad()
def inception_v3_logits(sd, x: torch.Tensor) -> torch.Tensor:
    feats = inception_v3_pool_features(sd, x)
    return F.linear(feats, sd["fc.weight"], sd["fc.bias"])


def sd_affine(sd, p, x, sent):
    def mlp(pp):
        h = F.relu(F.linear(sent, sd[f"{pp}.0.weight"], sd[f"{pp}.0.bias"]))
        return F.linear(h, sd[f"{pp}.2.weight"], sd[f"{pp}.2.bias"])

    return (mlp(f"{p}.gamma_mlp")[:, :, None, None] * x
            + mlp(f"{p}.beta_mlp")[:, :, None, None])


def sd_res_block_g(sd, p, x, sent):
    h = F.leaky_relu(sd_affine(sd, f"{p}.fusion_block_1", x, sent), 0.2)
    h = F.leaky_relu(sd_affine(sd, f"{p}.fusion_block_2", h, sent), 0.2)
    h = F.conv2d(h, sd[f"{p}.conv_1.weight"], sd[f"{p}.conv_1.bias"],
                 padding=1)
    h = F.leaky_relu(sd_affine(sd, f"{p}.fusion_block_3", h, sent), 0.2)
    h = F.leaky_relu(sd_affine(sd, f"{p}.fusion_block_4", h, sent), 0.2)
    h = F.conv2d(h, sd[f"{p}.conv_2.weight"], sd[f"{p}.conv_2.bias"],
                 padding=1)
    short = x
    if f"{p}.scale_conv.weight" in sd:
        short = F.conv2d(x, sd[f"{p}.scale_conv.weight"],
                         sd[f"{p}.scale_conv.bias"])
    return short + sd[f"{p}.gamma"] * h


def sd_generator_forward(sd, cfg, noise, sent):
    """cfg is a GeneratorConfig; noise/sent are torch tensors. Returns the
    NCHW image batch (reference `src/generator/model.py:32-46`)."""
    x = F.linear(noise, sd["linear_in.weight"], sd["linear_in.bias"])
    x = x.view(noise.shape[0], cfg.seed_channels, cfg.base_size,
               cfg.base_size)
    n_up = len(cfg.block_channels) - 1
    for i in range(n_up):
        x = F.interpolate(sd_res_block_g(sd, f"res_blocks.{i}", x, sent),
                          scale_factor=2)
    x = sd_res_block_g(sd, "res_block_out", x, sent)
    x = F.conv2d(F.leaky_relu(x, 0.2), sd["conv_out.1.weight"],
                 sd["conv_out.1.bias"], padding=1)
    return torch.tanh(x)


def torch_sentence_embeddings(sd, captions: np.ndarray,
                              cap_lens: np.ndarray) -> np.ndarray:
    """Reference RNNEncoder forward in eval mode (dropout inactive), run
    from the raw state_dict: Embedding -> pack_padded_sequence -> biLSTM ->
    final hidden states transposed and flattened (`model.py:33-56`)."""
    emb_w = sd["encoder.weight"]
    e_dim = emb_w.shape[1]
    h_dim = sd["rnn.weight_hh_l0"].shape[1]
    bidir = "rnn.weight_ih_l0_reverse" in sd
    lstm = torch.nn.LSTM(e_dim, h_dim, 1, batch_first=True,
                         bidirectional=bidir)
    lstm.load_state_dict({k[len("rnn."):]: sd[k] for k in sd
                          if k.startswith("rnn.")})
    lstm.eval()
    with torch.no_grad():
        e = F.embedding(torch.from_numpy(captions.astype(np.int64)), emb_w)
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            e, cap_lens.tolist(), batch_first=True, enforce_sorted=False)
        _, (h_n, _) = lstm(packed)
        sent = h_n.transpose(0, 1).contiguous().view(captions.shape[0], -1)
    return sent.numpy()


def torch_is_fid(sd, fake: np.ndarray, real: np.ndarray,
                 batch_size: int = 8) -> Tuple[float, float]:
    """The reference eval pipeline (`src/evaluation/metrics.py:7-118`):
    [-1,1] -> [0,1] clamp -> bilinear 299 -> Inception3; IS from
    clamp(+-50) -> softmax -> KL (splits=1), FID from the pool features'
    (mu, cov) and scipy's sqrtm. Inputs NHWC float32."""
    from scipy import linalg

    def batches(x):
        x = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).astype(np.float32))
        x = torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
        for i in range(0, x.shape[0], batch_size):
            yield F.interpolate(x[i:i + batch_size], size=(299, 299),
                                mode="bilinear", align_corners=False)

    with torch.no_grad():
        preds = torch.cat([
            torch.softmax(torch.clamp(inception_v3_logits(sd, b), -50.0,
                                      50.0), dim=1)
            for b in batches(fake)]).numpy()
        acts = {name: torch.cat([inception_v3_pool_features(sd, b)
                                 for b in batches(x)]).double().numpy()
                for name, x in (("fake", fake), ("real", real))}

    py = preds.mean(axis=0) + 1e-10
    kl = np.sum((preds + 1e-10) * (np.log(preds + 1e-10) - np.log(py)),
                axis=1)
    is_score = float(np.exp(np.mean(kl)))

    mu = {k: a.mean(axis=0) for k, a in acts.items()}
    sig = {k: np.cov(a, rowvar=False) for k, a in acts.items()}
    covmean = linalg.sqrtm(sig["real"] @ sig["fake"])
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    diff = mu["real"] - mu["fake"]
    fid = float(diff @ diff + np.trace(sig["real"]) + np.trace(sig["fake"])
                - 2.0 * np.trace(covmean))
    return is_score, fid


# ---------------------------------------------------------------------------
# The checks: the port's leg on the device against the reference leg
# ---------------------------------------------------------------------------

def validate_text_encoder(results: Results, te_path: str,
                          captions: np.ndarray, cap_lens: np.ndarray,
                          device: torch.device) -> None:
    sd = torch.load(te_path, map_location="cpu", weights_only=True)
    vocab = int(sd["encoder.weight"].shape[0])
    captions = np.where(captions >= vocab, 0, captions)  # OOV -> <unk>=0
    te, _ = load_text_encoder(te_path)
    with torch.inference_mode():
        got = te.to(device)(torch.from_numpy(captions).to(device),
                            torch.from_numpy(cap_lens)).float().cpu().numpy()
    want = torch_sentence_embeddings(sd, captions, cap_lens)
    delta = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)) + 1e-12)
    results.check(
        "sentence embeddings (the port's RNNEncoder vs the packed-LSTM "
        "reference)", delta < max(TOL_SENT_ABS, 1e-4 * scale),
        f"max|delta|={delta:.3e} over {captions.shape[0]} unsorted-length "
        f"captions (scale {scale:.3f}, tol {TOL_SENT_ABS}) on {device}")


def validate_metrics(results: Results, inception_path: str,
                     fake: np.ndarray, real: np.ndarray,
                     device: torch.device) -> None:
    sd = torch.load(inception_path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items()
          if "AuxLogits" not in k and "num_batches_tracked" not in k}
    params = inception_to(load_torch_inception(inception_path), device)
    is_port = metrics.compute_inception_score(params, fake, batch_size=8,
                                              splits=1)
    fid_port = metrics.compute_fid(params, real, fake, batch_size=8)
    is_ref, fid_ref = torch_is_fid(sd, fake, real)

    d_is = abs(is_port - is_ref)
    results.check("Inception Score (the port's pipeline vs the reference)",
                  d_is <= TOL_IS_REL * max(is_ref, 1.0),
                  f"port={is_port:.5f} ref={is_ref:.5f} |delta|={d_is:.3e} "
                  f"(tol {TOL_IS_REL * 100:.0f}%) on {device}")
    d_fid = abs(fid_port - fid_ref)
    results.check("FID (the port's pipeline vs the reference)",
                  d_fid <= max(TOL_FID_ABS, 0.01 * abs(fid_ref)),
                  f"port={fid_port:.5f} ref={fid_ref:.5f} "
                  f"|delta|={d_fid:.3e} (tol {TOL_FID_ABS} abs / 1% rel; "
                  f"the north-star budget is +-2) on {device}")


def validate_weights_dir(results: Results, weights_dir: str,
                         device: torch.device, n: int = 4) -> None:
    """A port weights dir's newest `gen_N.pth` through the port's
    generator on `device` against the reference forward of the same
    state_dict on the CPU, at its config.json."""
    name = "weights-dir generator vs the reference forward"
    cfg_path = os.path.join(weights_dir, "config.json")
    if not os.path.exists(cfg_path):
        results.check(name, False, f"{cfg_path} missing")
        return
    with open(cfg_path) as f:
        cfg = GANConfig.from_dict(json.load(f))
    try:
        path, epoch = latest_generator_weights(weights_dir)
    except FileNotFoundError as e:
        results.check(name, False, str(e))
        return
    generator, gcfg = load_generator(path, cfg.generator)
    sd = torch_load_ref(path)

    g = np.random.default_rng(0)
    noise = g.standard_normal((n, gcfg.latent_dim), dtype=np.float32)
    sent = g.standard_normal((n, gcfg.sentence_dim), dtype=np.float32)
    with torch.no_grad():
        want = sd_generator_forward(sd, gcfg, torch.from_numpy(noise),
                                    torch.from_numpy(sent))
    with torch.inference_mode():
        got = generator.to(device)(torch.from_numpy(noise).to(device),
                                   torch.from_numpy(sent).to(device))
    delta = float((got.float().cpu() - want.permute(0, 2, 3, 1))
                  .abs().max())
    results.check(name, delta < TOL_GEN_ABS,
                  f"gen_{epoch}.pth ({gcfg.image_size}px, n_channels "
                  f"{gcfg.n_channels}) on {device}: max|delta|={delta:.3e} "
                  f"(tol {TOL_GEN_ABS})")


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def load_cub_inputs(cub_dir: str, n_images: int):
    """Real CUB test-split images (the reference's eval inputs: bbox crop,
    76/64 resize, center crop, [-1,1]) and their captions."""
    from ..data.dataset import CUBDataset
    from ..data.loader import DataLoader

    ds = CUBDataset(DataConfig(data_dir=cub_dir, image_size=256), "test",
                    augment=False)
    batch = next(iter(DataLoader(ds, batch_size=n_images, shuffle=False,
                                 drop_last=False)))
    images = np.asarray(batch["images"]).astype(np.float32)
    if images.max() > 1.5:  # uint8 payload
        images = images / 127.5 - 1.0
    return (images[:n_images], np.asarray(batch["captions"])[:n_images],
            np.asarray(batch["cap_lens"])[:n_images])


def synthetic_inputs(n_images: int, vocab: int, max_len: int = 18):
    rng = np.random.RandomState(123321)
    images = rng.uniform(-1, 1, (n_images, 64, 64, 3)).astype(np.float32)
    lens = rng.randint(1, max_len + 1, size=n_images).astype(np.int32)
    caps = rng.randint(1, vocab, size=(n_images, max_len)).astype(np.int32)
    for i, l in enumerate(lens):
        caps[i, l:] = 0
    return images, caps, lens


def make_self_test_assets(out_dir: str) -> Tuple[str, str]:
    """Seeded random weights in the on-disk formats of the real files (a
    DAMSM-shaped `text_encoder.pth`, a torchvision-layout InceptionV3
    state_dict), so --self-test runs every load path."""
    os.makedirs(out_dir, exist_ok=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        emb = torch.nn.Embedding(200, 300)
        lstm = torch.nn.LSTM(300, 128, 1, batch_first=True,
                             bidirectional=True)
    te_sd = {"encoder.weight": emb.weight.detach()}
    te_sd.update({f"rnn.{k}": v.detach()
                  for k, v in lstm.named_parameters()})
    te_path = os.path.join(out_dir, "text_encoder.pth")
    torch.save(te_sd, te_path)
    inc_path = os.path.join(out_dir, "inception_v3.pth")
    torch.save(random_torchvision_state_dict(
        torch.Generator().manual_seed(1)), inc_path)
    return te_path, inc_path


def print_north_star_procedure() -> None:
    print("""
================== FID-parity north star: matched-steps run ==================
With the real files in hand (every check above green), the +-2 FID
comparison at matched steps is:

1. Reference leg (PyTorch): run `src/train.py` with its shipped
   hyperparameters (256px, batch 24, seed 123321, 600 epochs) on the CUB
   dir and the pretrained DAMSM text_encoder.pth; it logs per-epoch FID.
2. The port, at the same operating point, on one card:
     python -m gan_codes_tpu_torch.train_entry --data <CUB_DIR> \\
         --text-encoder <text_encoder.pth> --inception <inception_v3.pth> \\
         --image-size 256 --batch-size 24 --epochs 600 --seed 123321 \\
         --images out/images --weights out/weights
   (fp32 with TF32 off replicates the reference's math; the same text
   encoder and Inception weights make the conditioning and the metric
   the same.)
3. Compare fid_scores at equal epoch indices (both evaluate the first 32
   test batches each epoch): |FID_port - FID_ref| must stay within +-2
   once both runs are past early-training noise. The port's histories are
   in out/weights/histories.json and metrics_log.jsonl, the reference's
   in its checkpoint.pt.
==============================================================================""")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--text-encoder", help="pretrained DAMSM text_encoder.pth")
    ap.add_argument("--inception",
                    help="torchvision inception_v3 state_dict (.pth)")
    ap.add_argument("--cub-dir", help="real CUB data dir (optional)")
    ap.add_argument("--n-images", type=int, default=64)
    ap.add_argument("--self-test", action="store_true",
                    help="prove the harness on schema-correct random weights")
    ap.add_argument("--check-weights", metavar="WEIGHTS_DIR",
                    help="hold WEIGHTS_DIR's newest generator against the "
                         "reference forward of its state_dict")
    ap.add_argument("--device", default="cuda",
                    help="the port's leg: cuda (default; raises without a "
                         "card) or cpu")
    args = ap.parse_args(argv)
    device = serving_device(args.device)
    results = Results()

    if args.check_weights:
        validate_weights_dir(results, args.check_weights, device)
        if not (args.text_encoder or args.inception or args.self_test):
            print("\n" + results.summary())
            return 1 if results.failed() else 0

    if args.self_test:
        tmp = tempfile.mkdtemp(prefix="validate_pretrained_")
        print(f"--self-test: writing schema-correct random assets to {tmp}")
        args.text_encoder, args.inception = make_self_test_assets(tmp)
    if not args.text_encoder or not args.inception:
        ap.error("--text-encoder and --inception are required "
                 "(or --self-test / --check-weights)")

    te_sd = torch.load(args.text_encoder, map_location="cpu",
                       weights_only=True)
    vocab = int(te_sd["encoder.weight"].shape[0])
    if args.cub_dir:
        images, caps, lens = load_cub_inputs(args.cub_dir, args.n_images)
        print(f"Inputs: {images.shape[0]} real CUB test images + captions")
    else:
        images, caps, lens = synthetic_inputs(args.n_images, vocab)
        print(f"Inputs: {images.shape[0]} seeded synthetic images + captions "
              "(pass --cub-dir to use real eval inputs)")

    validate_text_encoder(results, args.text_encoder, caps, lens, device)
    # fake / real: disjoint halves of the set (the content does not matter
    # to the graph-parity question; both legs see the same arrays)
    half = images.shape[0] // 2
    validate_metrics(results, args.inception, images[:half], images[half:],
                     device)

    failed = results.failed()
    print("\n" + results.summary() + ("" if failed else
          " - the eval graph is numerically interchangeable with the "
          "reference's."))
    if not failed:
        print_north_star_procedure()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
