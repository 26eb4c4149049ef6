"""Inception Score and FID (the port of `gan_codes_tpu/eval/metrics.py`).

Capability parity with `src/evaluation/metrics.py:7-118`: one resident
InceptionV3 (`models/inception.py`) instead of the reference's two
re-instantiations per epoch; the images and the network stay on their
device, and only the softmax rows and pool features come back to the host,
where the statistics are numpy float64; the same numerical safety (NaN
scrub of the inputs, logits clamped to +-50, an epsilon'd log in IS, IS
1.0 / FID inf on failure).

FID's cross term: the exact low-rank Gram path (`sqrtm_trace_lowrank`)
whenever both sides carry their activations and the smaller side has at
most 2048 samples (every per-epoch eval), else scipy's `sqrtm` on the host
(the reference's path) or Newton-Schulz in float64 on the network's device.

Data parallelism: each rank scores its shard of the eval set, and
`compute_is_fid_multihost` sums the shards' float64 moments over the ranks
(`allreduce_moments`, one all-reduce), so the scores cover the union and
are the same on every rank; only the covariances are known there, and the
cross term is `sqrtm_trace_psd` (exact at any sample count). The card has float64, so the JAX package's
hi/lo float32 split for the TPU is not needed.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import inception as inception_lib
from ..parallel.mesh import Mesh, all_reduce

INCEPTION_SIZE = 299


def _preprocess(images: torch.Tensor) -> torch.Tensor:
    """[-1,1] NHWC any size -> [0,1] 299x299 (reference `metrics.py:26-28`).

    Bilinear with half-pixel centres and antialiasing, as
    `jax.image.resize` samples (a triangle filter widened by the scale on
    a downsampling, weights renormalized at the borders). On an upsampling
    (every configuration: 32-256 px) that is plain bilinear up to rounding;
    on a downsampling plain bilinear would miss JAX's filter."""
    images = torch.nan_to_num(images, nan=0.0, posinf=1.0, neginf=-1.0)
    images = torch.clamp((images + 1.0) / 2.0, 0.0, 1.0)
    x = F.interpolate(images.permute(0, 3, 1, 2),
                      size=(INCEPTION_SIZE, INCEPTION_SIZE), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def _logits_batch(params, images: torch.Tensor) -> torch.Tensor:
    logits = inception_lib.inception_logits(params, _preprocess(images))
    logits = torch.clamp(logits, -50.0, 50.0)  # reference `metrics.py:33`
    return torch.softmax(logits, dim=1)


def _features_batch(params, images: torch.Tensor) -> torch.Tensor:
    return inception_lib.inception_features(params, _preprocess(images))


def _batched(fn: Callable, params, images, batch_size: int) -> np.ndarray:
    """fn over batches of `batch_size` images (the last one shorter) on the
    params' device; one copy of the results to the host at the end.
    `images` is a tensor on any device or a numpy array."""
    device = inception_lib.params_device(params)
    images = torch.as_tensor(images)
    n = images.shape[0]
    with torch.inference_mode():  # an empty set runs once: [0, width]
        outs = [fn(params, images[i:i + batch_size].to(device, torch.float32))
                for i in range(0, max(n, 1), batch_size)]
        return torch.cat(outs).cpu().numpy()


def compute_inception_score(inception_params, images, batch_size: int = 8,
                            splits: int = 1) -> float:
    """IS over [-1,1] NHWC images (reference `metrics.py:7-60`)."""
    try:
        n = images.shape[0]
        preds = _batched(_logits_batch, inception_params, images, batch_size)
        preds = np.nan_to_num(preds, nan=1.0 / 1000, posinf=1.0 / 1000,
                              neginf=1.0 / 1000)
        split_scores = []
        for k in range(splits):
            part = preds[k * (n // splits): (k + 1) * (n // splits)]
            py = np.mean(part, axis=0) + 1e-10
            kl = np.sum((part + 1e-10) * (np.log(part + 1e-10) - np.log(py)),
                        axis=1)
            split_scores.append(np.exp(np.mean(kl)))
        return float(np.mean(split_scores))
    except Exception as e:  # reference returns baseline 1.0 on failure
        print(f"Error in IS calculation: {e}")
        return 1.0


def sqrtm_trace_newton_schulz(a: torch.Tensor,
                              num_iters: int = 50) -> torch.Tensor:
    """trace(sqrtm(A)) by the Newton-Schulz iteration, on A's device.

    A must be (numerically) PSD; pass float64 (the card has it, so the
    JAX package's fp32 / 100-iteration TPU variant is not needed)."""
    dim = a.shape[0]
    norm = torch.sqrt(torch.sum(a * a))
    y = a / norm
    eye = torch.eye(dim, dtype=a.dtype, device=a.device)
    z = eye
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return torch.trace(y) * torch.sqrt(norm)


def sqrtm_trace_lowrank(acts1: np.ndarray, acts2: np.ndarray) -> float:
    """Exact trace(sqrtm(sigma1 @ sigma2)) by the Gram trick, for
    covariances of fewer samples than features.

    `acts_i` are centered activations scaled by 1/sqrt(n_i - 1) (rows =
    samples), so sigma_i = acts_iᵀ @ acts_i. The nonzero eigenvalues of
    sigma1 @ sigma2 equal those of C @ Cᵀ with C = acts1 @ acts2ᵀ, a small
    symmetric PSD matrix, so the cross term is one eigvalsh instead of a
    2048² matrix square root."""
    c = acts1 @ acts2.T
    g = c @ c.T if c.shape[0] <= c.shape[1] else c.T @ c
    w = np.linalg.eigvalsh(g)
    return float(np.sqrt(np.clip(w, 0.0, None)).sum())


def sqrtm_trace_psd(sigma1: np.ndarray, sigma2: np.ndarray,
                    device: str | torch.device = "cpu") -> float:
    """Exact trace(sqrtm(sigma1 @ sigma2)) of two covariances, in float64
    on `device`, when only the covariances are known (summed moments).

    With sigma1 = U diag(w) Uᵀ and W = diag(sqrt(w)), the trace is that of
    sqrtm(A), A = W Uᵀ sigma2 U W, a symmetric PSD matrix: one eigh and one
    eigvalsh. A covariance of n samples has rank n - 1 at most; sigma1's
    eigenvalues within rounding of 0 are dropped, so they add no square
    root of rounding noise."""
    s1 = torch.as_tensor(sigma1, dtype=torch.float64, device=device)
    s2 = torch.as_tensor(sigma2, dtype=torch.float64, device=device)
    w, u = torch.linalg.eigh(s1)
    keep = w > w.max() * w.shape[0] * torch.finfo(torch.float64).eps
    uw = u[:, keep] * w[keep].sqrt()
    ev = torch.linalg.eigvalsh(uw.T @ s2 @ uw)
    return float(ev.clamp_min(0.0).sqrt().sum())


def _frechet_distance(mu1, sigma1, mu2, sigma2, use_scipy: bool = True,
                      device: str | torch.device = "cpu") -> float:
    """FID from two (mu, sigma); without scipy the cross term runs
    Newton-Schulz in float64 on `device`."""
    diff = mu1 - mu2
    if use_scipy:
        from scipy import linalg

        covmean = linalg.sqrtm(sigma1 @ sigma2)
        if np.iscomplexobj(covmean):
            covmean = covmean.real
        tr_covmean = np.trace(covmean)
    else:
        tr_covmean = float(sqrtm_trace_newton_schulz(torch.as_tensor(
            sigma1 @ sigma2, dtype=torch.float64, device=device)))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * tr_covmean)


def activation_stats(inception_params, images, batch_size: int = 8,
                     return_acts: bool = False):
    """(mu, sigma[, acts]) of the pool features over a [-1,1] NHWC set.

    A caller with a fixed comparison set (the deterministic test split)
    computes the real side once and passes it to compute_fid(real_stats=
    ...). `return_acts=True` also returns the centered activations scaled
    by 1/sqrt(n-1) (sigma == actsᵀ @ acts), which unlocks compute_fid's
    exact low-rank cross term."""
    act = _batched(_features_batch, inception_params, images,
                   batch_size).astype(np.float64)
    if np.isnan(act).any():
        raise FloatingPointError("activations contain NaN values")
    if act.shape[0] < 2:
        # covariance (ddof=1) is undefined for one sample: raise what
        # compute_fid maps to the inf sentinel, not a 0/0 NaN score
        raise FloatingPointError(
            f"FID statistics need >=2 samples, got {act.shape[0]}")
    mu = act.mean(axis=0)
    centered = (act - mu) / np.sqrt(float(act.shape[0] - 1))
    sigma = centered.T @ centered  # == np.cov(act, rowvar=False), ddof=1
    if return_acts:
        return mu, sigma, centered
    return mu, sigma


def compute_fid(inception_params, real_images, fake_images,
                batch_size: int = 8, use_scipy_sqrtm: bool = True,
                real_stats: Optional[Tuple[np.ndarray, ...]] = None
                ) -> float:
    """FID over [-1,1] NHWC image sets (reference `metrics.py:62-118`).

    `real_stats`: precomputed (mu, sigma) or (mu, sigma, acts) of the real
    side (from activation_stats); `real_images` may then be None. The
    low-rank cross term runs when both sides carry their activations and
    the smaller side has at most as many samples as features; otherwise
    `use_scipy_sqrtm` picks scipy or Newton-Schulz."""
    try:
        if real_stats is None:
            real_stats = activation_stats(inception_params, real_images,
                                          batch_size, return_acts=True)
        mu1, sigma1, *rest = real_stats
        acts1 = rest[0] if rest else None
        mu2, sigma2, acts2 = activation_stats(inception_params, fake_images,
                                              batch_size, return_acts=True)
        if (acts1 is not None
                and min(acts1.shape[0], acts2.shape[0]) <= mu1.shape[0]):
            diff = mu1 - mu2
            tr_covmean = sqrtm_trace_lowrank(acts1, acts2)
            return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                         - 2.0 * tr_covmean)
        return _frechet_distance(
            mu1, sigma1, mu2, sigma2, use_scipy_sqrtm,
            device=inception_lib.params_device(inception_params))
    except FloatingPointError:
        print("Warning: Activations contain NaN values")
        return float("inf")
    except Exception as e:
        print(f"Error in FID calculation: {e}")
        return float("inf")


# ---------------------------------------------------------------------------
# Summable statistics for the cross-process eval: IS at splits=1 and FID
# are functions of per-sample sums, so a shard's moments add up to the
# statistics of the union.
# ---------------------------------------------------------------------------

def activation_moments(inception_params, images,
                       batch_size: int = 8) -> dict:
    """Summable pool-feature statistics of an image shard: {sum [2048],
    outer [2048, 2048], n, nan}; summed over shards, `stats_from_moments`
    gives `activation_stats`'s (mu, sigma) over their union."""
    act = _batched(_features_batch, inception_params, images,
                   batch_size).astype(np.float64)
    nan = np.float64(np.isnan(act).any())
    act = np.nan_to_num(act)  # keeps a reduced payload finite
    return {"sum": act.sum(axis=0), "outer": act.T @ act,
            "n": np.float64(act.shape[0]), "nan": nan}


def stats_from_moments(m: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) from summed activation moments (ddof=1, as
    `activation_stats`)."""
    n = m["n"]
    mu = m["sum"] / n
    sigma = (m["outer"] - n * np.outer(mu, mu)) / (n - 1.0)
    return mu, sigma


def is_moments(inception_params, images, batch_size: int = 8) -> dict:
    """Summable Inception-Score statistics of a shard (splits=1):
    {sum_p [n_classes], sum_plogp, n}. With py = sum_p/n + eps the mean KL
    is sum_plogp/n - sum(py*log(py)), `compute_inception_score`'s mean with
    the same 1e-10 epsilons."""
    preds = _batched(_logits_batch, inception_params, images, batch_size)
    preds = np.nan_to_num(preds, nan=1.0 / 1000, posinf=1.0 / 1000,
                          neginf=1.0 / 1000).astype(np.float64)
    sum_plogp = np.sum((preds + 1e-10) * np.log(preds + 1e-10))
    return {"sum_p": preds.sum(axis=0), "sum_plogp": np.float64(sum_plogp),
            "n": np.float64(preds.shape[0])}


def is_from_moments(m: dict) -> float:
    try:
        if m["n"] < 1:
            # 0/0 below would be a NaN with a numpy warning, not an
            # exception: force the reference failure sentinel instead
            raise ValueError("empty eval union (n=0 across all shards)")
        py = m["sum_p"] / m["n"] + 1e-10
        mean_kl = m["sum_plogp"] / m["n"] - np.sum(py * np.log(py))
        return float(np.exp(mean_kl))
    except Exception as e:  # reference failure sentinel (`metrics.py:58-60`)
        print(f"Error in IS calculation: {e}")
        return 1.0


def allreduce_moments(mesh: Optional[Mesh], tree: dict) -> dict:
    """Sum every leaf of a nested dict of float64 moments over the ranks:
    one all-reduce of the leaves as one float64 tensor on the rank's
    device. Collective: every rank calls it with the same structure. The
    identity without a group."""
    if mesh is None or not mesh.distributed:
        return tree

    def leaves(t, path=()):
        for k in sorted(t):
            if isinstance(t[k], dict):
                yield from leaves(t[k], path + (k,))
            else:
                yield path + (k,), np.asarray(t[k], np.float64)

    items = list(leaves(tree))
    flat = torch.cat([torch.from_numpy(v).reshape(-1) for _, v in items])
    host = all_reduce(mesh, flat.to(mesh.device)).cpu().numpy()
    out: dict = {}
    offset = 0
    for path, v in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        part = host[offset:offset + v.size].reshape(v.shape)
        node[path[-1]] = np.float64(part) if v.ndim == 0 else part
        offset += v.size
    return out


def compute_is_fid_multihost(mesh: Optional[Mesh], inception_params,
                             fake_images, real_images=None,
                             real_moments: Optional[dict] = None,
                             batch_size: int = 8
                             ) -> Tuple[float, float]:
    """IS and FID over eval shards spread across the ranks.

    `fake_images` and `real_images` are this rank's shards (either may be
    empty); the scores cover their union and are the same on every rank.
    Pass `real_moments` (`activation_moments` of this rank's reals) to
    reuse a cached real side; every rank must make the same choice. A NaN
    in any shard travels as a summed flag, so nothing raises between the
    moments and the collective; the failure sentinels are IS 1.0 and FID
    inf, as in `compute_is_fid`. The cross term is `sqrtm_trace_psd`,
    exact at any sample count (so `TrainConfig.eval_sqrtm` does not apply
    here)."""
    local = {"fake_is": is_moments(inception_params, fake_images,
                                   batch_size),
             "fake_act": activation_moments(inception_params, fake_images,
                                            batch_size)}
    if real_moments is None:
        real_moments = activation_moments(inception_params, real_images,
                                          batch_size)
    local["real_act"] = real_moments
    reduced = allreduce_moments(mesh, local)

    is_score = is_from_moments(reduced["fake_is"])
    device = inception_lib.params_device(inception_params)
    try:
        real, fake = reduced["real_act"], reduced["fake_act"]
        if fake["nan"] > 0 or real["nan"] > 0:
            raise FloatingPointError("activations contain NaN values")
        if fake["n"] < 2 or real["n"] < 2:
            # stats_from_moments divides by n - 1: raise what maps to the
            # inf sentinel, not a NaN score
            raise ValueError("FID needs >=2 samples per side across shards")
        mu1, sigma1 = stats_from_moments(real)
        mu2, sigma2 = stats_from_moments(fake)
        diff = mu1 - mu2
        fid = float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                    - 2.0 * sqrtm_trace_psd(sigma1, sigma2, device))
    except FloatingPointError:
        print("Warning: Activations contain NaN values")
        fid = float("inf")
    except Exception as e:
        print(f"Error in FID calculation: {e}")
        fid = float("inf")
    return is_score, fid


def compute_is_fid(inception_params, fake_images, real_images,
                   batch_size: int = 8, splits: int = 1,
                   real_stats: Optional[Tuple[np.ndarray, ...]] = None,
                   use_scipy_sqrtm: bool = True) -> Tuple[float, float]:
    """IS and FID of one fake set, the reference's pairing
    (`deep_fusion_gan/model.py:91-97`)."""
    is_score = compute_inception_score(inception_params, fake_images,
                                       batch_size, splits)
    fid = compute_fid(inception_params, real_images, fake_images, batch_size,
                      real_stats=real_stats, use_scipy_sqrtm=use_scipy_sqrtm)
    return is_score, fid
