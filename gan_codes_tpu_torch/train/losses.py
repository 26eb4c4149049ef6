"""Loss functions: hinge adversarial + mismatch, MA-GP, DAMSM cosine, and the
NaN guard (the port of `gan_codes_tpu/train/losses.py`).

Reference trainer `src/deep_fusion_gan/model.py:59-85,99-104,173-231` and
`src/damsm/loss.py:4-25`. Each D loss takes the `Discriminator` module; its
embeds and logits stay two calls so the mismatch term reuses the real
embeds. Images are NHWC.

Data parallelism (`parallel/dp.py`): given `count`, the global batch, each
loss is this rank's share of the global loss: its sums over the rank's
rows divided by the global count (the mismatch term's by count - 1), so
the ranks' shares, and their gradients, add up to the loss of the global
batch and its gradient (where JAX's GSPMD step places its psums). Without
`count` each loss is the mean over the batch given, as before.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..config import LossConfig
from ..models.discriminator import Discriminator


def _mean(x: torch.Tensor, count: Optional[int]) -> torch.Tensor:
    """mean(x), or this rank's share of the mean over `count` rows."""
    return x.mean() if count is None else x.sum() / count


def d_hinge_loss(d: Discriminator, real_images: torch.Tensor,
                 fake_images: torch.Tensor,
                 sentence_embeds: torch.Tensor,
                 count: Optional[int] = None,
                 next_sentence: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Matching-aware hinge loss for D (`model.py:173-189`).

    d_loss = mean(relu(1 - logit(real, sent)))
           + (mean(relu(1 + logit(fake, sent))) + mean(relu(1 + mismatch))) / 2
    where mismatch pairs real-image embed i with sentence i+1. As in the JAX
    package, the real and fake embeds run as one [2B] forward and the three
    logit heads as one [3B-1] forward. `fake_images` must be detached.

    Under data parallelism (`count` given) the pairs run over the global
    batch: `next_sentence` [1, D] is the next rank's first sentence, which
    this rank's last real image pairs with (None on the last rank)."""
    b = real_images.shape[0]
    embeds = d.embeds(torch.cat([real_images, fake_images], dim=0))
    mismatch_sents = (sentence_embeds[1:b] if next_sentence is None
                      else torch.cat([sentence_embeds[1:b], next_sentence]))
    emb_cat = torch.cat([embeds, embeds[:mismatch_sents.shape[0]]], dim=0)
    sent_cat = torch.cat([sentence_embeds, sentence_embeds,
                          mismatch_sents], dim=0)
    logits = d.logits(emb_cat, sent_cat)
    loss_real = _mean(F.relu(1.0 - logits[:b]), count)
    loss_fake = _mean(F.relu(1.0 + logits[b:2 * b]), count)
    loss_mismatch = _mean(F.relu(1.0 + logits[2 * b:]),
                          None if count is None else count - 1)
    return loss_real + (loss_fake + loss_mismatch) / 2.0


def ma_gradient_penalty(d: Discriminator, real_images: torch.Tensor,
                        sentence_embeds: torch.Tensor,
                        cfg: LossConfig,
                        count: Optional[int] = None) -> torch.Tensor:
    """Matching-aware gradient penalty (`model.py:59-85,202-203`).

    grads = d(sum logits)/d(real_images, sentence_embeds), taken with
    `create_graph=True` so the penalty backpropagates into D's parameters (a
    double backward through every D conv); per-sample norm
    sqrt(sum g^2 + eps) in fp32, clamped to [0, clip];
    penalty = coef * mean(norm^power)."""
    images = real_images.detach().requires_grad_(True)
    sents = sentence_embeds.detach().requires_grad_(True)
    logits = d.logits(d.embeds(images), sents)
    g_img, g_sent = torch.autograd.grad(logits.sum(), (images, sents),
                                        create_graph=True)
    b = images.shape[0]
    flat = torch.cat([g_img.reshape(b, -1), g_sent.reshape(b, -1)],
                     dim=1).float()
    norm = torch.sqrt((flat ** 2).sum(dim=1) + cfg.gp_eps)
    norm = torch.clamp(norm, 0.0, cfg.gp_norm_clip)
    return cfg.gp_coef * _mean(norm ** cfg.gp_power, count)


def g_hinge_loss(d: Discriminator, fake_images: torch.Tensor,
                 sentence_embeds: torch.Tensor,
                 count: Optional[int] = None) -> torch.Tensor:
    """Generator adversarial loss: -mean(logit(fake, sent))
    (`model.py:215-217`)."""
    return -_mean(d.logits(d.embeds(fake_images), sentence_embeds), count)


def damsm_cosine_loss(fake_images: torch.Tensor,
                      sentence_embeds: torch.Tensor,
                      count: Optional[int] = None) -> torch.Tensor:
    """Simplified DAMSM text-image alignment loss (`src/damsm/loss.py:4-25`).

    The image's per-channel mean [B, 3] is embedded into the sentence space
    by the reference's fixed `F.linear(img_feat, eye(256, 3))`, i.e. padded
    with zeros to the sentence width; the loss is 1 - mean cosine
    similarity (`F.normalize` with eps 1e-12 on both sides)."""
    img_feat = fake_images.mean(dim=(1, 2))
    padded = F.pad(img_feat,
                   (0, sentence_embeds.shape[-1] - img_feat.shape[-1]))
    scores = (F.normalize(padded, dim=1, eps=1e-12)
              * F.normalize(sentence_embeds, dim=1, eps=1e-12)).sum(dim=1)
    if count is None:
        return 1.0 - scores.mean()
    return (1.0 - scores).sum() / count  # the shares add up to 1 - mean


def nan_guard_loss(loss: torch.Tensor, rng: torch.Generator) -> torch.Tensor:
    """Reference `_check_nan` (`model.py:99-104`): a NaN/Inf loss is
    replaced with `0.01 * randn()`. The draw is made every call, so the
    stream does not depend on the data, and no value leaves the device."""
    fallback = 0.01 * torch.randn((), generator=rng, device=loss.device,
                                  dtype=loss.dtype)
    return torch.where(torch.isfinite(loss), loss, fallback)


def zero_grads_if_nonfinite(loss: torch.Tensor,
                            grads: Sequence[torch.Tensor]
                            ) -> List[torch.Tensor]:
    """Zero every gradient when the loss is non-finite (the gradient of the
    reference's replaced constant loss is exactly zero)."""
    finite = torch.isfinite(loss)
    return [torch.where(finite, g, 0.0) for g in grads]
