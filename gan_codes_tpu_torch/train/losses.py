"""Loss functions: hinge adversarial + mismatch, MA-GP, DAMSM cosine, and the
NaN guard (the port of `gan_codes_tpu/train/losses.py`), and GALIP's D and
G losses on CLIP features (`galip_d_loss`, `galip_g_loss`).

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
    return hinge_terms(logits[:b], logits[b:2 * b], logits[2 * b:], count,
                       None if count is None else count - 1)


def hinge_terms(real: torch.Tensor, fake: torch.Tensor,
                mismatch: torch.Tensor, count: Optional[int] = None,
                mismatch_count: Optional[int] = None) -> torch.Tensor:
    """mean(relu(1 - real)) + (mean(relu(1 + fake)) + mean(relu(1 +
    mismatch))) / 2 from the three logits, each mean this rank's share
    over its `count` (DF-GAN's mismatch pairs B - 1 rows, GALIP's rolled
    one B)."""
    loss_real = _mean(F.relu(1.0 - real), count)
    loss_fake = _mean(F.relu(1.0 + fake), count)
    loss_mismatch = _mean(F.relu(1.0 + mismatch), mismatch_count)
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
    return penalty(g_img, g_sent, cfg.gp_coef, cfg.gp_power, cfg.gp_eps,
                   cfg.gp_norm_clip, count)


def penalty(g_a: torch.Tensor, g_b: torch.Tensor, coef: float, power: int,
            eps: float = 0.0, clip: Optional[float] = None,
            count: Optional[int] = None) -> torch.Tensor:
    """coef * mean(norm^power) of the per-sample norm of the two input
    gradients flattened together, sqrt(sum g^2 + eps) in fp32, clamped to
    [0, clip] where a clip is given (DF-GAN's MA-GP; GALIP's has neither
    eps nor clamp)."""
    b = g_a.shape[0]
    flat = torch.cat([g_a.reshape(b, -1), g_b.reshape(b, -1)],
                     dim=1).float()
    norm = torch.sqrt((flat ** 2).sum(dim=1) + eps)
    if clip is not None:
        norm = torch.clamp(norm, 0.0, clip)
    return coef * _mean(norm ** power, count)


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


def galip_d_loss(d, real_feats: torch.Tensor, fake_feats: torch.Tensor,
                 sentence_embeds: torch.Tensor,
                 mismatch_sents: torch.Tensor, gp_coef: float,
                 gp_power: int, count: Optional[int] = None):
    """GALIP's D loss, one update (`lib/modules.py::train`): (total,
    hinge, penalty). `d` is `models/galip.py::GALIPDiscriminator`; the
    features are the CLIP visual tower's local features [B, L, g, g, W]
    of the real and the (detached) fake images; `mismatch_sents` is the
    sentence batch rolled by one (row i holds sentence i + 1, the last
    row the first: across the ranks under data parallelism).

    p_r = C(D(F_r), s); the hinge pairs F_r with s (real), the fakes with
    s and F_r with the rolled sentences (mismatch); the MA-GP is
    coef * mean(||[dp_r/dF_r, dp_r/ds]||^power), taken with
    `create_graph=True` with respect to the features and the sentence (not
    the pixels: its double backward runs through NetD and NetC alone).
    The real pass runs alone, so the penalty's backward covers only it;
    the fake and mismatched logits share one NetC call."""
    feats = real_feats.detach().requires_grad_(True)
    sents = sentence_embeds.detach().requires_grad_(True)
    b = feats.shape[0]
    h_real = d.netD(feats)
    p_real = d.netC(h_real, sents)
    h_fake = d.netD(fake_feats.detach())
    p_other = d.netC(torch.cat([h_fake, h_real]),
                     torch.cat([sentence_embeds, mismatch_sents]))
    g_f, g_s = torch.autograd.grad(p_real.sum(), (feats, sents),
                                   create_graph=True)
    hinge = hinge_terms(p_real, p_other[:b], p_other[b:], count, count)
    gp = penalty(g_f, g_s, gp_coef, gp_power, count=count)
    return hinge + gp, hinge, gp


def galip_g_loss(d, clip, fake_images: torch.Tensor,
                 sentence_embeds: torch.Tensor, sim_weight: float,
                 layers, count: Optional[int] = None):
    """GALIP's G loss: (total, adversarial, similarity) with total =
    -mean C(D(F_fake), s) - sim_weight * mean cos(global_fake, s), both
    from one CLIP encode of the fakes (`clip.encode_image`)."""
    local, glob = clip.encode_image(fake_images, layers)
    adv = -_mean(d.logits(local, sentence_embeds), count)
    sim = _mean(F.cosine_similarity(glob.float(), sentence_embeds.float(),
                                    dim=1), count)
    return adv - sim_weight * sim, adv, sim


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
