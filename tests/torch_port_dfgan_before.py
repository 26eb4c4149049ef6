"""DF-GAN's train step as the port had it before GALIP's step joined it
(`train/step.py`'s `make_train_step` and `train/losses.py`'s
`d_hinge_loss` and `ma_gradient_penalty`, verbatim), the oracle that
tests/test_torch_port_galip.py holds the refactored step to, bit for bit.
The helpers the refactor left unchanged are imported. One line is not
verbatim: `ma_gradient_penalty` runs D with `penalty=True`, as the step
does since its convs take `ops_nn.PenaltyConv2d` there (another order of
the weight terms' sums); tests/test_torch_port_penalty_conv.py holds that
conv against autograd's own double backward."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from gan_codes_tpu_torch.config import GANConfig, LossConfig
from gan_codes_tpu_torch.models.discriminator import Discriminator
from gan_codes_tpu_torch.parallel.mesh import Mesh
from gan_codes_tpu_torch.train import losses
from gan_codes_tpu_torch.train.losses import _mean
from gan_codes_tpu_torch.train.state import TrainState, ema_update
from gan_codes_tpu_torch.train.step import (Metrics, _grads, _next_sentence,
                                            _raise_on_nan, _sum_over_ranks)
from gan_codes_tpu_torch.utils.profiling import span


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
    logits = d.logits(d.embeds(images, penalty=True), sents, penalty=True)
    g_img, g_sent = torch.autograd.grad(logits.sum(), (images, sents),
                                        create_graph=True)
    b = images.shape[0]
    flat = torch.cat([g_img.reshape(b, -1), g_sent.reshape(b, -1)],
                     dim=1).float()
    norm = torch.sqrt((flat ** 2).sum(dim=1) + cfg.gp_eps)
    norm = torch.clamp(norm, 0.0, cfg.gp_norm_clip)
    return cfg.gp_coef * _mean(norm ** cfg.gp_power, count)


def make_train_step(cfg: GANConfig, mesh: Optional[Mesh] = None,
                    debug_nans: bool = False) -> Callable[..., Metrics]:
    """Build `step(state, text_encoder, images, captions, cap_lens,
    noise=None) -> metrics`.

    The step updates `state` in place: both modules, the EMA generator, the
    optimizers, `state.step` and `state.rng`. After it, each parameter's
    `.grad` holds the clipped gradient of its last update (phase 3 for G,
    phase 2, or phase 1 on a step without the penalty, for D).

    images [B, H, W, 3] in [-1, 1] (NHWC) and captions [B, T] on the
    state's device, cap_lens [B] there or on the CPU (the LSTM packs with
    lengths on the CPU, so CPU lengths spare a device sync); `text_encoder`
    maps (captions, cap_lens) to
    sentence embeddings and is frozen. `noise` [B, latent_dim] is drawn
    from `state.rng` when not given (the tests pass it to replay the JAX
    package's draw). `cfg.train.compute_dtype` "bfloat16" runs G and D in
    bf16 with fp32 parameters and optimizer state;
    `cfg.loss.gp_compute_dtype` sets the penalty's D forward. Metrics are
    float32 scalars on the device, with the JAX package's keys.

    With `mesh` the step is data-parallel: the batch tensors are this
    rank's rows (every rank the same count), `noise`, when given, its rows
    of the global noise, and the metrics are the global batch's, the same
    on every rank. A mesh of one process without a group computes the
    same forms with no collective. `debug_nans`: the module docstring's
    checks, each raising `FloatingPointError`."""
    gen_cfg, loss_cfg = cfg.generator, cfg.loss
    cdtype = cfg.train.compute_torch_dtype
    gp_dtype = (torch.bfloat16 if loss_cfg.gp_compute_dtype == "bfloat16"
                else torch.float32)
    ema_decay = cfg.train.ema_decay
    # Lazy regularization (LossConfig.gp_interval = k): the penalty phase
    # runs every k-th step with its coefficient scaled by k; the logged
    # value is divided by k again (`step.py:84-90,164-173,217-234`).
    k_interval = loss_cfg.gp_interval
    gp_cfg = (loss_cfg if k_interval == 1 else dataclasses.replace(
        loss_cfg, gp_coef=loss_cfg.gp_coef * k_interval))

    def reduce(grads, *terms):
        if mesh is None:
            return grads, terms
        return _sum_over_ranks(mesh, grads, *terms)

    def guard(loss, grads, rng):
        """Reference `_check_nan` semantics on a (loss, grads) pair."""
        if not loss_cfg.nan_guard:
            return loss, grads
        return (losses.nan_guard_loss(loss, rng),
                losses.zero_grads_if_nonfinite(loss, grads))

    def check(phase, loss_name, loss, grads, names):
        if debug_nans:
            _raise_on_nan(phase, [(loss_name, loss)] + list(zip(names,
                                                                grads)))

    def step(state: TrainState, text_encoder: torch.nn.Module,
             images: torch.Tensor, captions: torch.Tensor,
             cap_lens: torch.Tensor,
             noise: Optional[torch.Tensor] = None) -> Metrics:
        dev = images.device
        with span("step.g_forward", dev):
            g, d = state.generator, state.discriminator
            g_names, g_params = zip(*g.named_parameters())
            d_names, d_params = zip(*d.named_parameters())
            batch = images.shape[0]

            # the global batch under data parallelism, else None (plain means)
            count = None if mesh is None else batch * mesh.world
            with torch.no_grad():  # frozen text encoder (`model.py:171`)
                sents = text_encoder(captions, cap_lens).float()
            if noise is None:
                noise = torch.randn((count or batch, gen_cfg.latent_dim),
                                    generator=state.rng, device=dev)
                if mesh is not None:  # this rank's rows of the global draw
                    noise = noise[mesh.rank * batch:(mesh.rank + 1) * batch]
            next_sent = None if mesh is None else _next_sentence(mesh, sents)
            images_c = images.to(cdtype)
            sents_c = sents.to(cdtype)

            # One G forward for the whole step; its graph is kept for phase 3.
            fake = g(noise.to(cdtype), sents_c)
            fake_detached = fake.detach()
            if debug_nans:
                _raise_on_nan("G forward", [("fake images", fake_detached)])

        # ---- Phase 1: D hinge (adversarial + mismatch) ----
        with span("step.d_hinge", dev):
            d_loss = d_hinge_loss(
                d, images_c, fake_detached, sents_c, count,
                None if next_sent is None else next_sent.to(cdtype)).float()
            d_grads, (d_loss,) = reduce(_grads(d_loss, d_params), d_loss)
            check("phase 1 (D hinge)", "d_loss", d_loss, d_grads, d_names)
            d_loss, d_grads = guard(d_loss, d_grads, state.rng)
            state.d_opt.step(d_grads)

        # ---- Phase 2: MA-GP on the post-phase-1 D (`model.py:200-210`) ----
        gp_active = state.step % k_interval == 0
        if gp_active:
            with span("step.magp", dev):
                gp_loss = ma_gradient_penalty(
                    d, images.to(gp_dtype), sents.to(gp_dtype), gp_cfg,
                    count)
                gp_grads, (gp_loss,) = reduce(_grads(gp_loss, d_params),
                                              gp_loss)
                check("phase 2 (MA-GP)", "gp_loss", gp_loss, gp_grads,
                      d_names)
                gp_loss, gp_grads = guard(gp_loss, gp_grads, state.rng)
                state.d_opt.step(gp_grads)

        # ---- Phase 3: G step against the post-phase-2 D ----
        with span("step.g_hinge", dev):
            if not gp_active:
                gp_loss = torch.zeros((), device=dev)
            fake_in = fake_detached.requires_grad_(True)
            g_adv = losses.g_hinge_loss(d, fake_in, sents_c, count).float()
            txtimg = losses.damsm_cosine_loss(fake_in.float(), sents,
                                              count).float()
            g_total = g_adv + loss_cfg.damsm_weight * txtimg
            (d_fake,) = torch.autograd.grad(g_total, fake_in)
            g_grads, (g_total, g_adv, txtimg) = reduce(
                _grads(fake, g_params, d_fake.to(fake.dtype)),
                g_total, g_adv, txtimg)
            check("phase 3 (G hinge)", "g_loss", g_total, g_grads, g_names)
            if loss_cfg.nan_guard:
                # keyed on the loss actually differentiated (`step.py:196-201`)
                g_grads = losses.zero_grads_if_nonfinite(g_total, g_grads)
                g_adv = losses.nan_guard_loss(g_adv, state.rng)
            state.g_opt.step(g_grads)
            ema_update(state.g_ema, g, ema_decay)
            state.step += 1

            return {
                "d_loss": d_loss.detach(),
                "d_gp_loss": gp_loss.detach() / k_interval,
                "d_gp_active": torch.full((), float(gp_active), device=dev),
                "g_loss": g_adv.detach(),
                "txtimg_loss": txtimg.detach(),
            }

    return step
