"""The 3-phase GAN train step (the port of `gan_codes_tpu/train/step.py`).

Reference semantics (`src/deep_fusion_gan/model.py:163-231`), as the JAX
package's `make_train_step` reproduces them: each batch runs (1) a D hinge
step with the shift-by-one mismatch term on detached fakes, (2) a second D
step on the MA-GP penalty computed with the post-phase-1 D, then (3) a G
step whose D forward uses the post-phase-2 D and the same fake images. The
DAMSM cosine loss is computed and logged each step with weight
`cfg.loss.damsm_weight` (0.0 by default, the reference's logged-only quirk).

One G forward per step, as in the JAX package (`step.py:119-124,193-195`):
its graph is kept, phases 1 and 2 see it detached, and phase 3 takes the
gradient of its loss with respect to the fake images alone (no D parameter
gradient is formed), then runs G's backward from that gradient. D is
updated in place between the phases; G's graph holds nothing of D's. G's
backward runs through the kernels' backward: K2's (the conv's input
gradient, K1 bwd, which also rebuilds the modulation for the conv's weight
gradient) and K1 bwd, on every DFBlock.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..config import GANConfig
from . import losses
from .state import TrainState, ema_update

Metrics = Dict[str, torch.Tensor]


def _grads(out: torch.Tensor, params: Sequence[torch.Tensor],
           grad_out: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """d out / d params (weighted by grad_out), zeros where a parameter does
    not reach `out` (the MA-GP gradient does not depend on D's conv
    biases)."""
    grads = torch.autograd.grad(out, params, grad_out, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def make_train_step(cfg: GANConfig) -> Callable[..., Metrics]:
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
    float32 scalars on the device, with the JAX package's keys."""
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

    def guard(loss, grads, rng):
        """Reference `_check_nan` semantics on a (loss, grads) pair."""
        if not loss_cfg.nan_guard:
            return loss, grads
        return (losses.nan_guard_loss(loss, rng),
                losses.zero_grads_if_nonfinite(loss, grads))

    def step(state: TrainState, text_encoder: torch.nn.Module,
             images: torch.Tensor, captions: torch.Tensor,
             cap_lens: torch.Tensor,
             noise: Optional[torch.Tensor] = None) -> Metrics:
        g, d = state.generator, state.discriminator
        g_params = list(g.parameters())
        d_params = list(d.parameters())
        batch = images.shape[0]

        with torch.no_grad():  # frozen text encoder (`model.py:171`)
            sents = text_encoder(captions, cap_lens).float()
        if noise is None:
            noise = torch.randn((batch, gen_cfg.latent_dim),
                                generator=state.rng, device=images.device)
        images_c = images.to(cdtype)
        sents_c = sents.to(cdtype)

        # One G forward for the whole step; its graph is kept for phase 3.
        fake = g(noise.to(cdtype), sents_c)
        fake_detached = fake.detach()

        # ---- Phase 1: D hinge (adversarial + mismatch) ----
        d_loss = losses.d_hinge_loss(d, images_c, fake_detached,
                                     sents_c).float()
        d_loss, d_grads = guard(d_loss, _grads(d_loss, d_params), state.rng)
        state.d_opt.step(d_grads)

        # ---- Phase 2: MA-GP on the post-phase-1 D (`model.py:200-210`) ----
        gp_active = state.step % k_interval == 0
        if gp_active:
            gp_loss = losses.ma_gradient_penalty(
                d, images.to(gp_dtype), sents.to(gp_dtype), gp_cfg)
            gp_loss, gp_grads = guard(gp_loss, _grads(gp_loss, d_params),
                                      state.rng)
            state.d_opt.step(gp_grads)
        else:
            gp_loss = torch.zeros((), device=images.device)

        # ---- Phase 3: G step against the post-phase-2 D ----
        fake_in = fake_detached.requires_grad_(True)
        g_adv = losses.g_hinge_loss(d, fake_in, sents_c).float()
        txtimg = losses.damsm_cosine_loss(fake_in.float(), sents).float()
        g_total = g_adv + loss_cfg.damsm_weight * txtimg
        (d_fake,) = torch.autograd.grad(g_total, fake_in)
        g_grads = _grads(fake, g_params, d_fake.to(fake.dtype))
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
            "d_gp_active": torch.full((), float(gp_active),
                                      device=images.device),
            "g_loss": g_adv.detach(),
            "txtimg_loss": txtimg.detach(),
        }

    return step
