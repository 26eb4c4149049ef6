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

Data parallelism (`mesh` given; `parallel/dp.py`): each rank takes its rows
of the global batch, and the step equals the single-process step on the
global batch up to the order of its sums, as JAX's GSPMD step does. Each
loss is the rank's share of the global loss (`losses.py`), the mismatch
term pairs the rank's last real image with the next rank's first sentence,
and each phase's gradients are summed over the ranks in one flat
collective that also carries the phase's loss terms: the NaN guard then
reads the global loss, so every rank takes the same branch and draws the
same fallback. The noise is drawn at the global batch from the replicated
`state.rng` and each rank takes its rows, so the generator's stream moves
as on one process. The reduced gradients are the same bits on every rank,
so clip, Adam and the EMA keep the ranks in lockstep bit for bit.
`DistributedDataParallel` would do neither: it averages per-rank losses,
which drops a mismatch pair at every rank boundary, and it does not reduce
gradients taken with `torch.autograd.grad`, as every gradient here is.

`debug_nans` (`--debug-nans`; JAX: `jax_debug_nans`) fails fast: the step
checks the G forward's images, then each phase's loss and gradients (after
the reduction over ranks, before the NaN guard could hide them), and
raises `FloatingPointError` naming the phase and the first tensor that
holds a NaN. It costs one host sync a check, so it is off by default.

Under a torch profiler the step's parts are spans (`utils/profiling.py::
span`), each timed on the device: `step.g_forward` (the text encoder, the
noise and G's forward), `step.d_hinge` (phase 1), `step.magp` (phase 2,
on the steps that run it) and `step.g_hinge` (phase 3, the EMA and the
metrics). They tile the step; without a profiler each costs one check of
its flag.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..config import GANConfig, is_galip
from ..parallel.mesh import Mesh, all_reduce
from ..utils.profiling import span
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


def _sum_over_ranks(mesh: Mesh, grads: List[torch.Tensor],
                    *terms: torch.Tensor):
    """Sum gradients and loss terms over the ranks in one collective (one
    flat float32 buffer); returns (grads, terms), the terms detached."""
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [t.detach().float().reshape(1) for t in terms])
    with span("dp.all_reduce", flat.device):
        all_reduce(mesh, flat)
    parts = flat.split([g.numel() for g in grads] + [1] * len(terms))
    return ([p.view_as(g) for p, g in zip(parts, grads)],
            [p.reshape(()) for p in parts[len(grads):]])


def _next_sentence(mesh: Mesh, sents: torch.Tensor, wrap: bool = False
                   ) -> Optional[torch.Tensor]:
    """The next rank's first sentence embed [1, D] (None on the last
    rank, or with `wrap` rank 0's): each rank writes its first row into a
    zeroed [world, D] buffer, summed over the ranks."""
    rows = torch.zeros((mesh.world, sents.shape[1]), dtype=sents.dtype,
                       device=sents.device)
    rows[mesh.rank] = sents[0]
    all_reduce(mesh, rows)
    nxt = mesh.rank + 1
    if wrap:
        nxt %= mesh.world
    return rows[nxt:nxt + 1] if nxt < mesh.world else None


def _raise_on_nan(phase: str, named) -> None:
    """Raise FloatingPointError naming the first of `named` ((name,
    tensor) pairs) that holds a NaN: one host sync for all of them."""
    names = [n for n, _ in named]
    flags = torch.stack([torch.isnan(t).any() for _, t in named]).cpu()
    if flags.any():
        bad = names[int(flags.nonzero()[0])]
        raise FloatingPointError(f"NaN in the train step's {phase}: {bad} "
                                 "(--debug-nans)")


def _phase_tools(loss_cfg, mesh: Optional[Mesh], debug_nans: bool):
    """What every phase of a step does with its loss and gradients:
    `reduce` (the sum over the ranks), `guard` (the NaN guard) and `check`
    (`debug_nans`)."""
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

    return reduce, guard, check


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
    if is_galip(cfg):
        return make_galip_step(cfg, mesh, debug_nans)
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
    reduce, guard, check = _phase_tools(loss_cfg, mesh, debug_nans)

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
            d_loss = losses.d_hinge_loss(
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
                gp_loss = losses.ma_gradient_penalty(
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


def make_galip_step(cfg, mesh: Optional[Mesh] = None,
                    debug_nans: bool = False) -> Callable[..., Metrics]:
    """GALIP's step (`lib/modules.py::train`), with the same signature as
    DF-GAN's: `step(state, clip, images, captions, cap_lens, noise=None)`,
    `clip` the frozen CLIP (`models/clip.py`) in the text encoder's place.

    One G forward (the text tower's sentence s under no_grad, the noise,
    G with its mapper), then one D update on L_D = hinge + MA-GP over the
    CLIP local features of the real and the detached fake images (both
    encoded without a graph; `losses.galip_d_loss`; the mismatch pairs
    image i with sentence i + 1, rolled), then one G update on L_G =
    -mean C(D(F_fake), s) - sim_weight mean cos(global_fake, s) against
    the updated D: the fakes are encoded again with a graph, the gradient
    of L_G is taken with respect to them, and G's backward runs from it
    (through the kernels and the mapper). No gradient clip; the EMA and
    the NaN guard as in DF-GAN's step. The step's random draws: the noise,
    then one scalar after each update (the guard's).

    Spans (under a profiler): `step.g_forward`, `step.d_loss` (D's update)
    and `step.g_hinge` (G's update and the EMA) tile the step; inside
    them `clip.text`, `clip.image` and `galip.mapper`. Metrics: `d_loss`
    (L_D), `d_gp_loss` (its MA-GP), `g_loss` (L_G) and `txtimg_loss`
    (1 - the mean cosine), float32 on the device. Data
    parallelism, `debug_nans` and the guard work as in DF-GAN's step."""
    if cfg.train.compute_dtype != "float32":
        raise ValueError("GALIP trains in float32 (one TF32 pass with "
                         "--matmul-precision high), not "
                         f"{cfg.train.compute_dtype}")
    loss_cfg, layers = cfg.loss, tuple(cfg.discriminator.local_layers)
    latent, ema_decay = cfg.generator.latent_dim, cfg.train.ema_decay
    reduce, guard, check = _phase_tools(loss_cfg, mesh, debug_nans)

    def step(state: TrainState, clip: torch.nn.Module,
             images: torch.Tensor, captions: torch.Tensor,
             cap_lens: torch.Tensor,
             noise: Optional[torch.Tensor] = None) -> Metrics:
        dev = images.device
        with span("step.g_forward", dev):
            g, d = state.generator, state.discriminator
            g_names, g_params = zip(*g.named_parameters())
            d_names, d_params = zip(*d.named_parameters())
            batch = images.shape[0]
            count = None if mesh is None else batch * mesh.world
            with torch.no_grad():
                sents = clip(captions, cap_lens).float()
            if noise is None:
                noise = torch.randn((count or batch, latent),
                                    generator=state.rng, device=dev)
                if mesh is not None:
                    noise = noise[mesh.rank * batch:(mesh.rank + 1) * batch]
            nxt = sents[:1] if mesh is None \
                else _next_sentence(mesh, sents, wrap=True)
            mismatch = torch.cat([sents[1:], nxt])
            fake = g(noise, sents)
            fake_detached = fake.detach()
            if debug_nans:
                _raise_on_nan("G forward", [("fake images", fake_detached)])

        with span("step.d_loss", dev):
            with torch.no_grad():
                real_feats = clip.encode_image(images, layers)[0]
                fake_feats = clip.encode_image(fake_detached, layers)[0]
            d_loss, _, gp_loss = losses.galip_d_loss(
                d, real_feats, fake_feats, sents, mismatch,
                loss_cfg.gp_coef, loss_cfg.gp_power, count)
            d_grads, (d_loss, gp_loss) = reduce(_grads(d_loss, d_params),
                                                d_loss, gp_loss)
            check("D (hinge + MA-GP)", "d_loss", d_loss, d_grads, d_names)
            d_loss, d_grads = guard(d_loss, d_grads, state.rng)
            state.d_opt.step(d_grads)

        with span("step.g_hinge", dev):
            fake_in = fake_detached.requires_grad_(True)
            g_total, g_adv, sim = losses.galip_g_loss(
                d, clip, fake_in, sents, loss_cfg.sim_weight, layers, count)
            (d_fake,) = torch.autograd.grad(g_total, fake_in)
            g_grads, (g_total, g_adv, sim) = reduce(
                _grads(fake, g_params, d_fake), g_total, g_adv, sim)
            check("G (hinge + CLIP similarity)", "g_loss", g_total, g_grads,
                  g_names)
            if loss_cfg.nan_guard:
                g_grads = losses.zero_grads_if_nonfinite(g_total, g_grads)
                g_total = losses.nan_guard_loss(g_total, state.rng)
            state.g_opt.step(g_grads)
            ema_update(state.g_ema, g, ema_decay)
            state.step += 1
            return {"d_loss": d_loss.detach(),
                    "d_gp_loss": gp_loss.detach(),
                    "g_loss": g_total.detach(),
                    "txtimg_loss": 1.0 - sim.detach()}

    return step
