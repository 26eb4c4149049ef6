"""DF-GAN in plain PyTorch (Tao et al., CVPR 2022, as the reference
repository's `src/` trains it): the biLSTM text encoder, the one-stage
generator, the matching-aware discriminator, and the three-phase train
step with MA-GP, the global-norm clip, Adam and the EMA.

Written from the equations, NCHW, with `torch.nn.functional` only; the
weights are reference-named state_dicts (`weights.py`). fp32; the caller
sets the precision (TF32 off for the reference itself).

Departures from the reference repository, each the port's behaviour too
(the JAX package's semantics that the port follows):
- Adam's update follows optax's chain: a global-norm clip that scales by
  max_norm / norm when norm >= max_norm (torch's `clip_grad_norm_` adds
  1e-6), then Adam with betas (0.0, 0.9);
- the step's random numbers come from one generator: the noise [B, 100]
  at the step's start, then one scalar after each phase (the NaN guard's
  fallback draw), in that order;
- the DAMSM loss has weight 0 (the reference only logs it), so it is not
  computed.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
SLOPE = 0.2


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, SLOPE)


# -- text encoder -------------------------------------------------------------

def text_encode(p: Params, caps: torch.Tensor, lens: torch.Tensor
                ) -> torch.Tensor:
    """captions [B, T] (ids), lengths [B] -> sentences [B, 2H]: the final
    hidden states of a bidirectional LSTM over each caption's first
    `len` words (gates i, f, g, o)."""
    emb = F.embedding(caps.long(), p["encoder.weight"])
    b, t, _ = emb.shape
    valid = (torch.arange(t, device=caps.device)[None, :]
             < lens.to(caps.device)[:, None])

    def run(sfx: str, steps: Sequence[int]) -> torch.Tensor:
        w_hh = p[f"rnn.weight_hh_l0{sfx}"]
        xw = F.linear(emb, p[f"rnn.weight_ih_l0{sfx}"],
                      p[f"rnn.bias_ih_l0{sfx}"] + p[f"rnn.bias_hh_l0{sfx}"])
        h = emb.new_zeros((b, w_hh.shape[1]))
        c = torch.zeros_like(h)
        for s in steps:
            i, f, g, o = (xw[:, s] + F.linear(h, w_hh)).chunk(4, dim=1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            m = valid[:, s, None]
            h, c = torch.where(m, h_new, h), torch.where(m, c_new, c)
        return h

    return torch.cat([run("", range(t)), run("_reverse", range(t - 1, -1, -1))],
                     dim=1)


# -- generator ----------------------------------------------------------------

def _mlp(p: Params, pre: str, s: torch.Tensor) -> torch.Tensor:
    h = F.relu(F.linear(s, p[pre + ".0.weight"], p[pre + ".0.bias"]))
    return F.linear(h, p[pre + ".2.weight"], p[pre + ".2.bias"])


def _affine(p: Params, pre: str, x: torch.Tensor, s: torch.Tensor
            ) -> torch.Tensor:
    gamma = _mlp(p, pre + ".gamma_mlp", s)[:, :, None, None]
    beta = _mlp(p, pre + ".beta_mlp", s)[:, :, None, None]
    return gamma * x + beta


def _g_block(p: Params, pre: str, x: torch.Tensor, s: torch.Tensor
             ) -> torch.Tensor:
    h = lrelu(_affine(p, pre + ".fusion_block_1", x, s))
    h = lrelu(_affine(p, pre + ".fusion_block_2", h, s))
    h = F.conv2d(h, p[pre + ".conv_1.weight"], p[pre + ".conv_1.bias"],
                 padding=1)
    h = lrelu(_affine(p, pre + ".fusion_block_3", h, s))
    h = lrelu(_affine(p, pre + ".fusion_block_4", h, s))
    h = F.conv2d(h, p[pre + ".conv_2.weight"], p[pre + ".conv_2.bias"],
                 padding=1)
    sc = x
    if pre + ".scale_conv.weight" in p:
        sc = F.conv2d(x, p[pre + ".scale_conv.weight"],
                      p[pre + ".scale_conv.bias"])
    return sc + p[pre + ".gamma"] * h


def generator(p: Params, noise: torch.Tensor, s: torch.Tensor
              ) -> torch.Tensor:
    """noise [B, Z], sentences [B, S] -> images [B, 3, H, W] in [-1, 1]:
    a 4 x 4 seed, then residual DF blocks each after a nearest 2x
    upsample (the first at 4 x 4), LeakyReLU, a 3x3 conv, tanh."""
    w_in = p["linear_in.weight"]
    seed_c = p["res_blocks.0.conv_1.weight"].shape[1]
    base = int(math.isqrt(w_in.shape[0] // seed_c))
    x = F.linear(noise, w_in, p["linear_in.bias"]).view(
        noise.shape[0], seed_c, base, base)
    n_mid = len({k.split(".")[1] for k in p if k.startswith("res_blocks.")})
    blocks = [f"res_blocks.{i}" for i in range(n_mid)] + ["res_block_out"]
    for i, pre in enumerate(blocks):
        if i:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = _g_block(p, pre, x, s)
    return torch.tanh(F.conv2d(lrelu(x), p["conv_out.1.weight"],
                               p["conv_out.1.bias"], padding=1))


# -- discriminator --------------------------------------------------------------

def d_embeds(p: Params, x: torch.Tensor) -> torch.Tensor:
    """images [B, 3, H, W] -> embeds [B, C, 4, 4]."""
    x = F.conv2d(x, p["img_forward.0.weight"], p["img_forward.0.bias"],
                 padding=1)
    i = 1
    while f"img_forward.{i}.gamma" in p:
        pre = f"img_forward.{i}"
        h = lrelu(F.conv2d(x, p[pre + ".residual_conv.0.weight"], stride=2,
                           padding=1))
        h = lrelu(F.conv2d(h, p[pre + ".residual_conv.2.weight"], padding=1))
        sc = x
        if pre + ".scale_conv.weight" in p:
            sc = F.conv2d(x, p[pre + ".scale_conv.weight"],
                          p[pre + ".scale_conv.bias"])
        x = F.avg_pool2d(sc, 2) + p[pre + ".gamma"] * h
        i += 1
    return x


def d_logits(p: Params, emb: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(embeds [B, C, 4, 4], sentences [B, S]) -> logits [B]."""
    tiled = s[:, :, None, None].expand(-1, -1, emb.shape[2], emb.shape[3])
    h = lrelu(F.conv2d(torch.cat([emb, tiled], dim=1),
                       p["img_sentence_forward.0.weight"], padding=1))
    return F.conv2d(h, p["img_sentence_forward.2.weight"]).reshape(-1)


# -- the train step -----------------------------------------------------------

def _grads(loss: torch.Tensor, params: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(q) if g is None else g
            for q, g in zip(params, gs)]


class Adam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr, b1, b2, eps)),
    in place on `params`."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float,
                 b2: float, eps: float, max_norm: float):
        self.params, self.lr, self.b1, self.b2 = params, lr, b1, b2
        self.eps, self.max_norm = eps, max_norm
        self.m = [torch.zeros_like(q) for q in params]
        self.v = [torch.zeros_like(q) for q in params]
        self.t = 0
        self.first = None  # the clipped gradients of the first update
        self.last = None   # and of the last
        self.norms = []   # each update's clipped gradient norms, by leaf

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = 1.0 if norm < self.max_norm else float(self.max_norm / norm)
        grads = [g * scale for g in grads]
        if self.first is None:
            self.first = grads
        self.norms.append(torch.stack([g.double().norm() for g in grads]))
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for q, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            q.sub_(self.lr / bc1 * m / (v.sqrt() / math.sqrt(bc2)
                                        + self.eps))
        self.last = grads


class TrainState:
    """G, D and the EMA generator as leaf tensors, the two optimizers and
    the step's random generator."""

    def __init__(self, cfg: dict, g: Params, d: Params, te: Params,
                 rng: torch.Generator):
        o = cfg["optim"]
        self.cfg, self.te, self.rng = cfg, te, rng
        self.g = {k: v.clone().requires_grad_(True) for k, v in g.items()}
        self.d = {k: v.clone().requires_grad_(True) for k, v in d.items()}
        self.ema = {k: v.clone() for k, v in g.items()}
        betas = (o["beta1"], o["beta2"], o["eps"])
        self.g_opt = Adam(list(self.g.values()), o["g_lr"], *betas,
                          o["grad_clip_g"])
        self.d_opt = Adam(list(self.d.values()), o["d_lr"], *betas,
                          o["grad_clip_d"])


def train_step(st: TrainState, images: torch.Tensor, caps: torch.Tensor,
               lens: torch.Tensor, batch_fraction: float = 1.0
               ) -> Dict[str, float]:
    """One step on images [B, 3, H, W] in [-1, 1]; updates `st` in place
    and returns the three losses. `batch_fraction` < 1 keeps only that
    share of the rows after the draws (a planted fault, for the control
    readings)."""
    cfg, lc = st.cfg, st.cfg["loss"]
    b = images.shape[0]
    z = cfg["generator"]["latent_dim"]
    with torch.no_grad():
        sents = text_encode(st.te, caps, lens)
    noise = torch.randn((b, z), generator=st.rng, device=images.device)
    if batch_fraction < 1.0:
        keep = max(2, int(b * batch_fraction))
        images, sents, noise, b = images[:keep], sents[:keep], \
            noise[:keep], keep
    g_params, d_params = list(st.g.values()), list(st.d.values())
    fake = generator(st.g, noise, sents)

    def guard_draw():  # the NaN guard's fallback draw, made every phase
        torch.randn((), generator=st.rng, device=images.device)

    # phase 1: hinge on real, fake and mismatched (real i, sentence i+1)
    emb = d_embeds(st.d, torch.cat([images, fake.detach()]))
    real_l = d_logits(st.d, emb[:b], sents)
    fake_l = d_logits(st.d, emb[b:], sents)
    mis_l = d_logits(st.d, emb[:b - 1], sents[1:])
    d_loss = F.relu(1.0 - real_l).mean() + (
        F.relu(1.0 + fake_l).mean() + F.relu(1.0 + mis_l).mean()) / 2.0
    st.d_opt.step(_grads(d_loss, d_params))
    guard_draw()

    # phase 2: MA-GP with the D that phase 1 left
    x = images.detach().requires_grad_(True)
    s = sents.detach().requires_grad_(True)
    out = d_logits(st.d, d_embeds(st.d, x), s)
    gx, gs = torch.autograd.grad(out.sum(), (x, s), create_graph=True)
    flat = torch.cat([gx.reshape(b, -1), gs.reshape(b, -1)], dim=1)
    norm = torch.sqrt((flat ** 2).sum(dim=1) + lc["gp_eps"]).clamp(
        0.0, lc["gp_norm_clip"])
    gp = lc["gp_coef"] * (norm ** lc["gp_power"]).mean()
    st.d_opt.step(_grads(gp, d_params))
    guard_draw()

    # phase 3: G against the D that phase 2 left, on the same fakes
    g_loss = -d_logits(st.d, d_embeds(st.d, fake), sents).mean()
    st.g_opt.step(_grads(g_loss, g_params))
    guard_draw()
    decay = cfg["train"]["ema_decay"]
    with torch.no_grad():
        for k, v in st.g.items():
            st.ema[k].mul_(decay).add_(v * (1.0 - decay))
    return {"d_loss": d_loss.item(), "d_gp_loss": gp.item(),
            "g_loss": g_loss.item()}
