"""GALIP in plain PyTorch (Tao et al., CVPR 2023; github.com/tobran/GALIP
`models/GALIP.py`, `lib/modules.py`) on CLIP ViT-B/32 (openai/CLIP
`clip/model.py`): the CLIP towers, NetG with its adapter and mapper,
NetD, NetC, and the train step (one D update on hinge + MA-GP over the
CLIP features, one G update on the hinge and the CLIP similarity, Adam,
the EMA).

Written from the equations, NCHW, with `torch.nn.functional` only (the
attention a softmax of scaled products); the weights are the state_dicts
of `weights_galip.py`. fp32; the caller sets the precision (TF32 off for
the reference itself). Imports nothing of the program.

Departures from GALIP's code, each the port's behaviour too:
- the image goes to CLIP as ((img / 2 + 1 / 2) resized nearest - mean) /
  std (GALIP's `transf_to_CLIP_input` adds a second (x + 1) / 2);
- G keeps an EMA copy (decay from the configuration);
- the step's random numbers come from one generator: the noise at the
  step's start, then one scalar after D's update and one after G's (the
  NaN guard's fallback draws).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .data import CubReference

Params = Dict[str, torch.Tensor]
SLOPE = 0.2
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, SLOPE)


def vision_heads(ct: dict) -> int:
    """The visual tower's heads: 64 wide (OpenAI's `build_model`)."""
    return max(1, ct["vision_width"] // 64)


# -- CLIP ---------------------------------------------------------------------

def _ln(p: Params, pre: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[pre + ".weight"], p[pre + ".bias"],
                        1e-5)


def block(p: Params, pre: str, x: torch.Tensor, heads: int,
          causal: bool = False) -> torch.Tensor:
    """One pre-LN residual attention block on x [B, T, W]."""
    b, t, w = x.shape
    d = w // heads
    h = _ln(p, pre + ".ln_1", x)
    qkv = F.linear(h, p[pre + ".attn.in_proj_weight"],
                   p[pre + ".attn.in_proj_bias"])
    q, k, v = (z.reshape(b, t, heads, d).transpose(1, 2)
               for z in qkv.split(w, dim=-1))
    s = q @ k.transpose(-1, -2) / math.sqrt(d)
    if causal:
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool,
                                     device=x.device).triu(1), float("-inf"))
    a = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, t, w)
    x = x + F.linear(a, p[pre + ".attn.out_proj.weight"],
                     p[pre + ".attn.out_proj.bias"])
    h = F.linear(_ln(p, pre + ".ln_2", x), p[pre + ".mlp.c_fc.weight"],
                 p[pre + ".mlp.c_fc.bias"])
    h = h * torch.sigmoid(1.702 * h)
    return x + F.linear(h, p[pre + ".mlp.c_proj.weight"],
                        p[pre + ".mlp.c_proj.bias"])


def _layers(p: Params, pre: str) -> int:
    n = 0
    while f"{pre}.{n}.ln_1.weight" in p:
        n += 1
    return n


def encode_text(p: Params, ids: torch.Tensor, heads: int) -> torch.Tensor:
    """ids [B, T] -> sentences [B, E]: the end-of-text row (argmax id)."""
    x = F.embedding(ids.long(), p["token_embedding.weight"]) \
        + p["positional_embedding"][:ids.shape[1]]
    for i in range(_layers(p, "transformer.resblocks")):
        x = block(p, f"transformer.resblocks.{i}", x, heads, causal=True)
    x = _ln(p, "ln_final", x)
    return x[torch.arange(x.shape[0]), ids.argmax(dim=-1)] \
        @ p["text_projection"]


def _tokens(p: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, W, g, g] -> [B, g*g + 1, W]: class token, positions, ln_pre."""
    b, w = x.shape[:2]
    x = x.reshape(b, w, -1).transpose(1, 2)
    cls = p["visual.class_embedding"].expand(b, 1, w)
    return _ln(p, "visual.ln_pre", torch.cat([cls, x], dim=1)
               + p["visual.positional_embedding"])


def encode_image(p: Params, img: torch.Tensor, heads: int,
                 layers: Sequence[int] = (1, 4, 8)
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """img [B, 3, H, W] in [-1, 1] -> (local [B, L, W, g, g], global
    [B, E])."""
    w_conv = p["visual.conv1.weight"]
    patch = w_conv.shape[-1]
    g = int(math.isqrt(p["visual.positional_embedding"].shape[0] - 1))
    mean = torch.tensor(MEAN, device=img.device)[:, None, None]
    std = torch.tensor(STD, device=img.device)[:, None, None]
    x = F.interpolate(img * 0.5 + 0.5, size=(g * patch, g * patch),
                      mode="nearest")
    x = F.conv2d((x - mean) / std, w_conv, stride=patch)
    x = _tokens(p, x)
    local = []
    for i in range(_layers(p, "visual.transformer.resblocks")):
        x = block(p, f"visual.transformer.resblocks.{i}", x, heads)
        if i in layers:
            local.append(x[:, 1:].transpose(1, 2).reshape(
                x.shape[0], -1, g, g))
    glob = _ln(p, "visual.ln_post", x[:, 0]) @ p["visual.proj"]
    return torch.stack(local, dim=1), glob


def mapper(p: Params, f: torch.Tensor, prompts: torch.Tensor, heads: int
           ) -> torch.Tensor:
    """f [B, W, g, g], prompts [B, P, W] -> [B, W, g, g]: the visual
    blocks on f's tokens, prompt k appended before block k + 1."""
    b, w, g, _ = f.shape
    x = _tokens(p, f)
    n = x.shape[1]
    for i in range(_layers(p, "visual.transformer.resblocks")):
        pre = f"visual.transformer.resblocks.{i}"
        if 1 <= i <= prompts.shape[1]:
            x = block(p, pre, torch.cat([x, prompts[:, i - 1:i]], dim=1),
                      heads)[:, :n]
        else:
            x = block(p, pre, x, heads)
    return x[:, 1:].transpose(1, 2).reshape(b, w, g, g)


# -- NetG ---------------------------------------------------------------------

def _mlp(p: Params, pre: str, c: torch.Tensor) -> torch.Tensor:
    h = F.relu(F.linear(c, p[pre + ".linear1.weight"],
                        p[pre + ".linear1.bias"]))
    return F.linear(h, p[pre + ".linear2.weight"], p[pre + ".linear2.bias"])


def dfblk(p: Params, pre: str, x: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    for a in ("affine0", "affine1"):
        gamma = _mlp(p, f"{pre}.{a}.fc_gamma", c)[:, :, None, None]
        beta = _mlp(p, f"{pre}.{a}.fc_beta", c)[:, :, None, None]
        x = lrelu(gamma * x + beta)
    return x


def _conv(p: Params, pre: str, x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.conv2d(x, p[pre + ".weight"], p.get(pre + ".bias"), padding=pad)


def generator(pg: Params, pc: Params, noise: torch.Tensor, s: torch.Tensor,
              cfg: dict) -> torch.Tensor:
    """noise [B, Z], sentences [B, S] -> images [B, 3, H, W] in [-1, 1]."""
    g, ct = cfg["generator"], cfg["text_encoder"]
    b = noise.shape[0]
    c = torch.cat([noise, s], dim=1)
    grid = ct["image_resolution"] // ct["vision_patch_size"]
    x = F.linear(noise, pg["fc_code.weight"], pg["fc_code.bias"]).view(
        b, g["code_ch"], grid, grid)
    for i in range(g["n_mblocks"]):
        pre = f"mapping.FBlocks.{i}"
        h = dfblk(pg, pre + ".fuse1", _conv(pg, pre + ".conv1", x, 1), c)
        h = dfblk(pg, pre + ".fuse2", _conv(pg, pre + ".conv2", h, 1), c)
        sc = _conv(pg, pre + ".c_sc", x, 0) if pre + ".c_sc.weight" in pg \
            else x
        x = sc + h
    f = _conv(pg, "mapping.conv_fuse", x, 2)
    prompts = F.linear(c, pg["mapping.fc_prompt.weight"],
                       pg["mapping.fc_prompt.bias"]).view(
        b, g["n_prompts"], ct["vision_width"])
    m = mapper(pc, f, prompts, vision_heads(ct))
    x = _conv(pg, "mapping.conv", f + 0.1 * m, 2)
    i = 0
    size = 8
    while f"GBlocks.{i}.c1.weight" in pg:
        pre = f"GBlocks.{i}"
        last = f"GBlocks.{i + 1}.c1.weight" not in pg
        x = F.interpolate(x, size=(g["image_size"],) * 2 if last
                          else (size, size), mode="nearest")
        r = _conv(pg, pre + ".c1", dfblk(pg, pre + ".fuse1", x, c), 1)
        r = _conv(pg, pre + ".c2", dfblk(pg, pre + ".fuse2", r, c), 1)
        sc = _conv(pg, pre + ".c_sc", x, 0) if pre + ".c_sc.weight" in pg \
            else x
        x = sc + r
        size *= 2
        i += 1
    return torch.tanh(_conv(pg, "to_rgb.1", lrelu(x), 1))


# -- NetD, NetC ---------------------------------------------------------------

def _d_block(p: Params, pre: str, x: torch.Tensor,
             feat: torch.Tensor = None) -> torch.Tensor:
    r = lrelu(F.conv2d(x, p[pre + ".conv_r.0.weight"], padding=1))
    r = lrelu(F.conv2d(r, p[pre + ".conv_r.2.weight"], padding=1))
    if p[pre + ".conv_r.0.weight"].shape[0] != x.shape[1]:
        x = F.conv2d(x, p[pre + ".conv_s.weight"], p[pre + ".conv_s.bias"])
    out = x + p[pre + ".gamma"] * r
    if feat is not None:
        out = out + p[pre + ".beta"] * feat
    return out


def net_d(p: Params, feats: torch.Tensor) -> torch.Tensor:
    """feats [B, L, W, g, g] -> [B, 8 nf, g, g]."""
    out = feats[:, 0]
    for i in range(feats.shape[1] - 1):
        out = _d_block(p, f"netD.DBlocks.{i}", out, feats[:, i + 1])
    return _d_block(p, "netD.main", out)


def net_c(p: Params, h: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(h [B, C, g, g], sentences [B, S]) -> logits [B]."""
    tiled = s[:, :, None, None].expand(-1, -1, h.shape[2], h.shape[3])
    x = lrelu(F.conv2d(torch.cat([h, tiled], dim=1),
                       p["netC.joint_conv.0.weight"]))
    return F.conv2d(x, p["netC.joint_conv.2.weight"]).reshape(-1)


# -- the train step -----------------------------------------------------------

def _grads(loss: torch.Tensor, params: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(q) if g is None else g
            for q, g in zip(params, gs)]


class Adam:
    """Adam with betas (b1, b2), bias corrections, no clip, in place."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float,
                 b2: float, eps: float):
        self.params, self.lr, self.b1, self.b2 = params, lr, b1, b2
        self.eps = eps
        self.m = [torch.zeros_like(q) for q in params]
        self.v = [torch.zeros_like(q) for q in params]
        self.t = 0
        self.first = None  # the first update's gradients
        self.norms = []   # each update's gradient norms, by leaf

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
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


class TrainState:
    """G, D + C and the EMA generator as leaf tensors, the frozen CLIP,
    the two optimizers and the step's random generator."""

    def __init__(self, cfg: dict, g: Params, d: Params, clip: Params,
                 rng: torch.Generator):
        o = cfg["optim"]
        self.cfg, self.clip, self.rng = cfg, clip, rng
        self.g = {k: v.clone().requires_grad_(True) for k, v in g.items()}
        self.d = {k: v.clone().requires_grad_(True) for k, v in d.items()}
        self.ema = {k: v.clone() for k, v in g.items()}
        betas = (o["beta1"], o["beta2"], o["eps"])
        self.g_opt = Adam(list(self.g.values()), o["g_lr"], *betas)
        self.d_opt = Adam(list(self.d.values()), o["d_lr"], *betas)


def train_step(st: TrainState, images: torch.Tensor, ids: torch.Tensor,
               batch_fraction: float = 1.0) -> Dict[str, float]:
    """One step on images [B, 3, H, W] in [-1, 1] and framed ids [B, T];
    updates `st` in place and returns the losses. `batch_fraction` < 1
    keeps only that share of the rows after the draws (a planted fault,
    for the control readings)."""
    cfg = st.cfg
    ct, lc = cfg["text_encoder"], cfg["loss"]
    heads = vision_heads(ct)
    layers = tuple(cfg["discriminator"]["local_layers"])
    b = images.shape[0]
    with torch.no_grad():
        s = encode_text(st.clip, ids, ct["transformer_heads"])
    noise = torch.randn((b, cfg["generator"]["latent_dim"]),
                        generator=st.rng, device=images.device)
    if batch_fraction < 1.0:
        keep = max(2, int(b * batch_fraction))
        images, s, noise, b = images[:keep], s[:keep], noise[:keep], keep
    g_params, d_params = list(st.g.values()), list(st.d.values())
    fake = generator(st.g, st.clip, noise, s, cfg)

    def guard_draw():
        torch.randn((), generator=st.rng, device=images.device)

    # D: hinge (real, fake, rolled mismatch) + MA-GP on the CLIP features
    with torch.no_grad():
        f_real = encode_image(st.clip, images, heads, layers)[0]
        f_fake = encode_image(st.clip, fake.detach(), heads, layers)[0]
    f_real.requires_grad_(True)
    s_req = s.detach().requires_grad_(True)
    h_real = net_d(st.d, f_real)
    p_real = net_c(st.d, h_real, s_req)
    p_fake = net_c(st.d, net_d(st.d, f_fake), s)
    p_mis = net_c(st.d, h_real, torch.roll(s, -1, dims=0))
    gf, gs = torch.autograd.grad(p_real.sum(), (f_real, s_req),
                                 create_graph=True)
    norm = torch.sqrt((torch.cat([gf.reshape(b, -1), gs.reshape(b, -1)],
                                 dim=1) ** 2).sum(dim=1))
    gp = lc["gp_coef"] * (norm ** lc["gp_power"]).mean()
    d_loss = F.relu(1.0 - p_real).mean() + (
        F.relu(1.0 + p_fake).mean() + F.relu(1.0 + p_mis).mean()) / 2.0 + gp
    st.d_opt.step(_grads(d_loss, d_params))
    guard_draw()

    # G: against the updated D, through the CLIP encoder and the mapper
    local, glob = encode_image(st.clip, fake, heads, layers)
    adv = -net_c(st.d, net_d(st.d, local), s).mean()
    sim = F.cosine_similarity(glob, s, dim=1).mean()
    g_loss = adv - lc["sim_weight"] * sim
    st.g_opt.step(_grads(g_loss, g_params))
    guard_draw()
    decay = cfg["train"]["ema_decay"]
    with torch.no_grad():
        for k, v in st.g.items():
            st.ema[k].mul_(decay).add_(v * (1.0 - decay))
    return {"d_loss": d_loss.item(), "d_gp_loss": gp.item(),
            "g_loss": g_loss.item(), "txtimg_loss": 1.0 - sim.item()}


class CubClipReference(CubReference):
    """CUB's batches (`data.CubReference`) with CLIP's token framing: one
    of the image's captions, start-of-text 49406, its first max_len - 2
    ids, end-of-text 49407, zeros to max_len."""

    def _caption(self, idx: int, g: np.random.Generator):
        shift = int(g.integers(0, self.per_image))
        cap = np.asarray(self.captions[idx * self.per_image + shift],
                         np.int64)[:self.max_len - 2]
        out = np.zeros((self.max_len,), np.int64)
        out[0] = 49406
        out[1:len(cap) + 1] = cap
        out[len(cap) + 1] = 49407
        return out, len(cap) + 2
