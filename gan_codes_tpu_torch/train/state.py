"""Training state and optimizers (the port of `gan_codes_tpu/train/state.py`).

The JAX package keeps everything its jitted step touches in one pytree; here
`TrainState` holds the modules, the two optimizers and a `torch.Generator`
for the step's noise and NaN-guard draws, and the step updates it in place.

The optimizer follows the JAX package's optax chain, not torch's habit
(`make_optimizers`, reference `model.py:42-53`): a global-norm clip, then
Adam with betas (0.0, 0.9), G lr 1e-4 and D lr 4e-4. optax's
`clip_by_global_norm` scales by max_norm / norm when norm >= max_norm;
torch's `clip_grad_norm_` scales by max_norm / (norm + 1e-6), which is not
what the JAX package trains with.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from ..config import GANConfig, is_galip
from ..models.discriminator import Discriminator
from ..models.generator import Generator
from ..utils.device import serving_device


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> None:
    """optax.clip_by_global_norm, in place: when the global L2 norm of
    `grads` is at least `max_norm`, scale every gradient by max_norm / norm
    (one multiply; optax divides by the norm, then multiplies, so the two
    may differ in the last bit). No value leaves the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


class ClipAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr, b1, b2, eps))
    over a fixed list of parameters. `step(grads)` clips the gradients in
    place, leaves them as the parameters' `.grad`, and takes one Adam step
    (torch's Adam: the same update as optax's, bias corrections included).
    `max_norm` None: Adam alone (GALIP clips nothing)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 betas: Tuple[float, float], eps: float,
                 max_norm: Optional[float]):
        self.params: List[torch.nn.Parameter] = list(params)
        self.max_norm = max_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=betas,
                                     eps=eps)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        if self.max_norm is not None:
            clip_by_global_norm(grads, self.max_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.step()


def make_optimizers(cfg: GANConfig, generator: Generator,
                    discriminator: Discriminator
                    ) -> Tuple[ClipAdam, ClipAdam]:
    """TTUR Adam with the global-norm clip before it, for G and for D."""
    o = cfg.optim
    betas = (o.beta1, o.beta2)
    return (ClipAdam(generator.parameters(), o.g_lr, betas, o.eps,
                     getattr(o, "grad_clip_g", None)),
            ClipAdam(discriminator.parameters(), o.d_lr, betas, o.eps,
                     getattr(o, "grad_clip_d", None)))


@dataclasses.dataclass
class TrainState:
    step: int
    generator: Generator
    discriminator: Discriminator
    g_ema: Generator             # EMA generator for eval and sampling
    g_opt: ClipAdam
    d_opt: ClipAdam
    rng: torch.Generator         # noise and NaN-guard draws of the step
    clip: Optional[torch.nn.Module] = None  # GALIP's frozen CLIP


def create_train_state(cfg: GANConfig, seed: int,
                       device: str | torch.device = "cuda",
                       clip: Optional[torch.nn.Module] = None
                       ) -> TrainState:
    """Seeded G, D (torch's default inits, the distributions the JAX
    package's inits reproduce), a copy of G for the EMA, both optimizers
    and the step's generator, on `device` (CUDA unless the caller asks for
    the CPU; on CUDA, TF32 is turned off so fp32 trains in fp32).

    A `GALIPConfig` builds GALIP's NetG and NetD + NetC
    (`models/galip.py`) around `clip`, the frozen CLIP
    (`models/clip.py`; seeded at random when not given), which the state
    holds and which G's mapper and the EMA copy share."""
    dev = serving_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if is_galip(cfg):
            from ..models import galip
            from ..models.clip import CLIP

            clip = CLIP(cfg.text_encoder) if clip is None else clip
            g, d = galip.build(cfg, clip)
        else:
            g = Generator(cfg.generator)
            d = Discriminator(cfg.discriminator)
    g, d = g.to(dev), d.to(dev)
    memo = {}
    if clip is not None:
        clip = clip.to(dev).eval().requires_grad_(False)
        memo[id(clip)] = clip  # the EMA's G shares the frozen CLIP
    g_opt, d_opt = make_optimizers(cfg, g, d)
    g_ema = copy.deepcopy(g, memo).requires_grad_(False)
    return TrainState(step=0, generator=g, discriminator=d, g_ema=g_ema,
                      g_opt=g_opt, d_opt=d_opt,
                      rng=torch.Generator(device=dev).manual_seed(seed),
                      clip=clip)


@torch.no_grad()
def ema_update(ema: torch.nn.Module, model: torch.nn.Module,
               decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place, each product
    rounded on its own as the JAX package writes it (not a lerp, which
    rounds otherwise)."""
    e = list(ema.parameters())
    scaled = torch._foreach_mul(list(model.parameters()), 1.0 - decay)
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, scaled)
