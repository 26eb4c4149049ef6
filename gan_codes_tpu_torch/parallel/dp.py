"""Data-parallel training over the process group (the port of
`gan_codes_tpu/parallel/dp.py`).

JAX compiles its 3-phase step under GSPMD, the batch sharded over the
mesh's data axis and the state replicated: XLA places psums where the
losses take their means and a collective-permute where the mismatch term
crosses a shard boundary, so the sharded step equals the single-device
step on the same global batch. The port keeps that: `make_train_step(cfg,
mesh)` (`train/step.py`) sums each phase's gradients over the ranks in one
collective, with each loss taken as the rank's share of the global loss.
`replicate` makes every rank start from rank 0's state, and the step keeps
them in lockstep bit for bit.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..train.state import TrainState
from .mesh import Mesh, all_reduce, broadcast


def loader_shard(mesh: Mesh) -> dict:
    """`DataLoader` arguments of this process: its node's shard of each
    epoch (JAX's per-host shard, `shard_id=process_index`) and its rows of
    the node's batch."""
    return dict(shard_id=mesh.node, num_shards=mesh.nodes,
                local_rank=mesh.local_rank, local_world=mesh.local_world)


def shard_rows(mesh: Mesh, global_batch: int) -> slice:
    """This rank's rows of a global batch held in memory (rank-major,
    equal shares). JAX's `shard_batch` has no other counterpart: the
    loader takes each rank's rows before decoding (`loader_shard`)."""
    if global_batch % mesh.world:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{mesh.world} ranks")
    b = global_batch // mesh.world
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def state_tensors(state: TrainState,
                   text_encoder: Optional[torch.nn.Module]
                   ) -> List[torch.Tensor]:
    """Every tensor of the state, in an order every rank shares: the
    modules' parameters and buffers, then each optimizer's Adam state per
    parameter (empty before the first step)."""
    modules = [state.generator, state.discriminator, state.g_ema]
    if text_encoder is not None:
        modules.append(text_encoder)
    out = [t for m in modules
           for t in list(m.parameters()) + list(m.buffers())]
    for opt in (state.g_opt, state.d_opt):
        for p in opt.params:
            st = opt.adam.state.get(p, {})
            out += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
    return out


@torch.no_grad()
def replicate(mesh: Mesh, state: TrainState,
              text_encoder: Optional[torch.nn.Module] = None) -> None:
    """Rank 0's state on every rank, in place (JAX's `replicate`): G, D,
    the EMA G, both Adam states, `state.step`, `state.rng` and the text
    encoder. One broadcast per dtype of the tensors. A rank whose state
    has another layout than rank 0's raises, and so does every other
    rank. A no-op without a group."""
    if not mesh.distributed:
        return
    tensors = state_tensors(state, text_encoder)
    rng = state.rng.get_state()
    head = broadcast(mesh, torch.tensor(
        [len(tensors), rng.numel(), state.step], dtype=torch.int64,
        device=mesh.device))
    bad = all_reduce(mesh, torch.tensor(
        [int(head[0]) != len(tensors) or int(head[1]) != rng.numel()],
        dtype=torch.int64, device=mesh.device))
    if int(bad.item()):
        raise RuntimeError("replicate: the ranks' train states differ in "
                           "layout (tensor count or RNG state size)")
    state.step = int(head[2])
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = broadcast(mesh, torch.cat(
            [t.reshape(-1).to(mesh.device) for t in group]))
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))
    state.rng.set_state(broadcast(mesh, rng.to(mesh.device)).cpu())
