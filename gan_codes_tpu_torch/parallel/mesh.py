"""The process group of a data-parallel run (the port of
`gan_codes_tpu/parallel/mesh.py`).

JAX lays its devices out on a mesh whose `data` axis the batch shards over
(`make_mesh`), with a `replica` axis across slices on several hosts
(`DCN_AXIS`, `make_hybrid_mesh`). Here each card is one process, started by
`torchrun`, which names it through the environment: RANK and WORLD_SIZE
over the job, LOCAL_RANK and LOCAL_WORLD_SIZE on its node, GROUP_RANK the
node, MASTER_ADDR and MASTER_PORT the rendezvous. Ranks are node-major
(RANK = GROUP_RANK * LOCAL_WORLD_SIZE + LOCAL_RANK), as JAX's global batch
is process-major. The backend follows the device: NCCL for CUDA, gloo for
the CPU. NCCL picks its own rings, so JAX's mesh layouts have no
counterpart here.

Every collective of the port goes through `all_reduce` and `broadcast`
below, and each counts the collectives it issues (`all_reduce.calls`,
`broadcast.calls`), as the kernels' wrappers count their launches.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, List, Mapping, Optional

import torch
import torch.distributed as dist

from ..utils.device import local_device, serving_device
from ..utils.jsonio import restore_nonfinite, sanitize_nonfinite


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a data-parallel run. `distributed` is True
    when a `torch.distributed` group is up; without one the world is this
    process alone and every collective is a no-op.

    "No group" has two forms, and every layer that takes a mesh tells them
    apart. `mesh=None` is the plain single-process run: the step's mean
    forms, bit for bit the step from before data parallelism. A Mesh with
    `distributed=False` is `--dp` outside torchrun, a world of one that
    runs the data-parallel forms (sums over the global count, the flat
    gradient buffers) with no collective, as the JAX package's `--dp` on
    one device runs its sharded step over a one-device mesh."""
    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    node: int = 0
    device: torch.device = torch.device("cpu")
    distributed: bool = False

    @property
    def nodes(self) -> int:
        return self.world // self.local_world

    @property
    def primary(self) -> bool:
        return self.rank == 0


def _env_int(env: Mapping[str, str], key: str, default: int) -> int:
    return int(env[key]) if key in env else default


def mesh_layout(env: Optional[Mapping[str, str]] = None
                ) -> Optional[dict]:
    """The layout `torchrun` describes in `env` (default: os.environ):
    rank, world, local_rank, local_world and node; None without RANK and
    WORLD_SIZE. Raises on an inconsistent one."""
    env = os.environ if env is None else env
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = _env_int(env, "LOCAL_RANK", rank)
    local_world = _env_int(env, "LOCAL_WORLD_SIZE", world)
    node = _env_int(env, "GROUP_RANK", rank // local_world)
    if not (0 <= rank < world and 0 <= local_rank < local_world
            and world % local_world == 0
            and rank == node * local_world + local_rank):
        raise ValueError(f"inconsistent torchrun environment: RANK {rank}, "
                         f"WORLD_SIZE {world}, LOCAL_RANK {local_rank}, "
                         f"LOCAL_WORLD_SIZE {local_world}, GROUP_RANK "
                         f"{node}")
    return dict(rank=rank, world=world, local_rank=local_rank,
                local_world=local_world, node=node)


def init_mesh(device: str | torch.device = "cuda",
              backend: Optional[str] = None,
              env: Optional[Mapping[str, str]] = None) -> Mesh:
    """Join the run `torchrun` describes in `env` (`mesh_layout`).

    The device is `device` (CUDA unless the caller asks for the CPU; on
    CUDA the card LOCAL_RANK, unless `device` names one). The backend is
    NCCL on CUDA and gloo on the CPU; `backend="gloo"` with CUDA tensors
    is for several ranks on one card, which NCCL refuses. A failed
    `init_process_group` raises. Without RANK and WORLD_SIZE in the
    environment the world is this process alone, and no group is made."""
    layout = mesh_layout(env)
    if layout is None:
        return Mesh(device=serving_device(device))
    dev = local_device(device, layout["local_rank"])
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://",
                            rank=layout["rank"], world_size=layout["world"],
                            **kwargs)
    return Mesh(device=dev, distributed=True, **layout)


def local_devices(device: str | torch.device = "cuda"
                  ) -> List[torch.device]:
    """The devices of this process for data-parallel serving, the
    counterpart of JAX's `make_mesh()` over the local devices: every CUDA
    card (raises without one), or the CPU alone."""
    dev = serving_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def close_mesh(mesh: Optional[Mesh]) -> None:
    """Tear the group down (a no-op without one)."""
    if mesh is not None and mesh.distributed:
        dist.destroy_process_group()


def _active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.distributed


def all_reduce(mesh: Optional[Mesh], tensor: torch.Tensor) -> torch.Tensor:
    """Sum `tensor` over the ranks, in place (on `mesh.device`); returns
    it. Every rank gets the same bits."""
    if _active(mesh):
        dist.all_reduce(tensor)
        all_reduce.calls += 1
    return tensor


all_reduce.calls = 0


def broadcast(mesh: Optional[Mesh], tensor: torch.Tensor) -> torch.Tensor:
    """Rank 0's `tensor` on every rank, in place (on `mesh.device`)."""
    if _active(mesh):
        dist.broadcast(tensor, src=0)
        broadcast.calls += 1
    return tensor


broadcast.calls = 0


def barrier(mesh: Optional[Mesh]) -> None:
    if _active(mesh):
        dist.barrier()


def broadcast_json(mesh: Optional[Mesh], obj: Any) -> Any:
    """Rank 0's JSON-serializable `obj` on every rank (its length, then
    its bytes; non-finite floats survive); the other ranks' `obj` is not
    read. The JAX package's `_broadcast_json_from_primary`."""
    if not _active(mesh):
        return obj
    payload = (json.dumps(sanitize_nonfinite(obj), allow_nan=False).encode()
               if mesh.primary else b"")
    n = broadcast(mesh, torch.tensor([len(payload)], dtype=torch.int64,
                                     device=mesh.device))
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=mesh.device)
    if mesh.primary:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    broadcast(mesh, buf)
    return restore_nonfinite(json.loads(buf.cpu().numpy().tobytes().decode()))
