"""Process groups and the collectives of the multi-device modes
(counterpart of ``stylemesh_tpu/parallel/mesh.py``).

Where the JAX package lays one program over a mesh of chips, the port runs
one process per device of the mesh, as ``torchrun`` starts them, joined by a
``torch.distributed`` process group. :class:`Mesh` is one rank's view of it:
its rank, the world size, its device and the group.

- NCCL needs a card per rank. Ranks that share a card (several ranks on one
  H100) or run on the CPU talk over gloo, which takes CUDA tensors for
  ``all_reduce`` and ``broadcast`` but not for gathers: the gathers here are
  staged through host memory under gloo. :func:`make_mesh` prints the
  backend it chose.
- A world of one rank has no process group, and every collective is the
  identity: the single-device pipeline's behaviour.
- :func:`all_reduce_sum` is differentiable with the identity as its
  backward. Every caller reduces partials of a loss that is replicated on
  every rank, so each rank's cotangent is already the full one; the JAX
  package's ``psum`` transpose under ``check_vma=False`` sums D copies and
  needs a 1/D rescale instead.
"""

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from stylemesh_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of a 1-D mesh: ``size`` ranks, this one ``rank``, its
    ``device``; ``group`` None for a world of one rank."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    group: Any = None

    @property
    def is_root(self):
        return self.rank == 0


def make_mesh(world_size=1, rank=0, device=None, init_method=None,
              local_world_size=None, timeout_s=600.0):
    """Join (or, for one rank, skip) the process group of ``world_size``
    ranks at ``init_method`` (``tcp://``, ``file://``, or None for the
    ``env://`` variables ``torchrun`` sets). The backend is NCCL when
    ``device`` is a card and each of the ``local_world_size`` ranks of this
    host has a card of its own, gloo otherwise."""
    device = resolve_device(device)
    if world_size == 1:
        return Mesh(rank=0, size=1, device=device)
    local = local_world_size or world_size
    own_card = device.type == "cuda" and local <= torch.cuda.device_count()
    backend = "nccl" if own_card else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    print(f"[rank {rank}/{world_size}] backend {backend}, device {device}\n",
          end="", flush=True)  # one write: the ranks' lines do not interleave
    return Mesh(rank=rank, size=world_size, device=device, backend=backend,
                group=dist.group.WORLD)


def init_from_env(device=None):
    """The mesh ``torchrun`` describes in ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``; without them one rank. Unless
    ``device`` is the CPU, the rank's device is card ``LOCAL_RANK`` modulo
    the cards present."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return make_mesh(device=device)
    if device is None or torch.device(device).type == "cuda":
        resolve_device("cuda")
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return make_mesh(world, int(os.environ["RANK"]), device,
                     local_world_size=int(os.environ.get(
                         "LOCAL_WORLD_SIZE", world)))


def shutdown(mesh: Mesh):
    """Leave the process group (a no-op for one rank)."""
    if mesh.size > 1 and dist.is_initialized():
        dist.destroy_process_group()


def replicate_sharding(mesh: Mesh):
    """Where a replicated tensor lives: whole, on the rank's device (the
    counterpart of ``NamedSharding(mesh, P())``)."""
    return mesh.device


def view_batch_sharding(num_views, mesh: Mesh):
    """The rank's contiguous slice of a batch's views (the counterpart of
    ``NamedSharding(mesh, P('views'))``); ``num_views`` must divide."""
    if num_views % mesh.size:
        raise ValueError(f"{num_views} views do not split over "
                         f"{mesh.size} ranks")
    per = num_views // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_view_batch(batch, mesh: Mesh):
    """The rank's views of a ``ViewBatch`` (tensors or numpy arrays; a
    view of the caller's data, no copy)."""
    sl = view_batch_sharding(batch.num_views, mesh)

    def take(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(take(y) for y in x)
        return x[sl]

    return type(batch)(*[take(f) for f in batch])


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        y = x.detach().clone()
        dist.all_reduce(y, group=mesh.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x, mesh: Mesh):
    """The sum of ``x`` over the ranks, differentiable: its backward is the
    identity (see the module docstring)."""
    if mesh.size == 1:
        return x
    return _AllReduceSum.apply(x, mesh)


def _host_staged(mesh: Mesh, x):
    return mesh.backend == "gloo" and x.device.type != "cpu"


def all_gather_rows(x, mesh: Mesh):
    """Every rank's ``x`` (equal shapes) concatenated along dim 0, on every
    rank, on ``x``'s device."""
    if mesh.size == 1:
        return x
    src = x.detach().contiguous()
    if _host_staged(mesh, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=0).to(x.device)


def gather_to_rank0(x, mesh: Mesh):
    """:func:`all_gather_rows` on rank 0, None on the other ranks."""
    out = all_gather_rows(x, mesh)
    return out if mesh.is_root else None


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's picklable ``obj`` on every rank."""
    if mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(mesh.group, 0),
                               group=mesh.group)
    return box[0]


def barrier(mesh: Mesh):
    if mesh.size > 1:
        dist.barrier(group=mesh.group)
