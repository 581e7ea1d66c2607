"""Rank meshes and multi-process bring-up (port of
:mod:`lqg_tpu.parallel.mesh`).

PyTorch's idiom is one process per device, so a mesh is a grid of
``torch.distributed`` ranks with named axes, and each axis has one process
group per line of ranks along it; where JAX places one array over the
devices of a mesh, each rank here holds its own block.  Batch axes of the
inference workload shard over mesh axes: ``dp`` the trials, ``chains`` the
MCMC chains, ``sp`` the horizon.

Without an initialized process group the world is one rank: a mesh of one,
whose collectives do nothing.  With one, every axis has its groups, one
rank long ones included, and the collectives run.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from lqg_tpu_torch.config import resolve_device


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> Tuple[int, int]:
    """``(world size, rank)``; ``(1, 0)`` without a process group."""
    if _initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def backend_for(ranks_on_node: int) -> str:
    """``"nccl"`` when every rank of the node has a card of its own, else
    ``"gloo"`` (ranks on the CPU, or ranks sharing cards)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= ranks_on_node:
        return "nccl"
    return "gloo"


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_rank: Optional[int] = None) -> Optional[str]:
    """Join the process group: one process per device.

    A no-op (returning None) at one process.  Arguments default to
    torchrun's variables, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and
    ``MASTER_ADDR``/``MASTER_PORT`` (``LOCAL_WORLD_SIZE``, the ranks of
    this node, picks the backend).  ``coordinator`` is ``host:port`` or an
    ``init_method`` URL (``tcp://...``, ``file://...``).  The backend is
    :func:`backend_for` the ranks of this node, and on a machine with cards
    the rank's card becomes the current device (``local_rank`` modulo the
    cards).  Returns the backend.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return None
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", str(process_id)))
    if coordinator is None:
        coordinator = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    backend = backend_for(int(os.environ.get("LOCAL_WORLD_SIZE",
                                             str(num_processes))))
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)
    return backend


class Mesh:
    """Ranks ``ranks`` (an array shaped like the axes) with named axes;
    ``shape`` maps each name to its size, as a JAX mesh's does.  This rank's
    tensors live on ``device``; ``groups`` maps each axis to this rank's
    process group along it (None without a process group)."""

    def __init__(self, names: Sequence[str], ranks: np.ndarray,
                 device: torch.device, groups: dict):
        self.axis_names = tuple(names)
        self.ranks = ranks
        self.device = device
        self.groups = groups
        self.shape = dict(zip(self.axis_names, ranks.shape))
        rank = _world()[1]
        where = np.argwhere(ranks == rank)
        self._coords = (dict(zip(self.axis_names, where[0].tolist()))
                        if len(where) else None)

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self._coords is None:
            raise ValueError(f"rank {_world()[1]} is not in {self}")
        return self._coords[axis]

    def _reduce(self, x: torch.Tensor, axis: str, op) -> torch.Tensor:
        group = self.groups[axis]
        if group is None:
            return x
        x = x.to(self.device, copy=True)
        dist.all_reduce(x, op=op, group=group)
        return x

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axis``, on every one."""
        return self._reduce(x, axis, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._reduce(x, axis, dist.ReduceOp.MAX)

    def gather(self, tensors: Sequence[torch.Tensor], axis: str) -> list:
        """Each tensor concatenated along dim 0 over the ranks along
        ``axis``, in their order, on every one.

        Written as the sum of a zero-filled ``(ranks, ...)`` float64 buffer
        into which each rank writes its own slot: adding zeros is exact and
        float64 holds every float32, integer count and flag exactly, and an
        all-reduce is what every backend offers for tensors on the card.
        Autograd sees it: the backward sums the cotangents over the axis
        the same way and takes this rank's slot."""
        if self.groups[axis] is None:
            return list(tensors)
        return list(_Gather.apply(self, axis, *tensors))

class _Gather(torch.autograd.Function):
    """:meth:`Mesh.gather` forward; backward, the cotangents of the gathered
    tensors summed over the axis (each rank's holds what it read of every
    slot), this rank's slot."""

    @staticmethod
    def forward(ctx, mesh, axis, *tensors):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        k, sizes = mesh.shape[axis], [t.numel() for t in tensors]
        buf = torch.zeros((k, sum(sizes)), dtype=torch.float64,
                          device=mesh.device)
        buf[mesh.index(axis)] = torch.cat(
            [t.reshape(-1).to(mesh.device, torch.float64) for t in tensors])
        dist.all_reduce(buf, group=mesh.groups[axis])
        return tuple(part.to(t.dtype).reshape((k,) + t.shape).flatten(0, 1)
                     for t, part in zip(tensors, buf.split(sizes, dim=1)))

    @staticmethod
    def backward(ctx, *grads):
        k, i = ctx.mesh.shape[ctx.axis], ctx.mesh.index(ctx.axis)
        grads = [torch.zeros((k * s[0],) + s[1:], dtype=dt, device=dv)
                 if g is None else g for g, (s, dt, dv) in zip(grads, ctx.like)]
        buf = torch.cat([g.reshape(-1).to(ctx.mesh.device, torch.float64)
                         for g in grads])
        dist.all_reduce(buf, group=ctx.mesh.groups[ctx.axis])
        return (None, None, *(
            part.reshape(k, -1)[i].reshape(s).to(dv, dt)
            for part, (s, dt, dv) in zip(
                buf.split([g.numel() for g in grads]), ctx.like)))


class AxisSharding(NamedTuple):
    """A batch's leading axis split in contiguous blocks over one mesh axis,
    the counterpart of ``NamedSharding(mesh, PartitionSpec(axis))``."""

    mesh: Mesh
    axis: str

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` entries; ``n`` must divide by the
        axis."""
        k = self.mesh.shape[self.axis]
        if n % k:
            raise ValueError(f"leading axis of {n} must divide by mesh axis "
                             f"{self.axis!r} of size {k}")
        i = self.mesh.index(self.axis)
        return slice(i * (n // k), (i + 1) * (n // k))


def make_mesh(axis_sizes: Sequence[Tuple[str, int]], device=None) -> Mesh:
    """A mesh with named axes over the first ranks of the world, e.g.
    ``[("chains", 2), ("dp", 4)]``; this rank's tensors on ``device`` (the
    current card unless named).  Every rank of the world calls it alike:
    it creates each axis's process groups.  Raises ``ValueError`` when the
    axes need more ranks than the world has."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    names = tuple(n for n, _ in axis_sizes)
    shape = tuple(int(s) for _, s in axis_sizes)
    n_needed = int(np.prod(shape))
    world, rank = _world()
    if n_needed > world:
        raise ValueError(f"mesh {dict(axis_sizes)} needs {n_needed} ranks, "
                         f"have {world}")
    ranks = np.arange(n_needed).reshape(shape)
    groups = dict.fromkeys(names)
    if _initialized():
        for a, name in enumerate(names):
            for line in np.moveaxis(ranks, a, -1).reshape(-1, shape[a]):
                group = dist.new_group(line.tolist())
                if rank in line:
                    groups[name] = group
    return Mesh(names, ranks, device, groups)


def local_mesh(dp: Optional[int] = None, name: str = "dp",
               device=None) -> Mesh:
    """One-axis mesh over all (or ``dp``) ranks of the world."""
    return make_mesh([(name, _world()[0] if dp is None else dp)], device)


def shard_batch(x, mesh: Mesh, axis: str = "dp") -> torch.Tensor:
    """This rank's contiguous block of ``x``'s leading axis, on its
    device; the leading axis must divide by the axis."""
    x = torch.as_tensor(x)
    return x[AxisSharding(mesh, axis).block(x.shape[0])].to(mesh.device)


def replicate(x, mesh: Mesh) -> torch.Tensor:
    """``x`` whole on this rank's device."""
    return torch.as_tensor(x).to(mesh.device)
