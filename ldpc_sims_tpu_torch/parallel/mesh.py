"""Process meshes on ``torch.distributed`` (the port of
``parallel/mesh.py``).

The JAX package shards a sweep over a ``jax.sharding.Mesh`` of devices
with a ``batch`` axis (Monte-Carlo codewords) and an ``snr`` axis (grid
points), and attaches hosts with ``jax.distributed.initialize``. The
port runs one process a GPU, PyTorch's idiom and what several hosts
need: a :class:`Mesh` is a grid of process ranks shaped (snr, batch)
with the process group its collectives run on, and each rank computes
its own shard. ``torchrun`` (``python -m torch.distributed.run``) sets
the environment :func:`maybe_distributed_init` reads; NCCL carries the
collectives between cards and Gloo on the CPU. Without a process group
the mesh is this one process.

JAX's ``batch_sharding`` and ``replicated`` return ``NamedSharding``
annotations for the jitted step; torch has no counterpart (each rank
slices its own shard), so they are not ported.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "make_mesh",
    "maybe_distributed_init",
    "local_batch_multiple",
]


def maybe_distributed_init() -> bool:
    """Initialise the default process group when launched by ``torchrun``.

    Reads ``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR`` (with
    ``MASTER_PORT``) from the environment; the backend is NCCL when a
    CUDA device is present, with this process's card set to
    ``LOCAL_RANK``, and Gloo otherwise. Without that environment, or when
    a group is already initialised, it does nothing. Returns whether a
    process group is initialised afterwards.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if not all(env.get(k) for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR")):
        return False
    if torch.cuda.is_available():
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]))
    return True


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Process ranks laid out as (snr, batch).

    ``ranks`` holds the global ranks of the mesh's processes; ``group`` is
    the process group its collectives run on (None for a one-process mesh
    without ``torch.distributed``); ``rank`` this process's global rank.
    """

    ranks: np.ndarray
    group: object
    rank: int
    axis_names: tuple[str, str] = ("snr", "batch")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def member(self) -> bool:
        """Whether this process is one of the mesh's ranks."""
        return self.rank in self.ranks

    @property
    def index(self) -> int:
        """This rank's flat shard index (row-major over (snr, batch))."""
        flat = self.ranks.ravel().tolist()
        if self.rank not in flat:
            raise ValueError(f"rank {self.rank} is not in the mesh {flat}")
        return flat.index(self.rank)

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's (snr, batch) position."""
        return divmod(self.index, self.ranks.shape[1])

    @property
    def leader(self) -> int:
        """The global rank of shard 0, which writes the mesh's files."""
        return int(self.ranks.flat[0])

    @property
    def is_leader(self) -> bool:
        return self.rank == self.leader

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the mesh's ranks (in place; a no-op on one)."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast(self, obj):
        """Shard 0's ``obj`` on every rank of the mesh."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.leader, group=self.group)
        return box[0]


def make_mesh(snr_axis: int = 1, ranks=None) -> Mesh:
    """Mesh over the world's ranks (or ``ranks``): ``('snr', 'batch')``.

    ``snr_axis`` ranks go to the SNR-grid axis (1 = shard only over
    batch). A mesh of a subset of the world makes a new process group,
    which every rank of the world must call together (as
    ``torch.distributed.new_group`` requires), members or not.
    """
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if not ranks or len(set(ranks)) != len(ranks) or not all(
            0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} are not distinct ranks of a world "
                         f"of {world}")
    if len(ranks) % snr_axis:
        raise ValueError(f"{len(ranks)} ranks not divisible by {snr_axis}")
    if not dist.is_initialized():
        group = None
    elif sorted(ranks) == list(range(world)):
        group = dist.group.WORLD
    else:
        group = dist.new_group(ranks)
    return Mesh(np.asarray(ranks).reshape(snr_axis, -1), group, rank)


def local_batch_multiple(mesh: Mesh) -> int:
    """Batch sizes must be a multiple of the total mesh size."""
    return mesh.size
