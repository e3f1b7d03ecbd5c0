"""The ranks' grid and data parallelism (counterpart of
``detr_tpu/parallel/mesh.py``).

A ``Grid`` is the port's mesh: ``world`` ranks as ``dp_size`` rows of
``tp_size`` adjacent ranks, each row a tensor-parallel group (``parallel.tp``)
and each column a data-parallel group.  Rank r sits at row ``r // tp_size``
(its data-parallel index) and column ``r % tp_size`` (its tensor-parallel
index).  ``make_mesh`` is the 1-D data-parallel grid; ``tp.make_mesh_2d`` the
2-D one.

Data parallelism: every rank holds the whole model (``shard_state`` is the
identity, trusting the same-seeded init as the JAX package's replicated
placement does) and its row block of the global batch (``shard_batch``);
the criterion sums over the data-parallel group and the train step
all-reduces the micro-step's gradients over it.  One process without a
process group is the grid of one rank, with no collectives.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist

from detr_tpu_torch.parallel.distributed import initialize_distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Grid:
    """This rank's place in a (data, model) grid of ranks, and its process
    groups.  ``dp_group`` is None when there is no process group: then no
    collective runs, and that is the one test of it."""

    rank: int = 0
    world: int = 1
    tp_size: int = 1
    dp_group: Optional[Any] = None
    tp_group: Optional[Any] = None

    @property
    def dp_size(self) -> int:
        return self.world // self.tp_size

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp_size

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp_size

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.dp_size, MODEL_AXIS: self.tp_size}


def _world(num_devices: int) -> tuple[int, int, bool]:
    """(rank, world, distributed), joining the process group if torchrun's
    variables are set; ``num_devices`` must be 0 (all ranks) or the world."""
    initialize_distributed()
    if not dist.is_initialized():
        rank, world, distributed = 0, 1, False
    else:
        rank, world, distributed = dist.get_rank(), dist.get_world_size(), True
    if num_devices and num_devices != world:
        raise ValueError(f"num_devices={num_devices} but the run has {world} rank(s): one "
                         "rank per card, so launch that many (0 takes them all)")
    return rank, world, distributed


def make_mesh(num_devices: int = 0) -> Grid:
    """The 1-D data-parallel grid over every rank (``num_devices`` 0 or the
    world size)."""
    rank, world, distributed = _world(num_devices)
    return Grid(rank=rank, world=world, tp_size=1,
                dp_group=dist.group.WORLD if distributed else None)


def assert_divisible(batch_size: int, grid: Grid, axis: str = DATA_AXIS) -> None:
    n = grid.shape[axis]
    if batch_size % n != 0:
        raise ValueError(f"global batch {batch_size} not divisible by mesh axis {axis}={n}")


def shard_batch(batch: dict, grid: Grid) -> tuple[dict, int]:
    """(this rank's row block of a global batch, the block's first row).
    Every entry with a leading batch dim is cut; scalars stay."""
    n = next(len(v) for v in batch.values() if getattr(v, "ndim", 0))
    assert_divisible(n, grid)
    rows = n // grid.dp_size
    lo = grid.dp_rank * rows
    block = {k: (v[lo:lo + rows] if getattr(v, "ndim", 0) else v) for k, v in batch.items()}
    return block, lo


def shard_state(state: Any, grid: Grid) -> Any:
    """The train state of a data-parallel grid: replicated, so as it is.
    Every rank must hold the same values (same-seeded init, or one
    checkpoint restored); like the JAX package's replicated placement, this
    trusts that and checks nothing."""
    return state
