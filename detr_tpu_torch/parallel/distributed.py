"""Multi-rank runs on ``torch.distributed`` (counterpart of
``detr_tpu/parallel/distributed.py``).

One process per card, each a rank of one process group:

    torchrun --nproc-per-node 4 -m detr_tpu_torch.train.trainer \\
        --num-devices 4 --model-parallel 2 --coco-dataset-root datasets/coco-2017

Division of labour, as in the JAX package's multi-process runtime:

  * every rank runs the same program and the same step;
  * the train loader reads only the rank's data-parallel shard
    (``BucketedLoader(shard=...)``, ``data_shard``); the ranks of one
    tensor-parallel group read the same one;
  * replicated state is the same-seeded init (or one checkpoint restore) on
    every rank; the frozen-BN statistics, calibrated on each rank's own
    batch, are rank 0's, broadcast (``broadcast_from_primary``);
  * host effects (tensorboard, mAP, logs, the checkpoint file) run on rank 0
    only (``is_primary``).

``initialize_distributed`` reads torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` (the JAX package reads
``JAX_COORDINATOR``, ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``).  Without
them nothing is initialised and the run is one process, as before.  The
backend is NCCL with a card and gloo without one; ``DETR_DIST_BACKEND``
chooses it, as ranks that share one card need: NCCL refuses two ranks on
one device ("invalid usage"), while gloo takes CUDA tensors for
``all_reduce`` and ``broadcast``; gloo's ``all_gather`` is carried on host
copies (``allgather_host``, ``parallel.tp.gather_state_tp``).  A backend
that does not come up raises; nothing falls back to one rank or to the CPU.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

BACKEND_ENV = "DETR_DIST_BACKEND"
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# How long a collective may wait for the other ranks before it raises.
TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed() -> bool:
    """Joins the process group that torchrun's variables describe; idempotent.

    Returns True when the run has more than one rank.  With no
    ``WORLD_SIZE`` in the environment nothing is initialised (one process).
    A world of one rank is initialised all the same (its collectives run
    through the backend).  The backend is ``DETR_DIST_BACKEND``'s, else
    NCCL with a card and gloo without."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but not {', '.join(missing)}")
    backend = os.environ.get(BACKEND_ENV) or ("nccl" if torch.cuda.is_available() else "gloo")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=TIMEOUT)
    logger.info("distributed: rank %d/%d, local rank %s, backend %s", rank, world,
                os.environ.get("LOCAL_RANK", "0"), backend)
    return world > 1


def shutdown_distributed() -> None:
    """Leaves the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_device() -> torch.device:
    """This rank's card: ``cuda:LOCAL_RANK``, or the one card when the ranks
    of a host share it."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card; pass device='cpu' for a CPU run")
    n = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", "0"))
    index = 0 if n == 1 else local
    if index >= n:
        raise RuntimeError(f"local rank {local} has no card of its own ({n} cards)")
    return torch.device("cuda", index)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that owns host-side effects (logs, eval, files)."""
    return process_index() == 0


def barrier() -> None:
    """Waits for every rank; nothing on one process."""
    if dist.is_initialized():
        dist.barrier()


def data_shard(grid=None) -> tuple[int, int]:
    """(shard_index, shard_count) of this rank's dataset shard: its
    data-parallel index and size (every rank of a tensor-parallel group
    reads the same shard)."""
    if grid is None:
        return process_index(), process_count()
    return grid.dp_rank, grid.dp_size


def _host_collectives() -> bool:
    """Whether tensors are gathered on the host: gloo's all_gather takes CPU
    tensors, NCCL's only CUDA ones."""
    return dist.get_backend() != "nccl"


def allgather_host(tensors: dict[str, torch.Tensor], group=None) -> dict[str, torch.Tensor]:
    """Every rank's tensors of ``group``, concatenated along dim 0 in rank
    order, on the CPU of every rank (validation gathers each rank's rows of
    the last layer for rank 0's postprocess).  One process: the tensors on
    the CPU."""
    if not dist.is_initialized():
        return {k: v.detach().cpu() for k, v in tensors.items()}
    n = dist.get_world_size(group)
    out = {}
    for k, v in tensors.items():
        v = v.detach().contiguous()
        if _host_collectives():
            v = v.cpu()
        parts = [torch.empty_like(v) for _ in range(n)]
        dist.all_gather(parts, v, group=group)
        out[k] = torch.cat(parts).cpu()
    return out


def broadcast_from_primary(tensors) -> None:
    """Overwrites ``tensors`` in place with rank 0's.  Nothing on one
    process."""
    if not dist.is_initialized():
        return
    for t in tensors:
        dist.broadcast(t, src=0)
