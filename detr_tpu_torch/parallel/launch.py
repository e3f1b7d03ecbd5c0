"""Start the ranks of a process group from Python: ``spawn(fn, world)`` runs
``fn(rank, *args)`` in ``world`` new processes joined over ``localhost``, as
torchrun would start them on one host, and returns each rank's result.

The processes are spawned (CUDA needs that), so ``fn`` and its arguments
must pickle: a module-level function, plain data.  Each process gets
torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and
``DETR_DIST_BACKEND``, joins the group (``initialize_distributed``), runs,
and leaves it.  Tensors in a result come back as numpy arrays.  A rank that
raises fails the call with its traceback; ranks still running after
``timeout`` seconds are killed and the call raises: nothing waits unbounded
on a rendezvous.  A rank that has delivered its result but not exited
``EXIT_GRACE_S`` seconds later (a teardown that hangs) is killed with a
warning, and the call returns.  Used by ``entry.dryrun_multichip``, the multi-rank tests
(gloo on the CPU) and ``chip_smoke.py`` (two ranks sharing one card).
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Optional

from detr_tpu_torch.parallel.distributed import BACKEND_ENV

logger = logging.getLogger(__name__)

# Seconds a rank may take to exit once its result is in.
EXIT_GRACE_S = 30.0


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_numpy(x: Any) -> Any:
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    return x


def _child(fn, rank, world, port, backend, threads, args, results) -> None:
    os.environ.update({
        "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
        "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
        BACKEND_ENV: backend,
    })
    import torch

    from detr_tpu_torch.parallel.distributed import initialize_distributed, shutdown_distributed

    if threads:
        torch.set_num_threads(threads)
    try:
        initialize_distributed()
        results.put((rank, True, _to_numpy(fn(rank, *args))))
    except BaseException:  # the parent re-raises it with the traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown_distributed()


def spawn(fn: Callable, world: int, args: tuple = (), backend: str = "gloo",
          timeout: float = 300.0, threads: Optional[int] = 1) -> list:
    """[fn(rank, *args) for each rank], each run in a process of its own,
    joined into one process group of ``world`` ranks over ``backend``;
    ``threads`` intra-op threads per rank (None: torch's default)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, world, port, backend, threads, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited ({[procs[r].exitcode for r in dead]})"
                                       " without a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} still "
                                       f"running after {timeout:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        exit_by = time.monotonic() + EXIT_GRACE_S
        for r, p in enumerate(procs):
            p.join(timeout=max(0.0, exit_by - time.monotonic()))
            if p.is_alive():
                logger.warning("rank %d had not exited %.0f s after its result: killed",
                               r, EXIT_GRACE_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
