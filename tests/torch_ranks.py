"""Rank functions of the port's multi-rank tests, run by
``detr_tpu_torch.parallel.launch.spawn`` in gloo processes on the CPU (and
called in the test process itself for the one-process reference, where no
process group exists).  This module imports torch, numpy and the port only,
so a spawned rank starts without JAX.  It holds no test of its own.

Every function takes (rank, spec), spec being plain data: configuration
keyword dicts, numpy weights and batches.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.models.detr import DETR
from detr_tpu_torch.parallel import (
    make_mesh,
    make_mesh_2d,
    shard_batch,
    shard_state_tp,
    tensor_parallel,
)
from detr_tpu_torch.train.checkpoint import CheckpointManager, model_params
from detr_tpu_torch.train.optimizer import build_optimizer
from detr_tpu_torch.train.train_step import TrainState, build_criterion, make_train_step
from detr_tpu_torch.train.trainer import to_device


def grid_of(tp: int):
    """The grid of the ranks this process belongs to (one process: the
    grid of one rank)."""
    return make_mesh_2d(0, tp) if tp > 1 else make_mesh(0)


def model_from(spec, grid) -> DETR:
    """DETR with the spec's full weights, cut for the grid's tensor-parallel
    rank."""
    cfg = DETRConfig(**spec["config"])
    full = {k: torch.from_numpy(np.asarray(v)) for k, v in spec["state"].items()}
    tp = tensor_parallel(grid)
    model = DETR(cfg, tp)
    model.load_state_dict(shard_state_tp(full, tp), strict=True)
    return model


def _numpy_state(d: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}


def train_step_rank(rank: int, spec: dict) -> dict:
    """``spec["accum"]`` micro-steps of the port's train step on this rank's
    row block of ``spec["batch"]`` (the matching injected from
    ``spec["qog"]`` when given).  Every rank returns its metrics and its
    local parameter and moment shapes; rank 0 also the full parameters after
    the steps, the full AdamW moments, and (accum > 1) the accumulated
    gradient after the first micro-step."""
    grid = grid_of(spec["tp"])
    cfg = DETRConfig(**spec["config"])
    tc = TrainingConfig(**spec["train"])
    model = model_from(spec, grid)
    opt, _ = build_optimizer(model, tc)
    if "lrs" in spec:
        opt.set_learning_rates(spec["lrs"])
    state = TrainState(model, opt, torch.Generator().manual_seed(spec.get("seed", 0)))
    block, lo = shard_batch(spec["batch"], grid)
    crit = build_criterion(tc, cfg)
    if spec.get("qog") is not None:
        qog = torch.from_numpy(np.asarray(spec["qog"])[lo:lo + len(block["image"])])
        crit = dataclasses.replace(crit, matcher=lambda *a: qog)
    step = make_train_step(model, crit, grid=grid)
    out = {"metrics": [], "rank": rank, "dp_rank": grid.dp_rank, "tp_rank": grid.tp_rank}
    for i in range(spec["accum"]):
        state, m = step(state, to_device(block, torch.device("cpu")))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0 and spec["accum"] > 1:
            acc = opt.state_dict()["acc"]  # gathered over the tensor-parallel group
            grads = {n: a for n, a in zip(opt.names, acc)}
            if rank == 0:
                out["grad"] = _numpy_state(grads)
    params = model_params(model)  # a collective: every rank gathers
    sd = opt.state_dict()
    moments = {opt._state_names[i]: v["exp_avg"] for i, v in sd["adamw"]["state"].items()}
    local = opt.adamw.state_dict()["state"]
    out["local_shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out["local_moment_shapes"] = {opt._state_names[i]: tuple(v["exp_avg"].shape)
                                  for i, v in local.items()}
    out["updates"] = opt.updates
    if rank == 0:
        out["params"] = _numpy_state(params)
        out["moments"] = _numpy_state(moments)
    return out


def remat_pair_rank(rank: int, spec: dict) -> list:
    """``train_step_rank`` twice from the same spec: without and with
    ``DETRConfig.remat``."""
    return [train_step_rank(rank, dict(spec, config=dict(spec["config"], remat=remat)))
            for remat in (False, True)]


def checkpoint_rank(rank: int, spec: dict) -> dict:
    """``spec["mode"]``: "save" takes one train step from the spec's weights
    (so the moments exist) and saves at step 0 under ``spec["dir"]``;
    "restore" restores the newest checkpoint there into a fresh state.
    Returns the full parameters and moments (rank 0), this rank's local
    slices, and how many files this rank wrote."""
    grid = grid_of(spec["tp"])
    tc = TrainingConfig(**spec["train"])
    model = model_from(spec, grid)
    opt, _ = build_optimizer(model, tc)
    state = TrainState(model, opt, torch.Generator().manual_seed(0))
    mgr = CheckpointManager(spec["dir"])
    written = []
    write = mgr._write_file
    mgr._write_file = lambda step, payload: (written.append(step), write(step, payload))
    if spec["mode"] == "save":
        cfg = DETRConfig(**spec["config"])
        block, _ = shard_batch(spec["batch"], grid)
        step = make_train_step(model, build_criterion(tc, cfg), grid=grid)
        state, _ = step(state, to_device(block, torch.device("cpu")))
        mgr.save(0, state, extra={"epoch": 0})
    else:
        state, _ = mgr.restore(state)
    sd = opt.state_dict()
    out = {
        "written": len(written),
        "local_params": _numpy_state(dict(model.named_parameters())),
        "local_moments": {opt._state_names[i]: v["exp_avg"].numpy().copy()
                          for i, v in opt.adamw.state_dict()["state"].items()},
        "step": state.step, "updates": opt.updates,
    }
    params = model_params(model)
    if rank == 0:
        out["params"] = _numpy_state(params)
        out["moments"] = {opt._state_names[i]: v["exp_avg"].numpy().copy()
                          for i, v in sd["adamw"]["state"].items()}
    return out


def trainer_runs_rank(rank: int, specs: list) -> list:
    """``train_DETR`` on this rank for each spec in turn (``spec["config"]``
    and ``spec["train"]`` as keyword dicts, ``spec["synthetic"]``) on the
    CPU -> per run its return and, on rank 0, the newest checkpoint's step,
    parameters and frozen statistics."""
    from detr_tpu_torch.train.trainer import train_DETR

    out = []
    for spec in specs:
        config = TrainingConfig(**spec["train"])
        metrics = train_DETR(config, DETRConfig(**spec["config"]), synthetic=spec["synthetic"],
                             device="cpu")
        run = {"metrics": metrics}
        if rank == 0:
            payload = CheckpointManager(config.output_dir).restore_payload()
            run["params"] = _numpy_state(payload["params"])
            run["frozen"] = _numpy_state(payload["frozen"])
            run["step"] = payload["step"]
        out.append(run)
    return out


class LossLog:
    """A tracker that keeps the loss dicts it is given."""

    def __init__(self):
        self.losses = {}

    def log_scalars(self, scalars, step):
        pass

    def log_loss_dict(self, loss_dict, step, split="train"):
        self.losses.update(loss_dict)

    def log_image(self, tag, image, step):
        pass


def validation_rank(rank: int, spec: dict) -> dict:
    """``run_validation`` of the spec's weights over the COCO-format split at
    ``spec["root"]`` (``val_batch_size`` and the rest from ``spec["train"]``)
    -> the metrics this rank returns and the validation losses it logs."""
    from detr_tpu_torch.data.prefetch import DevicePlacement
    from detr_tpu_torch.train.train_step import make_eval_step
    from detr_tpu_torch.train.trainer import BATCH_KEYS, make_val_loader, run_validation

    grid = grid_of(spec["tp"])
    tc = TrainingConfig(**spec["train"])
    cfg = DETRConfig(**spec["config"])
    model = model_from(spec, grid)
    loader = make_val_loader(tc.replace(coco_dataset_root=spec["root"]))
    log = LossLog()
    try:
        step = make_eval_step(model, build_criterion(tc, cfg), grid=grid)
        metrics = run_validation(step, loader, [f"class_{i}" for i in range(cfg.num_classes)],
                                 DevicePlacement(torch.device("cpu"), BATCH_KEYS), tracker=log,
                                 grid=grid)
    finally:
        loader.close()
    return {"metrics": metrics, "losses": log.losses}


def criterion_rank(rank: int, spec: dict) -> dict:
    """The criterion with the data-parallel group on this rank's row block
    of ``spec["outputs"]`` and ``spec["targets"]`` (the matching injected
    from ``spec["qog"]``) -> the loss dict, and the gradient of the total
    loss with respect to the block's logits and boxes."""
    from detr_tpu_torch.losses.criterion import total_loss

    grid = grid_of(1)
    crit = build_criterion(TrainingConfig(), DETRConfig(**spec["config"]))
    n = len(spec["qog"])
    rows = n // grid.dp_size
    lo = grid.dp_rank * rows
    qog = torch.from_numpy(np.asarray(spec["qog"])[lo:lo + rows])
    crit = dataclasses.replace(crit, matcher=lambda *a: qog)
    outputs = {k: torch.from_numpy(np.asarray(v)[lo:lo + rows]).requires_grad_()
               for k, v in spec["outputs"].items()}
    targets = {k: torch.from_numpy(np.asarray(v)[lo:lo + rows]) for k, v in spec["targets"].items()}
    group = grid.dp_group
    losses = crit(outputs, targets, group)
    total_loss(losses).backward()
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": {k: v.grad.numpy().copy() for k, v in outputs.items()}}


def calibration_rank(rank: int, spec: dict) -> dict:
    """The trainer's start-up calibration on this rank: each rank calibrates
    the spec's weights on its own batch ``spec["batches"][rank]``, then
    takes rank 0's statistics -> the frozen-BN buffers."""
    from detr_tpu_torch.parallel import broadcast_from_primary
    from detr_tpu_torch.train.trainer import _calibrate

    grid = grid_of(1)
    model = model_from(spec, grid)
    sample = to_device(spec["batches"][rank], torch.device("cpu"))
    _calibrate(model, sample, None)
    broadcast_from_primary(list(model.buffers()))
    return _numpy_state(dict(model.named_buffers()))


def environment_rank(rank: int, spec: dict) -> dict:
    """What a spawned rank sees: its variables and its grid."""
    grid = grid_of(spec["tp"])
    return {"rank": int(os.environ["RANK"]), "world": grid.world, "dp": grid.dp_size,
            "tp": grid.tp_size, "dp_rank": grid.dp_rank, "tp_rank": grid.tp_rank}


def pause_rank(rank: int, spec: dict) -> dict:
    """Three micro-steps of ``trainer._train_epoch`` whose stub step
    all-reduces over the ranks, as the real step's gradients do.  During
    the first micro-step rank 0 alone finds a fresh pause file (each rank
    looks at a path of its own, so the file appeared between the two
    ranks' reads), released ``spec["hold"]`` seconds later.  -> the time
    each micro-step began and the watchdog's beats."""
    import threading
    import time
    from types import SimpleNamespace

    import torch.distributed as dist

    from detr_tpu_torch.train import trainer
    from detr_tpu_torch.utils import chip_pause
    from detr_tpu_torch.utils.profiling import StepTimer

    grid = make_mesh(0)
    path = os.path.join(spec["dir"], f"pause{rank}")
    chip_pause.PAUSE_FILE = path
    starts, beats, threads = [], [], []

    class Dog:
        def beat(self):
            beats.append(time.monotonic())

    def release():
        time.sleep(spec["hold"])
        os.unlink(path)

    def step(state, batch):
        starts.append(time.monotonic())
        if rank == 0 and len(starts) == 1:
            with open(path, "w") as f:
                f.write("bench")
            threads.append(threading.Thread(target=release))
            threads[0].start()
        loss = torch.ones(())
        dist.all_reduce(loss, group=grid.dp_group)
        state.step += 1
        return state, {"loss": loss, "grad_norm": torch.tensor(0.5)}

    config = TrainingConfig(prefetch_depth=0, log_frequency=100, host_rss_limit_gb=0)
    trainer._train_epoch(config, [{}, {}, {}], lambda b: b, step, SimpleNamespace(step=0), 0,
                         {"backbone": 1e-5, "rest": 1e-4}, StepTimer(1), LossLog(), Dog(),
                         rank == 0, grid.host_group)
    for t in threads:
        t.join()
    return {"starts": starts, "beats": beats}
