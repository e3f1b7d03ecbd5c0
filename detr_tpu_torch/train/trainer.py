"""Training loop, validation and CLI (counterpart of
``detr_tpu/train/trainer.py``).

    python -m detr_tpu_torch.train.trainer --coco-dataset-root datasets/coco-2017
    python -m detr_tpu_torch.train.trainer --synthetic --limit-train-iters 24 --epochs 1
    python -m detr_tpu_torch.train.trainer --architecture deformable_detr --synthetic \
        --limit-train-iters 24 --epochs 1
    python -m detr_tpu_torch.train.trainer --device-resize --backbone resnet101 \
        --bn-recalibrate-epochs 1 --coco-dataset-root datasets/coco-2017
    torchrun --nproc-per-node 4 -m detr_tpu_torch.train.trainer \
        --num-devices 4 --model-parallel 2 --coco-dataset-root datasets/coco-2017

builds DETR-R50 (or, with ``--architecture deformable_detr``, Deformable
DETR-R50; ``models.build_detector``) at full width from a seed, its head
sized for the dataset's classes, loads a converted trunk
(``DETRConfig.backbone_weights``) or calibrates the random trunk's frozen-BN statistics on the first batch (kept:
``bn_recalibrate_epochs`` recalibrates on it), and trains on the card.  The
COCO path reads JPEGs through ``CocoDataset`` and the training augmentation
in the loader's worker processes, batches them by shape bucket as uint8, and
a background thread copies each batch to the card ahead of the step, where
it is normalised (``device_normalize``, ``prefetch_depth``); with
``device_resize`` the batches hold the source images, which the step
resamples on the card (``ops.device_resize``).  Per epoch the loop sets the two groups' learning rates
from the schedule, runs the train step on every batch (an AdamW update every
``gradient_accumulation_steps`` micro-steps), logs scalars to tensorboard
every ``log_frequency`` micro-steps, saves the full state every
``checkpoint_epochs`` epochs (``train.checkpoint``) and validates with COCO
mAP every ``eval_epochs`` epochs and after the last (``run_validation``).

When ``output_dir`` already holds a checkpoint, the run restores it in full
and goes on at the epoch after it (a relaunch after a crash); otherwise
``resume_from_checkpoint`` loads another run's weights with a fresh
optimizer, the schedule starting at ``start_epoch``.  A watchdog
(``utils.watchdog``) exits with code 42 when no micro-step, validation batch
or checkpoint completes for ``watchdog_secs``, and the host RSS limit
(``host_rss_limit_gb``) exits 42 too, after the epoch's checkpoint or, past
1.25x the limit, at once: a retry wrapper relaunches, and the relaunch
auto-restores.  Before each micro-step and validation batch the loop honours
a benchmark's request for the card (``utils.chip_pause``): it reads its
pending loss, which drains the card, and idles, beating the watchdog, until
the request is gone; ranks decide together (a rank that idled alone would
leave the others blocked in the step's collectives).  Validations at epochs that are multiples of
``save_image_epochs`` log the first batch's ground truth and predictions as
image grids (``viz``).

Several ranks (``parallel``; one process per card under torchrun, gloo or
NCCL): ``num_devices`` is the world size (0: every rank) and
``model_parallel`` the size of the tensor-parallel groups, so the
data-parallel size is world / model_parallel.  ``train_batch_size`` is per
data-parallel rank, as in the JAX package's multi-process runs: the global
batch of a micro-step is ``train_batch_size * dp``, each data-parallel rank
reading its shard of the dataset (``BucketedLoader(shard=...)``; the
synthetic batches are cut from one global batch).  Accumulation counts
micro-steps as on one process: an update every ``cumulative_train_batch_size
// train_batch_size`` micro-steps, from the mean of their global gradients,
so an update sees that many times ``train_batch_size * dp`` images; the log
line says both, beside the JAX trainer's own.  The frozen-BN statistics are
rank 0's, broadcast at the start and at each recalibration.  Rank 0 alone
writes tensorboard, the logs of the loop, the checkpoint file and the mAP;
validation pads each batch to a multiple of dp, runs each rank's row block,
and gathers the last layer to rank 0.  Every other rank's ``train_DETR``
returns {}.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from detr_tpu_torch.config import DeformableDETRConfig, DETRConfig, TrainingConfig
from detr_tpu_torch.data.coco import CocoDataset
from detr_tpu_torch.data.loader import BucketedLoader, make_eval_loader
from detr_tpu_torch.data.prefetch import DevicePlacement, prefetch_to_device
from detr_tpu_torch.data.synthetic import SyntheticCocoDataset
from detr_tpu_torch.data.transforms import get_train_transforms, get_val_transforms
from detr_tpu_torch.eval.metrics import DetectionMetrics
from detr_tpu_torch.eval.postprocess import PostProcess
from detr_tpu_torch.models.convert import apply_backbone_weights, load_backbone_npz
from detr_tpu_torch.models import build_detector, class_head
from detr_tpu_torch.models.class_head import ClassHead, SoftmaxClassHead
from detr_tpu_torch.models.resnet import calibrate_frozen_bn
from detr_tpu_torch.ops.image_norm import prepare_batch_image
from detr_tpu_torch.parallel import (
    Grid,
    allgather_host,
    broadcast_from_primary,
    data_shard,
    is_primary,
    make_mesh,
    make_mesh_2d,
    shard_batch,
    shard_state,
    shard_state_tp,
    tensor_parallel,
    validate_tp,
)
from detr_tpu_torch.parallel.distributed import local_device, shutdown_distributed
from detr_tpu_torch.train.checkpoint import CheckpointManager
from detr_tpu_torch.train.optimizer import build_optimizer
from detr_tpu_torch.train.train_step import (
    TrainState,
    build_criterion,
    make_eval_step,
    make_train_step,
)
from detr_tpu_torch.utils.chip_pause import pause_requested, wait_while_paused
from detr_tpu_torch.utils.host import host_rss_gb
from detr_tpu_torch.utils.logging import MetricLogger
from detr_tpu_torch.utils.profiling import StepTimer
from detr_tpu_torch.utils.watchdog import WEDGED_EXIT_CODE, Watchdog
from detr_tpu_torch.viz import plot_grid

logger = logging.getLogger(__name__)

# Host batch entries the train and eval steps read.
BATCH_KEYS = ("image", "height", "width", "class_idx", "boxes_normalized", "gt_valid",
              "image_valid", "src_height", "src_width")


class RowBlocks:
    """Each batch of ``batches`` cut to row block ``index`` of ``count``."""

    def __init__(self, batches, index: int, count: int):
        self.batches, self.index, self.count = batches, index, count

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        for batch in self.batches:
            rows = len(batch["image"]) // self.count
            lo = self.index * rows
            yield {k: (v[lo:lo + rows] if np.ndim(v) else v) for k, v in batch.items()}


def _make_loaders(config: TrainingConfig, synthetic: bool, grid: Optional[Grid] = None):
    """(train batches, val batches, num_classes, class_names); the train
    batches are ``grid``'s data-parallel rank's."""
    shard = (0, 1) if grid is None else data_shard(grid)
    if synthetic:
        num_classes = 80
        h, w = config.shape_buckets[0]
        # learnable=True paints class-colored rectangles: a --synthetic run
        # can actually learn, not just execute.  Several ranks cut their
        # rows from the global batch.
        train_ds = SyntheticCocoDataset(
            config.train_batch_size * shard[1], h, w, max_gt=config.max_gt_boxes,
            num_batches=max(config.limit_train_iters, 4), seed=config.seed, learnable=True,
        )
        if shard[1] > 1:
            train_ds = RowBlocks(train_ds, *shard)
        val_ds = SyntheticCocoDataset(
            config.val_batch_size, h, w, max_gt=config.max_gt_boxes,
            num_batches=max(config.limit_val_iters, 2), seed=config.seed + 1, learnable=True,
        )
        return train_ds, val_ds, num_classes, [f"class_{i}" for i in range(num_classes)]
    # normalize=False: the workers ship uint8 (a quarter of the bytes), which
    # goes to the card as it is with device_normalize, or is normalised when
    # the batch is assembled otherwise.  device_resize ships the source
    # pixels instead, and the card resamples them.
    train_dataset = CocoDataset(
        config.coco_dataset_root, "train",
        get_train_transforms(seed=config.seed, normalize=False,
                             emit_source=config.device_resize,
                             photometric=config.photometric_distort),
    )
    val_loader = make_val_loader(config)
    train_loader = BucketedLoader(
        train_dataset,
        config.train_batch_size,
        buckets=config.shape_buckets,
        max_gt=config.max_gt_boxes,
        shuffle=True,
        drop_last=True,
        num_workers=config.num_workers,
        seed=config.seed,
        shard=shard,
        image_dtype="uint8" if config.device_normalize else "float32",
        wire="source" if config.device_resize else "target",
        source_buckets=config.source_buckets,
    )
    return train_loader, val_loader, train_dataset.num_classes, train_dataset.class_names


def _canvas_map(loader) -> Optional[dict]:
    """Source canvas -> target canvas of a device-resize loader; None for the
    target wire and the synthetic data."""
    src = getattr(loader, "source_buckets", None)
    return None if src is None else dict(zip(src, loader.buckets))


def make_val_loader(config: TrainingConfig) -> BucketedLoader:
    """The validation split's loader, as the JAX trainer builds it: the val
    transform at ``val_min_size``/``val_max_size``, ``eval_shape`` and its
    transpose, ``val_batch_size``, in order with the last batch padded; the
    device-resize wire's with ``device_resize``."""
    dataset = CocoDataset(
        config.coco_dataset_root, "validation",
        get_val_transforms(normalize=False, emit_source=config.device_resize,
                           min_size=config.val_min_size, max_size=config.val_max_size),
    )
    return make_eval_loader(
        dataset,
        config.val_batch_size,
        max_gt=config.max_gt_boxes,
        num_workers=config.num_workers,
        shape=config.eval_shape,
        image_dtype="uint8" if config.device_normalize else "float32",
        wire="source" if config.device_resize else "target",
    )


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """One host batch's ``BATCH_KEYS`` on ``device``, through the prefetch
    placement (the loop's one copy path)."""
    return DevicePlacement(device, BATCH_KEYS)(batch)


def resolve_device(device: Optional[str], grid: Optional[Grid] = None) -> torch.device:
    """The card unless the caller asks for the CPU (a rank's own card in a
    multi-rank run); no card is an error."""
    if device is None and grid is not None and grid.dp_group is not None:
        return local_device()
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on a CUDA card; pass device='cpu' for the CPU")
    return device


def make_grid(config: TrainingConfig, detr_config: DETRConfig) -> Grid:
    """The run's grid of ranks (joining torchrun's process group, if any):
    the (data, model) grid under ``model_parallel`` > 1, validated, else the
    data-parallel one."""
    if config.model_parallel > 1:
        grid = make_mesh_2d(config.num_devices, config.model_parallel)
        validate_tp(detr_config, grid)
        return grid
    return make_mesh(config.num_devices)


def build_model(detr_config: DETRConfig, seed: int,
                grid: Optional[Grid] = None) -> torch.nn.Module:
    """The configuration's model (``models.build_detector``: DETR or
    Deformable DETR) from the seed's random init (on the CPU); under a
    tensor-parallel grid, this rank's slices of that same init."""
    model = build_detector(detr_config)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    tp = None if grid is None else tensor_parallel(grid)
    if tp is None:
        return shard_state(model, grid)
    split = build_detector(detr_config, tp)
    split.load_state_dict(shard_state_tp(model.state_dict(), tp), strict=True)
    return split


def _host_floats(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """Scalar tensors as Python floats, through one copy to the host."""
    keys = list(metrics)
    if not keys:
        return {}
    values = torch.stack([metrics[k].detach().float().reshape(()) for k in keys]).tolist()
    return dict(zip(keys, values))


def train_DETR(
    config: TrainingConfig,
    detr_config: DETRConfig,
    synthetic: bool = False,
    device: Optional[str] = None,
) -> dict[str, float]:
    """Full training run; returns the last validation's metrics (empty if no
    epoch ran).  Exits with ``WEDGED_EXIT_CODE`` (``SystemExit``) past the
    host RSS limit; the watchdog exits the process with it."""
    # The watchdog is armed before the first CUDA call: a wedged driver
    # blocks there too.  Its heartbeat file lives in the output dir.
    os.makedirs(config.output_dir, exist_ok=True)
    watchdog = Watchdog(config.watchdog_secs,
                        heartbeat_path=os.path.join(config.output_dir, ".heartbeat"))
    loaders, tracker = [], None
    try:
        grid = make_grid(config, detr_config)
        primary = is_primary()
        device = resolve_device(device, grid)
        tracker = MetricLogger(os.path.join(config.output_dir, "logs") if primary else None)
        ckpt = CheckpointManager(config.output_dir, config.checkpoint_total_limit)
        # Loader set-up is host work that cannot wedge the card.
        watchdog.pause()
        train_loader, val_loader, num_classes, class_names = _make_loaders(config, synthetic,
                                                                           grid)
        loaders = [train_loader, val_loader]
        watchdog.resume()
        logger.info("%d classes: %s ...", num_classes, ", ".join(class_names[:5]))
        # mixed_precision is the one precision authority under the trainer.
        detr_config = detr_config.replace(
            num_classes=num_classes,
            dtype="bfloat16" if config.mixed_precision == "bf16" else "float32",
        )

        model = build_model(detr_config, config.seed, grid)
        model.to(device)
        criterion = build_criterion(config, detr_config)
        optimizer, schedules = build_optimizer(model, config, start_epoch=config.start_epoch)
        logger.info("number of params: %d (this rank's)", sum(p.numel() for p in optimizer.params))
        logger.info(
            "Gradient accumulation steps: %d (EFFECTIVE batch %d = %d micro-steps x %d "
            "per-step; configured cumulative %d floors to a multiple); %d data-parallel x %d "
            "tensor-parallel ranks: %d images per update",
            config.gradient_accumulation_steps,
            config.gradient_accumulation_steps * config.train_batch_size,
            config.gradient_accumulation_steps, config.train_batch_size,
            config.cumulative_train_batch_size, grid.dp_size, grid.tp_size,
            config.gradient_accumulation_steps * config.train_batch_size * grid.dp_size,
        )
        state = TrainState(model, optimizer, torch.Generator().manual_seed(config.seed))
        placement = DevicePlacement(device, BATCH_KEYS)
        train_canvases, eval_canvases = _canvas_map(train_loader), _canvas_map(val_loader)
        # The first batch, kept on the device for the frozen-BN (re)calibration.
        # A restored run takes it too: the loader's first batch of a fresh
        # start, the same as an uninterrupted run's.
        sample = placement(next(iter(train_loader)))
        # A checkpoint in our own output_dir (a relaunch after a crash) is
        # restored in full below: the trunk's weights or calibration would be
        # overwritten, so neither is done.
        will_full_restore = ckpt.latest_step() is not None
        if will_full_restore:
            pass
        elif detr_config.backbone_weights:
            apply_backbone_weights(model, *load_backbone_npz(detr_config.backbone_weights))
            logger.info("loaded backbone weights from %s", detr_config.backbone_weights)
        else:
            # A random trunk: identity statistics make its activations explode.
            _calibrate(model, sample, train_canvases)
            logger.info("calibrated frozen-BN statistics (no pretrained backbone)")
        if not will_full_restore:
            # Each rank calibrated on its own shard's batch; rank 0's hold.
            broadcast_from_primary(list(model.buffers()))

        first_epoch = config.start_epoch
        if config.resume_from_checkpoint and not will_full_restore:
            CheckpointManager(config.resume_from_checkpoint).restore_params_only(state)
            logger.info("loaded model weights from %s", config.resume_from_checkpoint)
        elif will_full_restore:
            if config.resume_from_checkpoint:
                # A relaunch passes the original arguments again: the run's
                # own checkpoints are newer than the seed it started from.
                logger.info(
                    "ignoring --resume-from-checkpoint %s: output dir has its own (newer) "
                    "checkpoints — auto-restoring those instead", config.resume_from_checkpoint)
            state, extra = ckpt.restore(state)
            first_epoch = int(extra.get("epoch", -1)) + 1
            logger.info("auto-restored checkpoint at epoch %d; resuming from epoch %d",
                        first_epoch - 1, first_epoch)

        train_step = make_train_step(model, criterion, canvas_map=train_canvases, grid=grid)
        eval_step = make_eval_step(model, criterion, canvas_map=eval_canvases, grid=grid)
        watchdog.beat()  # start-up done
        timer = StepTimer(config.train_batch_size)
        val_metrics: dict[str, float] = {}
        for epoch in range(first_epoch, config.epochs):
            epoch_t0 = time.time()
            if (config.bn_recalibrate_epochs > 0 and not detr_config.backbone_weights
                    and epoch % config.bn_recalibrate_epochs == 0):
                # Statistics of the current weights; constant within the epoch.
                _calibrate(model, sample, train_canvases)
                broadcast_from_primary(list(model.buffers()))
                logger.info("recalibrated frozen-BN statistics (epoch %d)", epoch)
            if hasattr(train_loader, "epoch"):
                # The shuffle follows the epoch's index, whatever iterated
                # the loader before (the sample batch, an earlier run).
                train_loader.epoch = epoch
            # Per-epoch LR step (the reference's scheduler.step()).
            optimizer.set_learning_rates({g: s(epoch) for g, s in schedules.items()})
            _train_epoch(config, train_loader, placement, train_step, state, epoch,
                         optimizer.get_learning_rates(), timer, tracker, watchdog, primary,
                         grid.host_group)
            if epoch % config.checkpoint_epochs == 0:
                t0 = time.perf_counter()
                ckpt.save(epoch, state, extra={"epoch": epoch})
                watchdog.beat()
                logger.info("saved checkpoint %d in %.1fs", epoch, time.perf_counter() - t0)
                rss = host_rss_gb()
                if config.host_rss_limit_gb > 0 and rss > config.host_rss_limit_gb:
                    # At a checkpointed boundary: the relaunch loses nothing.
                    logger.error("host RSS %.1f GB > limit %.0f GB at epoch %d (saved): exiting "
                                 "%d for a clean relaunch", rss, config.host_rss_limit_gb, epoch,
                                 WEDGED_EXIT_CODE)
                    sys.exit(WEDGED_EXIT_CODE)
            if epoch % config.eval_epochs == 0 or epoch == config.epochs - 1:
                val_metrics = run_validation(
                    eval_step, val_loader, class_names, placement, tracker,
                    config.limit_val_iters, state.step, watchdog=watchdog, grid=grid,
                    log_images=epoch % max(config.save_image_epochs, 1) == 0,
                    head=class_head(detr_config))
                watchdog.resume()  # after the evaluator's host work
                if primary:
                    logger.info("Validation [epoch %d]: AP %.3f AP50 %.3f", epoch,
                                val_metrics.get("AP", 0.0), val_metrics.get("AP50", 0.0))
                tracker.log_scalars({f"Average Precision/{k}": v for k, v in val_metrics.items()
                                     if k in ("AP", "AP50", "AP75")}, state.step)
                tracker.log_scalars({f"Average Precision by Object Size/{k}": v
                                     for k, v in val_metrics.items()
                                     if k in ("AP-large", "AP-medium", "AP-small")}, state.step)
            logger.info("epoch %d done in %.1fs", epoch, time.time() - epoch_t0)
    finally:
        watchdog.stop()
        for loader in loaders:
            if hasattr(loader, "close"):
                loader.close()  # the worker processes
        if tracker is not None:
            tracker.close()
    return val_metrics


def _calibrate(model: torch.nn.Module, sample: dict, canvas_map: Optional[dict]) -> None:
    """The trunk's frozen-BN statistics from the sample batch, normalised (and
    resampled) as the step sees it."""
    calibrate_frozen_bn(model.backbone.backbone, prepare_batch_image(sample, canvas_map))


def _train_epoch(config, train_loader, placement, train_step, state, epoch, applied, timer,
                 tracker, watchdog, primary: bool = True, pause_group=None) -> None:
    """One epoch of micro-steps.  Batches come through ``prefetch_to_device``
    at ``prefetch_depth``, or are made and copied when the step asks for
    them at depth 0.  Only the ``primary`` rank logs.  The ranks of
    ``pause_group`` decide on a chip pause together."""
    if config.prefetch_depth > 0:
        batches = prefetch_to_device(train_loader, placement.place, config.prefetch_depth,
                                     placement.take)
    else:
        batches = (placement(b) for b in train_loader)
    pending_loss = None
    try:
        for step_i, batch in enumerate(batches):
            if pause_requested(group=pause_group):
                # A benchmark asked for the card: drain our work, then idle.
                if pending_loss is not None:
                    float(pending_loss)
                logger.info("chip pause honoured for %.1fs",
                            wait_while_paused(watchdog, group=pause_group))
            state, metrics = train_step(state, batch)
            del batch
            # The host loop's beat: a wedged card still stops it, at the
            # next read of a value below or at the log step.
            watchdog.beat()
            # Read the previous step's loss while this one runs, every
            # dispatch_sync_steps: a NaN tripwire that also bounds how far
            # the host runs ahead.
            if pending_loss is not None and (config.dispatch_sync_steps > 0
                                             and step_i % config.dispatch_sync_steps == 0):
                prev = float(pending_loss)
                watchdog.beat()
                if not math.isfinite(prev):
                    raise FloatingPointError(
                        f"non-finite training loss {prev} at step {state.step - 2}")
            pending_loss = metrics["loss"]
            perf = timer.tick()
            if step_i % config.log_frequency == 0:
                rss = host_rss_gb()
                host = _host_floats(metrics)
                global_step = state.step - 1
                tracker.log_scalars({
                    **perf,
                    "lr/backbone": applied["backbone"],
                    "lr/transformer": applied["rest"],
                    "loss/total/train": host["loss"],
                    "grad_norm": host["grad_norm"],
                    "epoch": epoch,
                    "perf/host_rss_gb": rss,
                }, global_step)
                tracker.log_loss_dict({k: v for k, v in host.items()
                                       if k not in ("loss", "grad_norm")}, global_step, "train")
                (logger.info if primary else logger.debug)(
                    "epoch %d step %d loss %.4f grad_norm %.4f lr backbone %.3g transformer %.3g "
                    "rss %.1fG", epoch, step_i, host["loss"], host["grad_norm"],
                    applied["backbone"], applied["rest"], rss,
                )
                # Far past the limit: exit now, losing at most this epoch,
                # rather than be killed by the kernel (exit 137, no relaunch).
                if config.host_rss_limit_gb > 0 and rss > 1.25 * config.host_rss_limit_gb:
                    logger.error("host RSS %.1f GB > 1.25x limit %.0f GB: exiting %d for a "
                                 "relaunch (checkpoint auto-restore resumes)", rss,
                                 config.host_rss_limit_gb, WEDGED_EXIT_CODE)
                    sys.exit(WEDGED_EXIT_CODE)
            if 0 < config.limit_train_iters <= step_i + 1:
                break
    finally:
        batches.close()  # stops the prefetch thread when the epoch is cut


def pad_batch_to_multiple(batch: dict, pad: int, multiple: int) -> tuple[dict, int]:
    """A host batch's rows padded to the next multiple by repeating the
    last row -> (batch, total pad count).  The rows added get
    ``image_valid=False`` and count in ``pad_count``, so the criterion and
    the metrics skip them as they skip the loader's own padding."""
    B = int(batch["image"].shape[0])
    extra = (-B) % multiple
    if extra == 0:
        return batch, pad
    out = {}
    for k, v in batch.items():
        if k == "pad_count":
            continue
        v = np.asarray(v)
        out[k] = np.concatenate([v, np.repeat(v[-1:], extra, axis=0)], axis=0)
    out["image_valid"] = np.concatenate(
        [np.asarray(batch.get("image_valid", np.ones(B, bool))), np.zeros(extra, bool)])
    out["pad_count"] = np.int32(pad + extra)
    return out, pad + extra


def run_validation(
    eval_step: Callable,
    val_loader,
    class_names,
    placement: DevicePlacement,
    tracker: Optional[MetricLogger] = None,
    limit_val_iters: int = 0,
    global_step: int = 0,
    watchdog: Optional[Watchdog] = None,
    grid: Optional[Grid] = None,
    log_images: bool = True,
    head: ClassHead = SoftmaxClassHead(),
) -> dict[str, float]:
    """The validation loop (``detr_tpu/train/trainer.py::run_validation``):
    ``eval_step(batch) -> (outputs, loss dict)`` on each batch placed on the
    device; losses averaged by image count with the loader's padding left
    out (the criterion drops it by ``image_valid``, the count by
    ``pad_count``); ``PostProcess`` on the last decoder layer only; COCO mAP
    by ``DetectionMetrics``.  Returns ``DetectionMetrics.compute()``.
    ``watchdog`` beats per batch and is paused for the evaluator's host
    work; the caller resumes it.  With ``log_images`` and a ``tracker``, the
    first batch's ground truth and its predictions scored 0.5 or more go to
    the tracker as two image grids ("val-ground-truth", "val-predictions";
    at most 25 images, boxes in the host image's pixels).

    On a ``grid`` of ranks every rank reads the whole validation split: each
    batch is padded to a multiple of the data-parallel size, each
    data-parallel rank runs its contiguous row block (``eval_step`` built
    with the grid sums the losses over them), and the last layer's logits
    and boxes are gathered to rank 0, which postprocesses them and returns
    the metrics; the other ranks return {}.  ``head``: the model's class
    head (``models.class_head``), which ``PostProcess`` reads the logits
    with."""
    ranks = grid is not None and grid.dp_group is not None
    primary = is_primary()
    post_process = PostProcess(class_names, head)
    metrics = DetectionMetrics(class_names)
    avg_loss: dict[str, float] = {}
    total_images = 0
    for step_i, batch in enumerate(val_loader):
        if limit_val_iters > 0 and step_i >= limit_val_iters:
            break
        pause_group = None if grid is None else grid.host_group
        if pause_requested(group=pause_group):
            # each batch is read back below, so nothing of ours is in flight
            wait_while_paused(watchdog, group=pause_group)
        pad = int(batch.get("pad_count", 0))
        block = batch
        if ranks:
            batch, pad = pad_batch_to_multiple(batch, pad, grid.dp_size)
            block, _ = shard_batch(batch, grid)
        device_batch = placement(block)
        outputs, loss_dict = eval_step(device_batch)
        n_img = batch["image"].shape[0] - pad
        total_images += n_img
        for k, v in _host_floats(loss_dict).items():
            avg_loss[k] = avg_loss.get(k, 0.0) + v * n_img
        if watchdog is not None:
            watchdog.beat()  # the read above waited for this batch's work
        if ranks:
            last = allgather_host({"logits": outputs["pred_logits"][:, -1],
                                   "boxes": outputs["pred_boxes"][:, -1]}, grid.dp_group)
            if not primary:
                continue  # the metrics are rank 0's host work
            preds = post_process(last["logits"], last["boxes"],
                                 torch.as_tensor(batch["height"]), torch.as_tensor(batch["width"]))
        else:
            preds = post_process(outputs["pred_logits"][:, -1], outputs["pred_boxes"][:, -1],
                                 device_batch["height"], device_batch["width"])
        metrics.update(preds, batch)
        if step_i == 0 and tracker is not None and log_images:
            _log_image_grids(tracker, batch, preds, n_img, class_names, global_step)

    if total_images and avg_loss and tracker is not None:
        tracker.log_scalars({"loss/total/val": sum(
            v / total_images for k, v in avg_loss.items() if k.startswith("loss"))}, global_step)
        tracker.log_loss_dict({k: v / total_images for k, v in avg_loss.items()}, global_step,
                              "val")
    if watchdog is not None:
        watchdog.pause()  # the evaluator below is host work only
    return metrics.compute() if primary else {}


def _log_image_grids(tracker, batch: dict, preds: list, n_img: int, class_names,
                     global_step: int) -> None:
    """The first validation batch's ground truth (green) and predictions
    scored 0.5 or more (red) as two grids of at most 25 images.  On the
    device-resize wire the host images are the sources, and the boxes,
    which are in the resized image's pixels, are scaled back to them."""
    gt_items, pred_items = [], []
    source_wire = "src_height" in batch
    for i in range(min(n_img, 25)):
        img = np.asarray(batch["image"][i])
        to_src = np.ones(4, np.float32)
        if source_wire:
            sx = int(batch["src_width"][i]) / max(int(batch["width"][i]), 1)
            sy = int(batch["src_height"][i]) / max(int(batch["height"][i]), 1)
            to_src = np.array([sx, sy, sx, sy], np.float32)
        valid = np.asarray(batch["gt_valid"][i])
        gt_items.append({
            "image": img,
            "boxes": np.asarray(batch["boxes"][i])[valid] * to_src,
            "class_names": [class_names[c] for c in np.asarray(batch["class_idx"][i])[valid]],
        })
        keep = preds[i]["scores"] >= 0.5
        pred_items.append({
            "image": img,
            "boxes": preds[i]["boxes"][keep] * to_src,
            "scores": preds[i]["scores"][keep],
            "class_names": [n for n, k in zip(preds[i].get("class_names", []), keep) if k],
        })
    tracker.log_image("val-ground-truth", plot_grid(gt_items, box_color="green"), global_step)
    tracker.log_image("val-predictions", plot_grid(pred_items, box_color="red"), global_step)


def get_args(argv=None) -> argparse.Namespace:
    """The JAX trainer's flags with its defaults, and ``--cpu``."""
    parser = argparse.ArgumentParser("Train DETR with the PyTorch port.")
    parser.add_argument("--output-dir", type=str, default="runs/detr")
    parser.add_argument("--coco-dataset-root", type=str, default="datasets/coco-2017")
    parser.add_argument("--train-batch-size", type=int, default=5)
    parser.add_argument(
        "--cumulative-train-batch-size", type=int, default=64,
        help="effective batch via gradient accumulation",
    )
    parser.add_argument("--val-batch-size", type=int, default=25)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--lr", type=float, default=None,
                        help="transformer LR (default TrainingConfig.lr)")
    parser.add_argument(
        "--lr-backbone", type=float, default=None,
        help="backbone LR (default TrainingConfig.lr_backbone, 10x below --lr, for a "
             "pretrained trunk; a trunk trained from scratch needs --lr's)",
    )
    parser.add_argument("--lr-warmup-epochs", type=int, default=5)
    parser.add_argument("--lr-hold-max-epochs", type=int, default=35)
    # The matcher's costs and the loss coefficients; None keeps the
    # TrainingConfig defaults (the reference's).
    for flag in ("--set-cost-class", "--set-cost-bbox", "--set-cost-giou",
                 "--label-ce-loss-coef", "--bbox-loss-coef", "--giou-loss-coef", "--eos-coef"):
        parser.add_argument(flag, type=float, default=None)
    parser.add_argument("--gradient-max-norm", type=float, default=None,
                        help="global-norm gradient clip (<= 0 disables)")
    parser.add_argument("--limit-train-iters", type=int, default=0)
    parser.add_argument("--limit-val-iters", type=int, default=0)
    parser.add_argument("--start-epoch", type=int, default=0)
    parser.add_argument(
        "--resume-from-checkpoint", type=str, default=None,
        help="another run's output dir: load its newest weights, fresh optimizer",
    )
    parser.add_argument("--eval-epochs", type=int, default=10)
    parser.add_argument("--backbone", type=str, default="resnet50",
                        help="resnet50 or resnet101")
    parser.add_argument(
        "--architecture", choices=("detr", "deformable_detr"), default="detr",
        help="deformable_detr: Deformable DETR at its published widths (4 levels, 300 "
             "queries, FFN 1024; models.deformable_detr), the focal loss and cost, class "
             "coefficients 2 unless given",
    )
    parser.add_argument("--num-devices", type=int, default=0,
                        help="ranks of the run (0: every rank torchrun started)")
    parser.add_argument(
        "--model-parallel", type=int, default=1,
        help="tensor-parallel group size: shards attention heads + FFN hidden Megatron-style "
             "(parallel/tp.py); heads must divide by it",
    )
    parser.add_argument(
        "--synthetic", action="store_true", help="train on synthetic data (smoke)"
    )
    parser.add_argument(
        "--dropout", type=float, default=None,
        help="hidden and attention dropout (default 0.1)",
    )
    parser.add_argument(
        "--tiny", action="store_true", help="tiny model + 64x64 buckets (smoke runs)"
    )
    parser.add_argument(
        "--mid", action="store_true",
        help="mid-size model (d=128, 6+6 layers, 4 heads, 50 queries, 48 GT slots) at full "
             "input resolution",
    )
    parser.add_argument("--cpu", action="store_true", help="train on the CPU")
    parser.add_argument(
        "--device-resize", action="store_true",
        help="ship source-resolution uint8 and resample to the augmented size on the card "
             "(ops.device_resize): 2.5-3.3x fewer bytes to copy, no resample on the host",
    )
    parser.add_argument(
        "--no-photometric-distort", action="store_true",
        help="drop the training augmentation's photometric distort (needed to learn the "
             "synthetic colour-coded dataset, whose class is the colour)",
    )
    parser.add_argument(
        "--bn-recalibrate-epochs", type=int, default=0,
        help="recalibrate a random trunk's frozen-BN statistics every N epochs (0: once, "
             "at the start)",
    )
    parser.add_argument(
        "--val-min-size", type=int, default=None,
        help="the val transform's shortest side (default 800); the longest side and the "
             "eval canvas scale with it unless --eval-shape is given",
    )
    parser.add_argument("--eval-shape", type=str, default=None,
                        help="eval canvas HxW, e.g. 384x640 (its transpose is added)")
    parser.add_argument("--shape-buckets", type=str, default=None,
                        help="training buckets, e.g. 832x1344,1344x832,1056x1056")
    return parser.parse_args(argv)


def derive_val_envelope(val_min_size: int) -> tuple[int, int, tuple[int, int]]:
    """(min_size, max_size, eval canvas) for a val shortest side: the longest
    side keeps 1333/800 of it, and the canvas keeps 800x1344's proportions,
    each side rounded up to /32."""
    vms = val_min_size
    max_size = int(round(vms * 1333 / 800))
    canvas = (int(-(-vms // 32) * 32), int(-(-int(round(vms * 1344 / 800)) // 32) * 32))
    return vms, max_size, canvas


def parse_shape_buckets(spec: str) -> tuple[tuple[int, int], ...]:
    """"832x1344,1344x832" -> ((832, 1344), (1344, 832))."""
    buckets = []
    for part in spec.split(","):
        h, w = part.lower().split("x")
        buckets.append((int(h), int(w)))
    return tuple(buckets)


def configs_from_args(args: argparse.Namespace) -> tuple[TrainingConfig, DETRConfig]:
    """The two configurations the flags give, in the JAX trainer's order:
    the buckets, the val envelope, the eval shape, the rates and
    coefficients, the model; then ``--mid`` and, last, ``--tiny``."""
    config = TrainingConfig(
        output_dir=args.output_dir,
        coco_dataset_root=args.coco_dataset_root,
        train_batch_size=args.train_batch_size,
        cumulative_train_batch_size=args.cumulative_train_batch_size,
        val_batch_size=args.val_batch_size,
        seed=args.seed,
        epochs=args.epochs,
        lr_warmup_epochs=args.lr_warmup_epochs,
        lr_hold_max_epochs=args.lr_hold_max_epochs,
        limit_train_iters=args.limit_train_iters,
        limit_val_iters=args.limit_val_iters,
        start_epoch=args.start_epoch,
        resume_from_checkpoint=args.resume_from_checkpoint,
        eval_epochs=args.eval_epochs,
        device_resize=args.device_resize,
        photometric_distort=not args.no_photometric_distort,
        bn_recalibrate_epochs=args.bn_recalibrate_epochs,
        num_devices=args.num_devices,
        model_parallel=args.model_parallel,
    )
    if args.shape_buckets:
        config = config.replace(shape_buckets=parse_shape_buckets(args.shape_buckets))
    if args.val_min_size is not None:
        vms, vmax, canvas = derive_val_envelope(args.val_min_size)
        config = config.replace(val_min_size=vms, val_max_size=vmax, eval_shape=canvas)
    if args.eval_shape:
        config = config.replace(eval_shape=parse_shape_buckets(args.eval_shape)[0])
    if args.architecture == "deformable_detr":
        # the reference code's focal recipe: class cost and coefficient 2
        config = config.replace(set_cost_class=2.0, label_ce_loss_coef=2.0)
    for field in ("lr", "lr_backbone", "set_cost_class", "set_cost_bbox", "set_cost_giou",
                  "label_ce_loss_coef", "bbox_loss_coef", "giou_loss_coef", "eos_coef",
                  "gradient_max_norm"):
        value = getattr(args, field)
        if value is not None:
            config = config.replace(**{field: value})
    model_config = DeformableDETRConfig if args.architecture == "deformable_detr" else DETRConfig
    detr_config = model_config(backbone=args.backbone)
    if args.dropout is not None:
        detr_config = detr_config.replace(hidden_dropout_prob=args.dropout,
                                          attention_probs_dropout_prob=args.dropout)
    if args.mid:
        detr_config = detr_config.replace(
            num_object_queries=50,
            num_attention_heads=4,
            hidden_size=128,
            ffn_scale_factor=8,
        )
        # The matcher needs G <= Q: 48 GT slots under the 50 queries.
        config = config.replace(max_gt_boxes=48)
    if args.tiny:
        detr_config = detr_config.replace(
            num_object_queries=8,
            num_encoder_layers=1,
            num_decoder_layers=2,
            num_attention_heads=2,
            hidden_size=16,
            ffn_scale_factor=2,
        )
        config = config.replace(
            shape_buckets=((64, 64),),
            max_gt_boxes=8,
            cumulative_train_batch_size=config.train_batch_size,
            mixed_precision="no",  # fp32 on smoke runs
            eval_shape=(64, 64),
        )
    return config, detr_config


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO, force=True, format="%(asctime)s %(levelname)s:%(name)s:%(message)s"
    )
    args = get_args(argv)
    logger.info("argv: %s", " ".join(sys.argv if argv is None else argv))
    config, detr_config = configs_from_args(args)
    try:
        train_DETR(config, detr_config, synthetic=args.synthetic,
                   device="cpu" if args.cpu else None)
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
