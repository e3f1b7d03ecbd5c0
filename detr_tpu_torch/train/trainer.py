"""Training loop, validation and CLI (counterpart of
``detr_tpu/train/trainer.py``, single device).

    python -m detr_tpu_torch.train.trainer --coco-dataset-root datasets/coco-2017
    python -m detr_tpu_torch.train.trainer --synthetic --limit-train-iters 24 --epochs 1

builds DETR-R50 at full width from a seed, its head sized for the dataset's
classes, loads a converted trunk (``DETRConfig.backbone_weights``) or
calibrates the random trunk's frozen-BN statistics on the first batch, and
trains on the card.  The COCO path reads JPEGs through ``CocoDataset`` and
the training augmentation in the loader's worker processes, batches them by
shape bucket as uint8, and a background thread copies each batch to the card
ahead of the step, where it is normalised (``device_normalize``,
``prefetch_depth``).  Per epoch the loop sets the two groups' learning rates
from the schedule, runs the train step on every batch (an AdamW update every
``gradient_accumulation_steps`` micro-steps), logs scalars to tensorboard
every ``log_frequency`` micro-steps, saves the full state every
``checkpoint_epochs`` epochs (``train.checkpoint``) and validates with COCO
mAP every ``eval_epochs`` epochs and after the last (``run_validation``).

When ``output_dir`` already holds a checkpoint, the run restores it in full
and goes on at the epoch after it (a relaunch after a crash); otherwise
``resume_from_checkpoint`` loads another run's weights with a fresh
optimizer, the schedule starting at ``start_epoch``.  The watchdog, the host
RSS limit, the frozen-BN recalibration, the image grids and multi-process
runs are not ported.
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

from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.data.coco import CocoDataset
from detr_tpu_torch.data.loader import BucketedLoader, make_eval_loader
from detr_tpu_torch.data.prefetch import DevicePlacement, prefetch_to_device
from detr_tpu_torch.data.synthetic import SyntheticCocoDataset
from detr_tpu_torch.data.transforms import get_train_transforms, get_val_transforms
from detr_tpu_torch.eval.metrics import DetectionMetrics
from detr_tpu_torch.eval.postprocess import PostProcess
from detr_tpu_torch.models.convert import apply_backbone_weights, load_backbone_npz
from detr_tpu_torch.models.detr import DETR
from detr_tpu_torch.models.resnet import calibrate_frozen_bn
from detr_tpu_torch.ops.image_norm import prepare_image
from detr_tpu_torch.train.checkpoint import CheckpointManager
from detr_tpu_torch.train.optimizer import build_optimizer
from detr_tpu_torch.train.train_step import (
    TrainState,
    build_criterion,
    make_eval_step,
    make_train_step,
)
from detr_tpu_torch.utils.logging import MetricLogger
from detr_tpu_torch.utils.profiling import StepTimer

logger = logging.getLogger(__name__)

# Host batch entries the train and eval steps read.
BATCH_KEYS = ("image", "height", "width", "class_idx", "boxes_normalized", "gt_valid",
              "image_valid")


def _make_loaders(config: TrainingConfig, synthetic: bool):
    """(train batches, val batches, num_classes, class_names)."""
    if synthetic:
        num_classes = 80
        h, w = config.shape_buckets[0]
        # learnable=True paints class-colored rectangles: a --synthetic run
        # can actually learn, not just execute.
        train_ds = SyntheticCocoDataset(
            config.train_batch_size, h, w, max_gt=config.max_gt_boxes,
            num_batches=max(config.limit_train_iters, 4), seed=config.seed, learnable=True,
        )
        val_ds = SyntheticCocoDataset(
            config.val_batch_size, h, w, max_gt=config.max_gt_boxes,
            num_batches=max(config.limit_val_iters, 2), seed=config.seed + 1, learnable=True,
        )
        return train_ds, val_ds, num_classes, [f"class_{i}" for i in range(num_classes)]
    # normalize=False: the workers ship uint8 (a quarter of the bytes), which
    # goes to the card as it is with device_normalize, or is normalised when
    # the batch is assembled otherwise.
    train_dataset = CocoDataset(
        config.coco_dataset_root, "train",
        get_train_transforms(seed=config.seed, normalize=False,
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
        image_dtype="uint8" if config.device_normalize else "float32",
    )
    return train_loader, val_loader, train_dataset.num_classes, train_dataset.class_names


def make_val_loader(config: TrainingConfig) -> BucketedLoader:
    """The validation split's loader, as the JAX trainer builds it: the val
    transform at ``val_min_size``/``val_max_size``, ``eval_shape`` and its
    transpose, ``val_batch_size``, in order with the last batch padded."""
    dataset = CocoDataset(
        config.coco_dataset_root, "validation",
        get_val_transforms(normalize=False, min_size=config.val_min_size,
                           max_size=config.val_max_size),
    )
    return make_eval_loader(
        dataset,
        config.val_batch_size,
        max_gt=config.max_gt_boxes,
        num_workers=config.num_workers,
        shape=config.eval_shape,
        image_dtype="uint8" if config.device_normalize else "float32",
    )


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """One host batch's ``BATCH_KEYS`` on ``device``, through the prefetch
    placement (the loop's one copy path)."""
    return DevicePlacement(device, BATCH_KEYS)(batch)


def resolve_device(device: Optional[str]) -> torch.device:
    """The card unless the caller asks for the CPU; no card is an error."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on a CUDA card; pass device='cpu' for the CPU")
    return device


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
    epoch ran)."""
    device = resolve_device(device)
    os.makedirs(config.output_dir, exist_ok=True)
    tracker = MetricLogger(os.path.join(config.output_dir, "logs"))
    ckpt = CheckpointManager(config.output_dir, config.checkpoint_total_limit)
    train_loader, val_loader, num_classes, class_names = _make_loaders(config, synthetic)
    logger.info("%d classes: %s ...", num_classes, ", ".join(class_names[:5]))
    # mixed_precision is the one precision authority under the trainer.
    detr_config = detr_config.replace(
        num_classes=num_classes,
        dtype="bfloat16" if config.mixed_precision == "bf16" else "float32",
    )

    model = DETR(detr_config)
    model.reset_parameters(torch.Generator().manual_seed(config.seed))
    model.to(device)
    criterion = build_criterion(config, detr_config)
    optimizer, schedules = build_optimizer(model, config, start_epoch=config.start_epoch)
    logger.info("number of params: %d", sum(p.numel() for p in optimizer.params))
    logger.info(
        "Gradient accumulation steps: %d (effective batch %d = %d micro-steps x %d)",
        config.gradient_accumulation_steps,
        config.gradient_accumulation_steps * config.train_batch_size,
        config.gradient_accumulation_steps, config.train_batch_size,
    )
    state = TrainState(model, optimizer, torch.Generator().manual_seed(config.seed))
    placement = DevicePlacement(device, BATCH_KEYS)
    # A checkpoint in our own output_dir (a relaunch after a crash) is
    # restored in full below: the trunk's weights or calibration would be
    # overwritten, so neither is done.
    will_full_restore = ckpt.latest_step() is not None
    try:
        if will_full_restore:
            pass
        elif detr_config.backbone_weights:
            apply_backbone_weights(model, *load_backbone_npz(detr_config.backbone_weights))
            logger.info("loaded backbone weights from %s", detr_config.backbone_weights)
        else:
            # A random trunk: calibrate the frozen-BN statistics on the first
            # batch, normalised as the step sees it (identity statistics make
            # its activations explode).
            sample = placement(next(iter(train_loader)))
            calibrate_frozen_bn(model.backbone.backbone,
                                prepare_image(sample["image"], sample["height"], sample["width"]))
            del sample
            logger.info("calibrated frozen-BN statistics (no pretrained backbone)")

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

        train_step = make_train_step(model, criterion)
        eval_step = make_eval_step(model, criterion)
        timer = StepTimer(config.train_batch_size)
        val_metrics: dict[str, float] = {}
        for epoch in range(first_epoch, config.epochs):
            epoch_t0 = time.time()
            if hasattr(train_loader, "epoch"):
                # The shuffle follows the epoch's index, whatever iterated
                # the loader before (the calibration batch, an earlier run).
                train_loader.epoch = epoch
            # Per-epoch LR step (the reference's scheduler.step()).
            optimizer.set_learning_rates({g: s(epoch) for g, s in schedules.items()})
            _train_epoch(config, train_loader, placement, train_step, state, epoch,
                         optimizer.get_learning_rates(), timer, tracker)
            if epoch % config.checkpoint_epochs == 0:
                t0 = time.perf_counter()
                ckpt.save(epoch, state, extra={"epoch": epoch})
                logger.info("saved checkpoint %d in %.1fs", epoch, time.perf_counter() - t0)
            if epoch % config.eval_epochs == 0 or epoch == config.epochs - 1:
                val_metrics = run_validation(eval_step, val_loader, class_names, placement,
                                             tracker, config.limit_val_iters, state.step)
                logger.info("Validation [epoch %d]: AP %.3f AP50 %.3f", epoch,
                            val_metrics.get("AP", 0.0), val_metrics.get("AP50", 0.0))
                tracker.log_scalars({f"Average Precision/{k}": v for k, v in val_metrics.items()
                                     if k in ("AP", "AP50", "AP75")}, state.step)
                tracker.log_scalars({f"Average Precision by Object Size/{k}": v
                                     for k, v in val_metrics.items()
                                     if k in ("AP-large", "AP-medium", "AP-small")}, state.step)
            logger.info("epoch %d done in %.1fs", epoch, time.time() - epoch_t0)
    finally:
        for loader in (train_loader, val_loader):
            if hasattr(loader, "close"):
                loader.close()  # the worker processes
        tracker.close()
    return val_metrics


def _train_epoch(config, train_loader, placement, train_step, state, epoch, applied, timer,
                 tracker) -> None:
    """One epoch of micro-steps.  Batches come through ``prefetch_to_device``
    at ``prefetch_depth``, or are made and copied when the step asks for
    them at depth 0."""
    if config.prefetch_depth > 0:
        batches = prefetch_to_device(train_loader, placement.place, config.prefetch_depth,
                                     placement.take)
    else:
        batches = (placement(b) for b in train_loader)
    pending_loss = None
    try:
        for step_i, batch in enumerate(batches):
            state, metrics = train_step(state, batch)
            del batch
            # Read the previous step's loss while this one runs: a NaN
            # tripwire that also bounds how far the host runs ahead.
            if pending_loss is not None:
                prev = float(pending_loss)
                if not math.isfinite(prev):
                    raise FloatingPointError(
                        f"non-finite training loss {prev} at step {state.step - 2}")
            pending_loss = metrics["loss"]
            perf = timer.tick()
            if step_i % config.log_frequency == 0:
                host = _host_floats(metrics)
                global_step = state.step - 1
                tracker.log_scalars({
                    **perf,
                    "lr/backbone": applied["backbone"],
                    "lr/transformer": applied["rest"],
                    "loss/total/train": host["loss"],
                    "grad_norm": host["grad_norm"],
                    "epoch": epoch,
                }, global_step)
                tracker.log_loss_dict({k: v for k, v in host.items()
                                       if k not in ("loss", "grad_norm")}, global_step, "train")
                logger.info(
                    "epoch %d step %d loss %.4f grad_norm %.4f lr backbone %.3g transformer %.3g",
                    epoch, step_i, host["loss"], host["grad_norm"], applied["backbone"],
                    applied["rest"],
                )
            if 0 < config.limit_train_iters <= step_i + 1:
                break
    finally:
        batches.close()  # stops the prefetch thread when the epoch is cut


def run_validation(
    eval_step: Callable,
    val_loader,
    class_names,
    placement: DevicePlacement,
    tracker: Optional[MetricLogger] = None,
    limit_val_iters: int = 0,
    global_step: int = 0,
) -> dict[str, float]:
    """The validation loop (``detr_tpu/train/trainer.py::run_validation``,
    one device): ``eval_step(batch) -> (outputs, loss dict)`` on each batch
    placed on the device; losses averaged by image count with the loader's
    padding left out (the criterion drops it by ``image_valid``, the count
    by ``pad_count``); ``PostProcess`` on the last decoder layer only; COCO
    mAP by ``DetectionMetrics``.  Returns ``DetectionMetrics.compute()``."""
    post_process = PostProcess(class_names)
    metrics = DetectionMetrics(class_names)
    avg_loss: dict[str, float] = {}
    total_images = 0
    for step_i, batch in enumerate(val_loader):
        if limit_val_iters > 0 and step_i >= limit_val_iters:
            break
        pad = int(batch.get("pad_count", 0))
        device_batch = placement(batch)
        outputs, loss_dict = eval_step(device_batch)
        n_img = batch["image"].shape[0] - pad
        total_images += n_img
        for k, v in _host_floats(loss_dict).items():
            avg_loss[k] = avg_loss.get(k, 0.0) + v * n_img
        preds = post_process(outputs["pred_logits"][:, -1], outputs["pred_boxes"][:, -1],
                             device_batch["height"], device_batch["width"])
        metrics.update(preds, batch)

    if total_images and avg_loss and tracker is not None:
        tracker.log_scalars({"loss/total/val": sum(
            v / total_images for k, v in avg_loss.items() if k.startswith("loss"))}, global_step)
        tracker.log_loss_dict({k: v / total_images for k, v in avg_loss.items()}, global_step,
                              "val")
    return metrics.compute()


def get_args(argv=None) -> argparse.Namespace:
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
    parser.add_argument("--limit-train-iters", type=int, default=0)
    parser.add_argument("--limit-val-iters", type=int, default=0)
    parser.add_argument("--start-epoch", type=int, default=0)
    parser.add_argument(
        "--resume-from-checkpoint", type=str, default=None,
        help="another run's output dir: load its newest weights, fresh optimizer",
    )
    parser.add_argument("--eval-epochs", type=int, default=10)
    parser.add_argument(
        "--synthetic", action="store_true", help="train on synthetic data (smoke)"
    )
    parser.add_argument(
        "--tiny", action="store_true", help="tiny model + 64x64 buckets (smoke runs)"
    )
    parser.add_argument(
        "--no-photometric-distort", action="store_true",
        help="drop the training augmentation's photometric distort (needed to learn the "
             "synthetic colour-coded dataset, whose class is the colour)",
    )
    parser.add_argument("--cpu", action="store_true", help="train on the CPU")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO, force=True, format="%(asctime)s %(levelname)s:%(name)s:%(message)s"
    )
    args = get_args(argv)
    logger.info("argv: %s", " ".join(sys.argv))
    config = TrainingConfig(
        output_dir=args.output_dir,
        coco_dataset_root=args.coco_dataset_root,
        photometric_distort=not args.no_photometric_distort,
        train_batch_size=args.train_batch_size,
        cumulative_train_batch_size=args.cumulative_train_batch_size,
        val_batch_size=args.val_batch_size,
        seed=args.seed,
        epochs=args.epochs,
        limit_train_iters=args.limit_train_iters,
        limit_val_iters=args.limit_val_iters,
        start_epoch=args.start_epoch,
        resume_from_checkpoint=args.resume_from_checkpoint,
        eval_epochs=args.eval_epochs,
    )
    detr_config = DETRConfig()
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
    train_DETR(config, detr_config, synthetic=args.synthetic,
               device="cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
