"""Tensorboard scalars with the reference's panel names (counterpart of
``detr_tpu/utils/logging.py``).

``format_loss_for_logging`` flattens a loss dict into the reference's
tensorboard tags (per-loss panels with train/val curves, per-decoder-layer
losses, cardinality and classification errors, the liftoff diagnostics).
``MetricLogger`` writes them through ``torch.utils.tensorboard`` where the
``tensorboard`` package imports, and is a no-op otherwise, or when the writer
cannot be made, so that training never dies on logging.  ``log_image`` is a
no-op: the image grids (``detr_tpu/viz``) are not ported.
"""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger(__name__)


def format_loss_for_logging(loss_dict: dict, split: str = "train") -> dict:
    """loss dict -> {tag: scalar} with the reference's panel names."""
    logs: dict[str, float] = {}
    loss_names = ["loss_label_ce", "loss_l1_bbox", "loss_giou"]
    for loss_name in loss_names:
        short = loss_name[len("loss_") :]
        logs[f"loss/{short}/{split}"] = float(loss_dict[loss_name])
        for k, v in loss_dict.items():
            if k.startswith(loss_name):
                logs[f"loss by decoder layer/{short}-{split}/{k}"] = float(v)

    logs[f"Incorrect Number of Object Predictions/cardinality_error/{split}"] = float(
        loss_dict["cardinality_error"]
    )
    for k, v in loss_dict.items():
        if k.startswith("cardinality_error"):
            logs[
                f"Incorrect Number of Object Predictions/by decoder layer {split}/{k}"
            ] = float(v)

    if "class_error" in loss_dict:
        logs[f"Classification Error (1 - accuracy)/{split}"] = float(
            loss_dict["class_error"]
        )
    for k, v in loss_dict.items():
        if k.startswith("diag_"):
            logs[f"Liftoff Diagnostics/{k[len('diag_'):]}/{split}"] = float(v)
    return logs


class MetricLogger:
    """Scalars to tensorboard event files under ``log_dir`` (None: off)."""

    def __init__(self, log_dir: Optional[str]):
        self.writer = None
        if log_dir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logger.info("tensorboard is not installed: metrics are not written to %s", log_dir)
            return
        try:
            self.writer = SummaryWriter(log_dir)
        except OSError as e:
            logger.info("no tensorboard writer for %s (%s): metrics are not written", log_dir, e)

    def log_scalars(self, scalars: dict, step: int) -> None:
        if self.writer is None:
            return
        for tag, value in scalars.items():
            self.writer.add_scalar(tag, float(value), step)

    def log_loss_dict(self, loss_dict: dict, step: int, split: str = "train") -> None:
        self.log_scalars(format_loss_for_logging(loss_dict, split), step)

    def log_image(self, tag: str, image, step: int) -> None:
        """No-op: the image grids are not ported."""

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
