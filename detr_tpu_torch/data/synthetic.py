"""Synthetic COCO-like batches (the port's copy of
``detr_tpu/data/synthetic.py``): the same numpy draws in the same order, so
a seed gives the JAX package's batches exactly.

  image            (B, H, W, 3) fp32, normalized-ish, zero padding
  height / width   (B,) int32 valid pixel extents
  image_id         (B,) int32
  class_idx        (B, G_max) int32
  boxes_normalized (B, G_max, 4) fp32 XYXY in [0, 1] of the valid extent
  gt_valid         (B, G_max) bool
"""

from __future__ import annotations

import numpy as np


def _class_palette(num_classes: int) -> np.ndarray:
    """Distinct RGB signatures (in normalized-image sigma units) that paint
    class identity into the pixels of the learnable task."""
    rng = np.random.default_rng(1234)
    return rng.uniform(-2.0, 2.0, size=(num_classes, 3)).astype(np.float32)


def synthetic_batch(
    rng: np.random.Generator,
    batch_size: int = 2,
    height: int = 640,
    width: int = 640,
    max_gt: int = 25,
    num_classes: int = 80,
    mean_boxes: float = 7.0,
    learnable: bool = False,
) -> dict[str, np.ndarray]:
    """``learnable=True`` paints each GT box as a solid class-colored
    rectangle on a low-noise background, a task a detector can learn; the
    default noise images exercise only shapes and throughput."""
    B, G = batch_size, max_gt
    sigma = 0.1 if learnable else 1.0
    images = rng.normal(0.0, sigma, size=(B, height, width, 3)).astype(np.float32)

    heights = rng.integers(height // 2, height + 1, size=B).astype(np.int32)
    widths = rng.integers(width // 2, width + 1, size=B).astype(np.int32)
    for b in range(B):  # zero padding, as the collate pads
        images[b, heights[b]:, :, :] = 0.0
        images[b, :, widths[b]:, :] = 0.0

    n_boxes = np.minimum(rng.poisson(mean_boxes, size=B), G).astype(np.int32)
    gt_valid = np.arange(G)[None, :] < n_boxes[:, None]

    cx = rng.uniform(0.1, 0.9, size=(B, G))
    cy = rng.uniform(0.1, 0.9, size=(B, G))
    w = rng.uniform(0.02, 0.4, size=(B, G))
    h = rng.uniform(0.02, 0.4, size=(B, G))
    x0 = np.clip(cx - w / 2, 0, 1)
    y0 = np.clip(cy - h / 2, 0, 1)
    x1 = np.clip(cx + w / 2, 0, 1)
    y1 = np.clip(cy + h / 2, 0, 1)
    boxes = np.stack([x0, y0, x1, y1], axis=-1).astype(np.float32)
    boxes = np.where(gt_valid[..., None], boxes, 0.0)

    class_idx = np.where(gt_valid, rng.integers(0, num_classes, size=(B, G)), 0).astype(np.int32)

    scale = np.stack([widths, heights, widths, heights], axis=-1).astype(np.float32)
    boxes_abs = boxes * scale[:, None, :]

    if learnable:
        pal = _class_palette(num_classes)
        for b in range(B):
            for g in range(int(n_boxes[b])):
                xa, ya, xb, yb = boxes_abs[b, g]
                images[
                    b, int(ya): max(int(yb), int(ya) + 2),
                    int(xa): max(int(xb), int(xa) + 2),
                ] = pal[class_idx[b, g]]

    return {
        "image": images,
        "height": heights,
        "width": widths,
        "image_id": np.arange(1, B + 1, dtype=np.int32),
        "class_idx": class_idx,
        "class_id": class_idx,
        "iscrowd": np.zeros((B, G), bool),
        "boxes": boxes_abs,
        "boxes_normalized": boxes,
        "gt_valid": gt_valid,
    }


class SyntheticCocoDataset:
    """Iterable of synthetic fixed-shape batches (deterministic per seed)."""

    def __init__(
        self,
        batch_size: int,
        height: int,
        width: int,
        *,
        max_gt: int = 25,
        num_classes: int = 80,
        num_batches: int = 100,
        seed: int = 0,
        learnable: bool = False,
    ):
        self.batch_size = batch_size
        self.height = height
        self.width = width
        self.max_gt = max_gt
        self.num_classes = num_classes
        self.num_batches = num_batches
        self.seed = seed
        self.learnable = learnable

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.num_batches):
            yield synthetic_batch(
                rng, self.batch_size, self.height, self.width, self.max_gt,
                self.num_classes, learnable=self.learnable,
            )
