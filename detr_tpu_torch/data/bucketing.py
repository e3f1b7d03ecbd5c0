"""Aspect-ratio buckets and fixed-shape batch assembly (counterpart of
``detr_tpu/data/bucketing.py``, without the device-resize wire).

Every augmented image is padded into one of a few (H, W) buckets, chosen by
best fit (downscaling only an image that exceeds every bucket), and its GT to
a static ``max_gt`` with a validity mask.

Batch layout (numpy, NHWC):
  image            (B, H, W, 3) fp32 normalised, or uint8 (``image_dtype``);
                   zero padding
  height / width   (B,) int32 valid extents
  image_id         (B,) int32 (-1: the item carried no dataset id)
  class_idx        (B, G) int32        class_id (B, G) int32
  iscrowd          (B, G) bool         gt_valid (B, G) bool
  boxes            (B, G, 4) fp32 XYXY in pixels
  boxes_normalized (B, G, 4) fp32 XYXY / (w, h, w, h)
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np

from detr_tpu_torch.data.transforms import normalize, resize

# Buckets covering the training augmentation's range (shortest side 480-800,
# longest <= 1333) with moderate padding; /32-aligned.
DEFAULT_BUCKETS = ((832, 1344), (1344, 832), (1056, 1056))
# The val transform yields shortest side 800 (longest <= 1333); two /32-aligned
# buckets cover landscape and portrait without downscaling anything.
EVAL_BUCKETS = ((800, 1344), (1344, 800))


def pick_bucket(h: int, w: int, buckets: Sequence[tuple[int, int]]) -> int:
    """Index of the smallest-waste bucket that fits (h, w); if none fits,
    the bucket needing the least downscale."""
    best_fit, best_waste = -1, None
    for i, (bh, bw) in enumerate(buckets):
        if h <= bh and w <= bw:
            waste = bh * bw - h * w
            if best_waste is None or waste < best_waste:
                best_fit, best_waste = i, waste
    if best_fit >= 0:
        return best_fit
    scales = [min(bh / h, bw / w) for bh, bw in buckets]
    return int(np.argmax(scales))


def fit_to_bucket(img: np.ndarray, target: dict, bucket: tuple[int, int]):
    """Downscale (aspect-preserving) iff the image exceeds the bucket."""
    h, w = img.shape[:2]
    bh, bw = bucket
    if h <= bh and w <= bw:
        return img, target
    scale = min(bh / h, bw / w)
    return resize(
        img if img.dtype == np.uint8 else img.astype(np.float32),
        target,
        int(h * scale),
        int(w * scale),
    )


def assemble_batch(
    items: Sequence[tuple[np.ndarray, dict]],
    bucket: tuple[int, int],
    max_gt: int = 100,
    image_dtype: str = "float32",
) -> dict[str, np.ndarray]:
    """Pad images into the bucket and GT to max_gt (fixed shapes).

    ``image_dtype="uint8"`` keeps the transforms' uint8 pixels (built with
    ``normalize=False``) for normalising on the card (``ops.image_norm``);
    "float32" normalises uint8 items here, with the padding exactly 0."""
    B = len(items)
    bh, bw = bucket
    G = max_gt
    batch = {
        "image": np.zeros((B, bh, bw, 3), np.dtype(image_dtype)),
        "height": np.zeros((B,), np.int32),
        "width": np.zeros((B,), np.int32),
        "image_id": np.full((B,), -1, np.int32),
        "class_idx": np.zeros((B, G), np.int32),
        "class_id": np.zeros((B, G), np.int32),
        "iscrowd": np.zeros((B, G), bool),
        "gt_valid": np.zeros((B, G), bool),
        "boxes": np.zeros((B, G, 4), np.float32),
        "boxes_normalized": np.zeros((B, G, 4), np.float32),
    }
    for b, (img, t) in enumerate(items):
        h, w = img.shape[:2]
        if h > bh or w > bw:
            raise ValueError(f"image ({h},{w}) exceeds bucket {bucket}")
        if image_dtype == "uint8":
            if img.dtype != np.uint8:
                raise ValueError(f"uint8 batches need normalize=False transforms; got {img.dtype}")
        elif img.dtype == np.uint8:
            img = normalize(img)
        batch["image"][b, :h, :w] = img
        batch["height"][b] = h
        batch["width"][b] = w
        batch["image_id"][b] = t.get("image_id", -1)
        n = min(len(t["boxes"]), G)
        if len(t["boxes"]) > G:
            warnings.warn(f"dropping {len(t['boxes']) - G} GT boxes beyond max_gt={G}")
        if n:
            batch["boxes"][b, :n] = t["boxes"][:n]
            batch["boxes_normalized"][b, :n] = t["boxes"][:n] / np.array(
                [w, h, w, h], np.float32
            )
            batch["class_idx"][b, :n] = t["class_idx"][:n]
            batch["class_id"][b, :n] = t["class_id"][:n]
            batch["iscrowd"][b, :n] = t["iscrowd"][:n]
            batch["gt_valid"][b, :n] = True
    return batch
