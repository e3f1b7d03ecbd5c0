"""Aspect-ratio buckets and fixed-shape batch assembly (counterpart of
``detr_tpu/data/bucketing.py``).

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

The device-resize wire (``assemble_batch_source``) ships each image at its
source resolution in a per-bucket source canvas instead, with
``src_height``/``src_width`` beside the target ``height``/``width`` it is to
be resampled to on the card (``ops.device_resize``).
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

# The device-resize wire's source canvases, one per target bucket.  COCO
# sources are at most 640 px a side, and a target bucket receives only
# targets of its own aspect (resampling keeps the aspect): the wide bucket
# takes sources of aspect above ~1.32 (below it the square bucket wastes
# less), whose short side is then under 640 / 1.32 < 512.  A source larger
# than its canvas (not COCO) is downscaled on the host to fit, a two-stage
# resample on that fallback path only.
DEFAULT_SOURCE_BUCKETS = ((512, 672), (672, 512), (672, 672))
EVAL_SOURCE_BUCKETS = ((512, 672), (672, 512))
_SOURCE_SIDE_CAP = 672  # COCO's largest side, 640, rounded up to /32


def derive_source_buckets(buckets: Sequence[tuple[int, int]]) -> tuple[tuple[int, int], ...]:
    """The source canvases for target buckets: the defaults' own, else each
    side capped at the COCO source ceiling.  The step finds a batch's target
    canvas from its source canvas's shape, so the canvases must differ:
    a collision raises."""
    if tuple(buckets) == DEFAULT_BUCKETS:
        return DEFAULT_SOURCE_BUCKETS
    if tuple(buckets) == EVAL_BUCKETS:
        return EVAL_SOURCE_BUCKETS
    out = tuple((min(bh, _SOURCE_SIDE_CAP), min(bw, _SOURCE_SIDE_CAP)) for bh, bw in buckets)
    if len(set(out)) != len(out):
        raise ValueError(f"derived source canvases collide for buckets {tuple(buckets)}: "
                         f"{out} — pass distinct source_buckets explicitly")
    return out


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


def fit_to_bucket_source(img: np.ndarray, target: dict, bucket: tuple[int, int],
                         source_canvas: tuple[int, int]):
    """The device-resize wire's fit: shrink the target size (``resize_to``,
    only numbers) when it exceeds the bucket, and downscale the source on the
    host only when it exceeds its canvas."""
    th, tw = target["resize_to"]
    bh, bw = bucket
    if th > bh or tw > bw:
        s = min(bh / th, bw / tw)
        target = dict(target, resize_to=(int(th * s), int(tw * s)))
    h, w = img.shape[:2]
    sh, sw = source_canvas
    if h > sh or w > sw:
        s = min(sh / h, sw / w)
        resize_to = target["resize_to"]
        img, target = resize(img, target, int(h * s), int(w * s))
        target["resize_to"] = resize_to
    return img, target


def _empty_targets(B: int, G: int) -> dict[str, np.ndarray]:
    return {
        "image_id": np.full((B,), -1, np.int32),
        "class_idx": np.zeros((B, G), np.int32),
        "class_id": np.zeros((B, G), np.int32),
        "iscrowd": np.zeros((B, G), bool),
        "gt_valid": np.zeros((B, G), bool),
        "boxes": np.zeros((B, G, 4), np.float32),
        "boxes_normalized": np.zeros((B, G, 4), np.float32),
    }


def _fill_targets(batch: dict, b: int, t: dict, G: int) -> int:
    """Copy one item's per-box fields into row b; returns its box count."""
    batch["image_id"][b] = t.get("image_id", -1)
    n = min(len(t["boxes"]), G)
    if len(t["boxes"]) > G:
        warnings.warn(f"dropping {len(t['boxes']) - G} GT boxes beyond max_gt={G}")
    if n:
        batch["class_idx"][b, :n] = t["class_idx"][:n]
        batch["class_id"][b, :n] = t["class_id"][:n]
        batch["iscrowd"][b, :n] = t["iscrowd"][:n]
        batch["gt_valid"][b, :n] = True
    return n


def assemble_batch_source(
    items: Sequence[tuple[np.ndarray, dict]],
    source_canvas: tuple[int, int],
    max_gt: int = 100,
) -> dict[str, np.ndarray]:
    """The device-resize wire's batch: uint8 sources padded into the source
    canvas, ``src_height``/``src_width`` their extents, and ``height``/
    ``width`` each item's ``resize_to``, the extents after the card's
    resample (what the padding mask and the position encoding read).
    ``boxes_normalized`` does not depend on the scale (source pixels over
    the source size); ``boxes`` are in target pixels, for the metrics."""
    B = len(items)
    sh, sw = source_canvas
    batch = {
        "image": np.zeros((B, sh, sw, 3), np.uint8),
        "src_height": np.zeros((B,), np.int32),
        "src_width": np.zeros((B,), np.int32),
        "height": np.zeros((B,), np.int32),
        "width": np.zeros((B,), np.int32),
        **_empty_targets(B, max_gt),
    }
    for b, (img, t) in enumerate(items):
        h, w = img.shape[:2]
        th, tw = t["resize_to"]
        if h > sh or w > sw:
            raise ValueError(f"source ({h},{w}) exceeds canvas {source_canvas}")
        if img.dtype != np.uint8:
            raise ValueError(f"the device-resize wire is uint8 only; got {img.dtype}")
        batch["image"][b, :h, :w] = img
        batch["src_height"][b] = h
        batch["src_width"][b] = w
        batch["height"][b] = th
        batch["width"][b] = tw
        n = _fill_targets(batch, b, t, max_gt)
        if n:
            norm = t["boxes"][:n] / np.array([w, h, w, h], np.float32)
            batch["boxes_normalized"][b, :n] = norm
            batch["boxes"][b, :n] = norm * np.array([tw, th, tw, th], np.float32)
    return batch


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
        **_empty_targets(B, G),
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
        n = _fill_targets(batch, b, t, G)
        if n:
            batch["boxes"][b, :n] = t["boxes"][:n]
            batch["boxes_normalized"][b, :n] = t["boxes"][:n] / np.array(
                [w, h, w, h], np.float32
            )
    return batch
