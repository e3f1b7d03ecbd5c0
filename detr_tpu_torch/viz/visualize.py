"""Detection images for tensorboard, in PIL (counterpart of
``detr_tpu/viz/visualize.py``):

  * ``plot`` draws labelled XYXY boxes on one image (normalised float images
    are taken back to uint8 first) and returns an RGB uint8 array;
  * ``plot_grid`` draws a list of per-image dicts into one grid image, as
    the trainer logs its validation panels;
  * ``render_bounding_boxes`` draws COCO-format annotations (XYWH) onto a PIL
    image.

Images are HWC, the loader's layout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

from detr_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

_COLORS = [
    "red",
    "green",
    "blue",
    "orange",
    "purple",
    "cyan",
    "magenta",
    "yellow",
]


def _denormalize(img: np.ndarray) -> np.ndarray:
    """Normalised float HWC -> uint8; uint8 passes as it is."""
    if img.dtype == np.uint8:
        return img
    x = img * IMAGENET_STD + IMAGENET_MEAN
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def plot(
    image: np.ndarray,
    boxes: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    scores: Optional[np.ndarray] = None,
    box_color: str = "red",
    width: int = 2,
) -> np.ndarray:
    """Draw XYXY pixel boxes + labels on one image; returns RGB uint8 HWC."""
    base = _denormalize(np.asarray(image))
    img = Image.fromarray(base)
    draw = ImageDraw.Draw(img)
    if boxes is not None:
        for i, box in enumerate(np.asarray(boxes).reshape(-1, 4)):
            draw.rectangle([float(v) for v in box], outline=box_color, width=width)
            label = ""
            if class_names is not None and i < len(class_names):
                label = str(class_names[i])
            if scores is not None and i < len(scores):
                label = f"{label} {float(scores[i]):.2f}".strip()
            if label:
                draw.text((float(box[0]) + 2, float(box[1]) + 2), label, fill=box_color)
    return np.asarray(img)


def plot_grid(
    batch_items: Sequence[dict],
    max_images: int = 25,
    num_cols: int = 5,
    box_color: str = "green",
) -> np.ndarray:
    """Per-image dicts {image, boxes, class_names?, scores?} -> one
    grid image, ``num_cols`` wide, at most ``max_images`` cells (an empty
    list gives a 2x2 black image)."""
    items = list(batch_items)[:max_images]
    if not items:
        return np.zeros((2, 2, 3), np.uint8)
    rendered = [
        plot(it["image"], it.get("boxes"), it.get("class_names"), it.get("scores"),
             box_color=box_color)
        for it in items
    ]
    cell_h = max(r.shape[0] for r in rendered)
    cell_w = max(r.shape[1] for r in rendered)
    cols = min(num_cols, len(rendered))
    rows = -(-len(rendered) // cols)
    grid = np.zeros((rows * cell_h, cols * cell_w, 3), np.uint8)
    for i, r in enumerate(rendered):
        y, x = divmod(i, cols)
        grid[y * cell_h : y * cell_h + r.shape[0], x * cell_w : x * cell_w + r.shape[1]] = r
    return grid


def render_bounding_boxes(
    image: Image.Image,
    annotations: Sequence[dict],
    class_id2name: Optional[dict] = None,
    color: str = "red",
    width: int = 2,
) -> Image.Image:
    """COCO-format annotations (XYWH ``bbox``) drawn onto a copy of a PIL
    image, labelled by ``class_id2name`` where given."""
    img = image.copy()
    draw = ImageDraw.Draw(img)
    for i, ann in enumerate(annotations):
        x, y, w, h = ann["bbox"]
        c = color or _COLORS[i % len(_COLORS)]
        draw.rectangle([x, y, x + w, y + h], outline=c, width=width)
        if class_id2name and "category_id" in ann:
            draw.text((x + 2, y + 2), str(class_id2name.get(ann["category_id"], "?")), fill=c)
    return img
