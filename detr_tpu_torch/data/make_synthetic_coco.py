"""On-disk synthetic COCO-format dataset (the port's copy of
``detr_tpu/data/make_synthetic_coco.py``; for the same arguments it writes
the same bytes: the JPEG files and ``labels.json``).

Writes the layout ``data.coco.CocoDataset`` reads:
``<root>/<split>/data/*.jpg`` and ``<root>/<split>/labels.json`` with COCO's
images / annotations (XYWH bbox) / categories.  Each annotation is a solid
rectangle in its class's colour (80 well-separated RGB points on a 4x5x4
lattice) on a noisy gray background, at image sides of 320-640 px, so the
multi-scale augmentation and the three training buckets all engage.  It
stands in for COCO-2017 where no copy of it is at hand.

Usage:
    python -m detr_tpu_torch.data.make_synthetic_coco --root datasets/synth \
        --train 3000 --val 500 [--num-classes 80] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os
import zlib

import numpy as np
from PIL import Image

NUM_CLASSES = 80


def class_palette_uint8(num_classes: int = NUM_CLASSES) -> np.ndarray:
    """num_classes points on an evenly spaced RGB lattice (4x5x4 = 80)."""
    rs = np.linspace(20, 235, 4)
    gs = np.linspace(20, 235, 5)
    bs = np.linspace(20, 235, 4)
    lattice = np.array([[r, g, b] for r in rs for g in gs for b in bs])
    if num_classes > len(lattice):
        raise ValueError(f"at most {len(lattice)} classes, got {num_classes}")
    # Shuffle deterministically so adjacent class indices are far apart in RGB.
    rng = np.random.default_rng(97)
    return lattice[rng.permutation(len(lattice))[:num_classes]].astype(np.uint8)


def _make_image(
    rng: np.random.Generator,
    num_classes: int,
    pal: np.ndarray,
    boxes_per_image: tuple[int, int] = (1, 9),
    max_overlap: float | None = None,
) -> tuple[np.ndarray, list[dict]]:
    """Returns (HxWx3 uint8 image, list of {bbox XYWH, category_id}).

    ``boxes_per_image`` is a half-open ``rng.integers`` range.  With
    ``max_overlap`` set, each new box must keep intersection-over-min-area
    < max_overlap against every accepted box (rejection sampling): boxes
    are painted back-to-front, so an uncapped small box can be fully
    occluded by a later one — unpredictable GT that acts as label noise.
    Dense + capped is the configuration for DETR convergence runs, where
    matched-slot count per image is the classification learning signal
    (each of the 100 queries only receives class gradient when matched)."""
    h = int(rng.integers(320, 641))
    w = int(rng.integers(320, 641))
    img = np.clip(
        rng.normal(128.0, 8.0, size=(h, w, 3)), 0, 255
    ).astype(np.uint8)

    anns = []
    placed: list[tuple[int, int, int, int]] = []  # x0, y0, x1, y1
    n_boxes = int(rng.integers(*boxes_per_image))
    for _ in range(n_boxes):
        for _attempt in range(30):
            bw = int(rng.integers(40, max(41, w // 2)))
            bh = int(rng.integers(40, max(41, h // 2)))
            x0 = int(rng.integers(0, max(1, w - bw)))
            y0 = int(rng.integers(0, max(1, h - bh)))
            if max_overlap is None:
                break
            ok = True
            for px0, py0, px1, py1 in placed:
                iw = min(x0 + bw, px1) - max(x0, px0)
                ih = min(y0 + bh, py1) - max(y0, py0)
                inter = max(0, iw) * max(0, ih)
                if inter / min(bw * bh, (px1 - px0) * (py1 - py0)) >= max_overlap:
                    ok = False
                    break
            if ok:
                break
        else:
            continue  # no non-occluding placement found; skip this box
        cls = int(rng.integers(0, num_classes))
        img[y0 : y0 + bh, x0 : x0 + bw] = pal[cls]
        placed.append((x0, y0, x0 + bw, y0 + bh))
        anns.append({"bbox": [x0, y0, bw, bh], "category_idx": cls})
    return img, anns


def generate_split(
    root: str,
    split: str,
    n_images: int,
    num_classes: int = NUM_CLASSES,
    seed: int = 0,
    quality: int = 95,
    boxes_per_image: tuple[int, int] = (1, 9),
    max_overlap: float | None = None,
) -> None:
    data_dir = os.path.join(root, split, "data")
    os.makedirs(data_dir, exist_ok=True)
    pal = class_palette_uint8(num_classes)
    # crc32, not hash(): str.__hash__ is salted per interpreter, which would
    # make the "same --seed" dataset differ on every invocation.
    rng = np.random.default_rng([seed, zlib.crc32(split.encode())])

    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        img, anns = _make_image(
            rng, num_classes, pal, boxes_per_image, max_overlap
        )
        file_name = f"{split}_{i:06d}.jpg"
        Image.fromarray(img).save(
            os.path.join(data_dir, file_name), quality=quality
        )
        images.append(
            {
                "id": i,
                "file_name": file_name,
                "width": img.shape[1],
                "height": img.shape[0],
            }
        )
        for a in anns:
            x, y, bw, bh = a["bbox"]
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": i,
                    "bbox": [float(x), float(y), float(bw), float(bh)],
                    "category_id": a["category_idx"] + 1,  # COCO ids are 1-based
                    "iscrowd": 0,
                    "area": float(bw * bh),
                }
            )
            ann_id += 1

    categories = [
        {"id": c + 1, "name": f"class_{c}"} for c in range(num_classes)
    ]
    with open(os.path.join(root, split, "labels.json"), "w") as f:
        json.dump(
            {"images": images, "annotations": annotations, "categories": categories},
            f,
        )


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", type=str, required=True)
    p.add_argument("--train", type=int, default=3000)
    p.add_argument("--val", type=int, default=500)
    p.add_argument("--num-classes", type=int, default=NUM_CLASSES)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--boxes", type=int, nargs=2, default=(1, 9), metavar=("LO", "HI"),
        help="boxes per image, half-open range (dense: 8 16)",
    )
    p.add_argument(
        "--max-overlap", type=float, default=None,
        help="cap pairwise intersection-over-min-area (dense: 0.3)",
    )
    args = p.parse_args()
    generate_split(
        args.root, "train", args.train, args.num_classes, args.seed,
        boxes_per_image=tuple(args.boxes), max_overlap=args.max_overlap,
    )
    generate_split(
        args.root, "validation", args.val, args.num_classes, args.seed + 1,
        boxes_per_image=tuple(args.boxes), max_overlap=args.max_overlap,
    )
    print(f"wrote {args.train}+{args.val} images under {args.root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
