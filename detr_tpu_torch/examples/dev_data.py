"""Dev harness: visual checks of the data pipeline (counterpart of
``examples/dev_data.py``).

Runs a few images through the training augmentation and the bucketed
collate, writes each augmented image with its boxes as a PNG
(``augmented_<i>.png``) and prints the shapes of the images and batches.

Usage:
  python -m detr_tpu_torch.examples.dev_data --coco-root datasets/coco-2017 [--out DIR]
  python -m detr_tpu_torch.examples.dev_data --synthetic                      # no dataset

Host work only (no device, so no ``--cpu``).  ``--out`` defaults to
``dev_data`` in the temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
from PIL import Image

from detr_tpu_torch.data import DEFAULT_BUCKETS, BucketedLoader, CocoDataset, get_train_transforms
from detr_tpu_torch.viz import plot


def synthetic_dataset(n=8, seed=0):
    """``n`` random images of 300-700 px a side with 1-5 boxes each, drawn
    from one generator as each item is read."""
    rng = np.random.default_rng(seed)

    class DS:
        def __len__(self):
            return n

        def __getitem__(self, i):
            h, w = int(rng.integers(300, 700)), int(rng.integers(300, 700))
            img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            k = int(rng.integers(1, 6))
            x0 = rng.uniform(0, w - 60, k)
            y0 = rng.uniform(0, h - 60, k)
            boxes = np.stack(
                [x0, y0, x0 + rng.uniform(20, 60, k), y0 + rng.uniform(20, 60, k)], 1
            ).astype(np.float32)
            t = {
                "image_id": i,
                "boxes": boxes,
                "class_idx": rng.integers(0, 3, k),
                "class_id": rng.integers(0, 3, k),
                "iscrowd": np.zeros(k, bool),
            }
            return self.transform(img, t) if self.transform else (img, t)

    ds = DS()
    ds.transform = None
    return ds


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--coco-root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", type=str, default=os.path.join(tempfile.gettempdir(), "dev_data"))
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    transform = get_train_transforms(seed=0)
    if args.synthetic or not args.coco_root:
        ds = synthetic_dataset()
        ds.transform = transform
    else:
        ds = CocoDataset(args.coco_root, "train", transform)

    # per-image augmented dumps
    for i in range(min(4, len(ds))):
        img, t = ds[i]
        rendered = plot(img, t["boxes"], box_color="green")
        Image.fromarray(rendered).save(os.path.join(args.out, f"augmented_{i}.png"))
        print(f"image {i}: shape={img.shape} boxes={len(t['boxes'])}")

    loader = BucketedLoader(
        ds, batch_size=2, buckets=DEFAULT_BUCKETS, max_gt=16, num_workers=0,
        drop_last=False,
    )
    for bi, batch in enumerate(loader):
        print(
            f"batch {bi}: image {batch['image'].shape} "
            f"heights {batch['height'].tolist()} "
            f"valid GT {batch['gt_valid'].sum(axis=1).tolist()}"
        )
        if bi >= 2:
            break
    print("wrote PNGs to", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
