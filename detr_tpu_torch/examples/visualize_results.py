"""Visualise a model's detections on images (counterpart of
``examples/visualize_results.py``).

Drives the serving path: ``detr_tpu_torch.serve.InferenceEngine`` (DETR-R50,
bucketed fixed-shape batches of 4) from a trainer's checkpoint directory
(random weights from seed 0 without one), then ``viz.plot_grid`` of the
detections at ``--score-threshold`` and up, written as ``detections.png``.

Usage:
  python -m detr_tpu_torch.examples.visualize_results [--checkpoint runs/detr] \\
      [--images img1.jpg img2.jpg ...] [--out DIR] [--cpu]

Without ``--images`` it renders three random images.  On the card unless
given ``--cpu``.  ``--out`` defaults to ``viz_results`` in the temporary
directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
from PIL import Image

from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.serve import InferenceEngine
from detr_tpu_torch.viz import plot_grid


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", type=str, default=None, help="trainer output dir")
    ap.add_argument("--images", type=str, nargs="*", default=None)
    ap.add_argument("--out", type=str, default=os.path.join(tempfile.gettempdir(), "viz_results"))
    ap.add_argument("--score-threshold", type=float, default=0.5)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    class_names = [f"class_{i}" for i in range(80)]
    engine = InferenceEngine(
        DETRConfig(),
        checkpoint_dir=args.checkpoint,
        class_names=class_names,
        batch_size=4,
        score_threshold=args.score_threshold,
        device="cpu" if args.cpu else None,
    )

    if args.images:
        images = [np.asarray(Image.open(p).convert("RGB")) for p in args.images]
    else:
        rng = np.random.default_rng(0)
        images = [
            (rng.random((h, w, 3)) * 255).astype(np.uint8)
            for h, w in [(480, 640), (640, 480), (375, 500)]
        ]

    detections = engine.predict(images)

    items = []
    for img, det in zip(images, detections):
        items.append(
            {
                "image": img,
                "boxes": det["boxes"],
                "scores": det["scores"],
                "class_names": det.get("class_names"),
            }
        )
        print(
            f"{img.shape[1]}x{img.shape[0]}: {len(det['scores'])} detections "
            f">= {args.score_threshold}"
        )

    os.makedirs(args.out, exist_ok=True)
    grid = plot_grid(items, box_color="red")
    out_path = os.path.join(args.out, "detections.png")
    Image.fromarray(grid).save(out_path)
    print("wrote", out_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
