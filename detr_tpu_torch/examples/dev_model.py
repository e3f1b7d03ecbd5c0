"""Dev harness: checkpoint -> forward -> loss -> PostProcess -> mAP -> grid
(counterpart of ``examples/dev_model.py``).

Loads a DETR-R50 (random weights from seed 0, or a checkpoint directory the
port's trainer wrote), runs a synthetic batch of two 640x640 images through
the eval-mode forward, the matcher and the set criterion, post-processes the
last decoder layer's detections (score 0.1 and up), scores them with COCO
mAP, and writes them as an image grid, ``predictions.png``.

Usage:
  python -m detr_tpu_torch.examples.dev_model [--checkpoint runs/detr] [--out DIR] [--cpu]

On the card unless given ``--cpu``.  ``--out`` defaults to ``dev_model`` in
the temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
from PIL import Image

from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.data import synthetic_batch
from detr_tpu_torch.eval import DetectionMetrics, PostProcess
from detr_tpu_torch.models import DETR
from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, make_eval_step
from detr_tpu_torch.train.checkpoint import CheckpointManager
from detr_tpu_torch.train.trainer import resolve_device, to_device
from detr_tpu_torch.viz import plot_grid


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--out", type=str, default=os.path.join(tempfile.gettempdir(), "dev_model"))
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)

    detr_config = DETRConfig()
    train_config = TrainingConfig()
    model = DETR(detr_config)
    model.reset_parameters(torch.Generator().manual_seed(0))
    criterion = build_criterion(train_config, detr_config)
    class_names = [f"class_{i}" for i in range(detr_config.num_classes)]

    batch = synthetic_batch(np.random.default_rng(0), batch_size=2, height=640, width=640)
    if args.checkpoint:
        optimizer, _ = build_optimizer(model, train_config)
        state = TrainState(model, optimizer, torch.Generator().manual_seed(0))
        CheckpointManager(args.checkpoint).restore_params_only(state)
    model.to(device)

    device_batch = to_device(batch, device)
    outputs, loss_dict = make_eval_step(model, criterion)(device_batch)
    print("pred_logits:", tuple(outputs["pred_logits"].shape))
    for k, v in sorted(loss_dict.items()):
        print(f"  {k}: {float(v):.4f}")

    post = PostProcess(class_names)
    preds = post(
        outputs["pred_logits"][:, -1],
        outputs["pred_boxes"][:, -1],
        device_batch["height"],
        device_batch["width"],
        score_threshold=0.1,
    )
    metrics = DetectionMetrics(class_names)
    metrics.update(preds, batch)
    result = metrics.compute()
    print("AP:", result["AP"], "AP50:", result["AP50"])

    items = [
        {"image": batch["image"][i], "boxes": preds[i]["boxes"], "scores": preds[i]["scores"]}
        for i in range(len(preds))
    ]
    grid = plot_grid(items, box_color="red")
    Image.fromarray(grid).save(os.path.join(args.out, "predictions.png"))
    print("wrote", os.path.join(args.out, "predictions.png"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
