"""End-to-end learning run: a small DETR on a learnable synthetic task
(counterpart of ``examples/convergence_synthetic.py``).

Shows that the whole training loop LEARNS, not merely runs: the model, the
auction matcher, the set loss, the backward through the attention kernels,
AdamW, post-processing and the COCO evaluator together.  The task is to
detect class-coloured rectangles painted on low-noise backgrounds
(``synthetic_batch(learnable=True)``); a detector that cannot reach a high
AP on it is broken somewhere.

Full-scale DETR is slow to leave its query-collapse phase (every query
predicting one mean box); a small DETR (2+2 layers, d=64, 16 queries, 5
classes) resolves the same dynamics in a few thousand steps, and the mid
preset (``--d-model 128 --enc-layers 6 --dec-layers 6 --heads 4 --queries
50 --num-classes 81 --ffn-scale 8 --dropout 0.0``) lifts sooner.

The loop memorises ``--n-train-batches`` batches on the device and takes
batch ``i mod n`` at step ``i``, one step per call from the host; the loss
is read back once per ``--eval-every`` steps, at each evaluation.  The
optimizer is the JAX script's ``optax.chain(clip_by_global_norm(clip),
adamw(linear_schedule(0, lr, 300), weight_decay=1e-4))``, built from the
port's ``AccumulatingAdamW``: one rate for every parameter (the trunk
included), weight decay on every parameter, no accumulation, and a rate
of 0 at update 0 rising linearly to ``lr`` at update 300.  ``--coco-root``
memorises batches of the port's COCO loader instead (uint8, normalised on
the device), and with ``--stream`` takes a fresh loader batch every step.

Usage:  python -m detr_tpu_torch.examples.convergence_synthetic [--steps 6000] [--cpu]

Prints the loss and the validation and training AP every evaluation, the
final training-set AP, and exits nonzero when the final training AP50 is
below ``--ap50-bar``.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time
from typing import Iterator, Optional

import numpy as np
import torch

from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.data.synthetic import synthetic_batch
from detr_tpu_torch.eval.metrics import DetectionMetrics
from detr_tpu_torch.eval.postprocess import PostProcess
from detr_tpu_torch.models import DETR, calibrate_frozen_bn
from detr_tpu_torch.ops.image_norm import prepare_batch_image
from detr_tpu_torch.train.optimizer import GROUPS, AccumulatingAdamW
from detr_tpu_torch.train.train_step import (
    TrainState,
    build_criterion,
    make_eval_step,
    make_train_step,
)
from detr_tpu_torch.train.trainer import resolve_device, to_device

WARMUP_UPDATES = 300  # linear_schedule(0, lr, 300)
WEIGHT_DECAY = 1e-4
N_VAL_BATCHES = 4  # validation batches, and training batches evaluated
VAL_SEED = 1000  # the validation batches' seeds: 1000, 1001, ...


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--n-train-batches", type=int, default=16)
    ap.add_argument("--ap50-bar", type=float, default=0.3)
    # Model size; the defaults are the small demo.
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--enc-layers", type=int, default=2)
    ap.add_argument("--dec-layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--num-classes", type=int, default=5)
    ap.add_argument("--ffn-scale", type=int, default=4)
    ap.add_argument("--max-gt", type=int, default=8,
                    help="GT pad count for generator batches")
    ap.add_argument("--dropout", type=float, default=None,
                    help="override hidden+attention dropout (default: 0.1)")
    # Arm A: memorise batches of the COCO loader instead of the generator's.
    ap.add_argument("--coco-root", default=None,
                    help="pull train batches from this COCO root via the port's loader")
    ap.add_argument("--coco-image-size", type=int, default=768,
                    help="single square bucket side for --coco-root")
    # Arm B: the same loader, a fresh batch every step.
    ap.add_argument("--stream", action="store_true",
                    help="with --coco-root: stream new batches every step "
                    "instead of memorizing n-train-batches")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap.parse_args(argv)


def model_config(args: argparse.Namespace, dtype: str = "bfloat16") -> DETRConfig:
    """The script's DETR: ``--dropout`` sets the hidden and the attention
    dropout; 80 classes under ``--coco-root``."""
    cfg = DETRConfig(
        num_object_queries=args.queries,
        num_encoder_layers=args.enc_layers,
        num_decoder_layers=args.dec_layers,
        num_attention_heads=args.heads,
        hidden_size=args.d_model,
        ffn_scale_factor=args.ffn_scale,
        num_classes=80 if args.coco_root else args.num_classes,
        dtype=dtype,
    )
    if args.dropout is not None:
        cfg = cfg.replace(hidden_dropout_prob=args.dropout,
                          attention_probs_dropout_prob=args.dropout)
    return cfg


def train_config(args: argparse.Namespace) -> TrainingConfig:
    """One update per step (accumulation 1), clipped at ``--clip``, weight
    decay 1e-4 on every parameter."""
    return TrainingConfig(
        cumulative_train_batch_size=args.batch_size,
        train_batch_size=args.batch_size,
        gradient_max_norm=args.clip,
        weight_decay=WEIGHT_DECAY,
        norm_weight_decay=None,
    )


def make_batch(args: argparse.Namespace, seed: int, num_classes: int) -> dict[str, np.ndarray]:
    return synthetic_batch(
        np.random.default_rng(seed),
        batch_size=args.batch_size,
        height=args.image_size,
        width=args.image_size,
        max_gt=args.max_gt,
        num_classes=num_classes,
        mean_boxes=3.0,
        learnable=True,
    )


def make_optimizer(model: torch.nn.Module, args: argparse.Namespace) -> AccumulatingAdamW:
    """AdamW over every trainable parameter at one rate, which
    ``train_chunk`` sets from ``warmup_lr`` before each update."""
    return AccumulatingAdamW(model, train_config(args), {g: 0.0 for g in GROUPS})


def warmup_lr(update: int, lr: float) -> float:
    """``optax.linear_schedule(0, lr, 300)`` at update ``update``: 0 at
    update 0, ``lr`` from update 300 on.  Computed as optax computes it, in
    float32, ``(0 - lr) * (1 - u / 300) + lr``, so that every rate is the
    JAX script's to the bit (the float32 cancellation moves a rate by up to
    ~1e-7 of ``lr``)."""
    frac = np.float32(1.0) - np.float32(min(update, WARMUP_UPDATES)) / np.float32(WARMUP_UPDATES)
    return float(np.float32(-lr) * frac + np.float32(lr))


def _coco_loaders(args: argparse.Namespace):
    """The port's COCO loaders for arms A and B: training with the
    augmentation (no photometric distortion) into one square bucket of
    ``--coco-image-size``, and validation at 800x800; uint8, 2 workers."""
    from detr_tpu_torch.data import (
        BucketedLoader,
        CocoDataset,
        get_train_transforms,
        get_val_transforms,
        make_eval_loader,
    )

    side = args.coco_image_size
    train_loader = BucketedLoader(
        CocoDataset(args.coco_root, "train",
                    get_train_transforms(seed=0, normalize=False, photometric=False)),
        args.batch_size, buckets=((side, side),), max_gt=48, shuffle=True, num_workers=2,
        seed=0, image_dtype="uint8")
    # The validation transform scales the shorter side to 800, so square
    # sources land at 800x800 whatever --coco-image-size is.
    val_loader = make_eval_loader(
        CocoDataset(args.coco_root, "validation", get_val_transforms(normalize=False)),
        args.batch_size, max_gt=48, num_workers=2, shape=(800, 800), image_dtype="uint8")
    return train_loader, val_loader


def build(args: argparse.Namespace, device: torch.device, dtype: str = "bfloat16") -> dict:
    """Everything the loop needs: the model from seed 0 with its trunk's
    frozen-BN statistics calibrated on the first training batch, the
    optimizer, the train and eval steps, and the data: ``train`` and ``val``
    as lists of (device batch, host batch), ``stream`` the loader's
    endless iterator under ``--stream`` (else None), and ``loaders`` to
    close at the end."""
    cfg = model_config(args, dtype)
    names_prefix = "class" if args.coco_root else "color"
    names = [f"{names_prefix}_{i}" for i in range(cfg.num_classes)]
    n_train = args.n_train_batches
    loaders, stream = [], None
    if args.coco_root:
        train_loader, val_loader = _coco_loaders(args)
        loaders = [train_loader, val_loader]

        def endless() -> Iterator[dict]:
            while True:
                yield from train_loader

        it = endless()
        train_host = [next(it) for _ in range(n_train)]
        val_host = list(itertools.islice(iter(val_loader), N_VAL_BATCHES))
        if args.stream:
            stream = (to_device(b, device) for b in it)
    else:
        train_host = [make_batch(args, s, cfg.num_classes) for s in range(n_train)]
        val_host = [make_batch(args, VAL_SEED + s, cfg.num_classes) for s in range(N_VAL_BATCHES)]
    train = [(to_device(b, device), b) for b in train_host]
    val = [(to_device(b, device), b) for b in val_host]

    model = DETR(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    # A random trunk: its frozen-BN statistics from the first batch (with
    # the identity ones its activations explode and learning stalls).
    calibrate_frozen_bn(model.backbone.backbone, prepare_batch_image(train[0][0]))
    criterion = build_criterion(train_config(args), cfg)
    optimizer = make_optimizer(model, args)
    return dict(
        config=cfg, names=names, model=model, criterion=criterion,
        state=TrainState(model, optimizer, torch.Generator().manual_seed(0)),
        step=make_train_step(model, criterion), eval_step=make_eval_step(model),
        train=train, val=val, stream=stream, loaders=loaders,
    )


def train_chunk(step, state: TrainState, lr: float, batches: list, start: int, k: int,
                stream: Optional[Iterator[dict]] = None) -> dict[str, torch.Tensor]:
    """``k`` steps from batch ``start`` of the memorised ``batches`` (device
    batches, taken modulo their count), or from ``stream``; the rate of
    every group is set to ``warmup_lr`` before each update.  Returns the
    last step's metrics, still on the device: nothing is read back here."""
    metrics = {}
    for i in range(k):
        rate = warmup_lr(state.optimizer.updates, lr)
        state.optimizer.set_learning_rates({g: rate for g in GROUPS})
        batch = next(stream) if stream is not None else batches[(start + i) % len(batches)]
        state, metrics = step(state, batch)
    return metrics


def evaluate(eval_step, batches: list, names: list, batch_size: int,
             offset_ids: bool) -> dict:
    """COCO AP of the last decoder layer's detections over ``batches``
    ((device batch, host batch) pairs).  ``offset_ids``: the generator
    numbers each batch's images 1..B, so batch ``vi``'s ids are moved by
    ``vi * batch_size`` to keep them distinct."""
    post = PostProcess(names)
    metrics = DetectionMetrics(names)
    for vi, (device_batch, host) in enumerate(batches):
        outputs, _ = eval_step(device_batch)
        preds = post(outputs["pred_logits"][:, -1], outputs["pred_boxes"][:, -1],
                     device_batch["height"], device_batch["width"])
        if offset_ids:
            host = dict(host, image_id=np.asarray(host["image_id"]) + vi * batch_size)
        metrics.update(preds, host)
    return metrics.compute()


def main(argv=None, history: Optional[list] = None) -> int:
    """Run the loop; ``history``, when given, receives one dict per
    evaluation: the step, the last step's loss, the validation and training
    AP dicts, and the seconds so far (in all, and in training steps)."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    run = build(args, device)
    state, step, eval_step = run["state"], run["step"], run["eval_step"]
    train, val, names = run["train"], run["val"], run["names"]
    offset_ids = not args.coco_root
    k = args.eval_every
    try:
        t0 = time.time()
        train_s = 0.0
        done = 0
        while done < args.steps:
            t1 = time.time()
            metrics = train_chunk(step, state, args.lr, [b for b, _ in train], done, k,
                                  run["stream"])
            loss = float(metrics["loss"])
            train_s += time.time() - t1
            done += k
            ev = evaluate(eval_step, val, names, args.batch_size, offset_ids)
            tr = evaluate(eval_step, train[:N_VAL_BATCHES], names, args.batch_size, offset_ids)
            print(
                f"step {done:6d}  loss {loss:7.3f}  val AP {ev['AP']:.3f} "
                f"AP50 {ev['AP50']:.3f}  train AP {tr['AP']:.3f} "
                f"AP50 {tr['AP50']:.3f}  ({time.time() - t0:.0f}s)",
                flush=True,
            )
            if history is not None:
                history.append(dict(step=done, loss=loss, val=ev, train=tr,
                                    seconds=time.time() - t0, train_seconds=train_s))
        final = evaluate(eval_step, train[:N_VAL_BATCHES], names, args.batch_size, offset_ids)
        print(f"{done} steps in {train_s:.1f} s of training steps "
              f"({done / max(train_s, 1e-9):.2f} steps/s), {time.time() - t0:.1f} s in all",
              flush=True)
    finally:
        for loader in run["loaders"]:
            loader.close()  # the worker processes
    print("FINAL train-set:", {k: round(v, 3) for k, v in final.items()
                               if not k.startswith("AP-per")})
    # The bar is on TRAINING AP50: detecting the memorised pool needs every
    # component (a broken matcher, loss or box head cannot memorise it);
    # validation AP measures generalisation from n_train * batch_size images.
    if final["AP50"] < args.ap50_bar:
        raise SystemExit(
            f"train AP50 {final['AP50']:.3f} below bar {args.ap50_bar} — "
            "end-to-end learning check FAILED"
        )
    print(f"PASS: train AP50 {final['AP50']:.3f} >= {args.ap50_bar}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
