"""Learning-rate schedule: linear warmup -> hold -> cosine, stepped per epoch
(counterpart of ``detr_tpu/train/schedule.py``).

The reference's torch ``SequentialLR`` of LinearLR(start_factor=warmup_decay,
total_iters=W) -> constant for ``hold`` epochs -> CosineAnnealingLR(T_max =
epochs - W - hold, eta_min), stepped once per epoch.  Evaluated in fp32, as
the JAX package evaluates it, and returned as a Python float.
"""

from __future__ import annotations

import math

import numpy as np


def make_epoch_lr_schedule(
    base_lr: float,
    *,
    epochs: int,
    warmup_epochs: int = 5,
    warmup_decay: float = 0.01,
    hold_epochs: int = 35,
    lr_min: float = 3e-6,
):
    """Returns epoch (int) -> lr."""
    f32 = np.float32
    cooldown = max(epochs - warmup_epochs - hold_epochs, 1)

    def schedule(epoch) -> float:
        epoch = f32(epoch)
        w = min(epoch, f32(warmup_epochs)) / f32(max(warmup_epochs, 1))
        warmup_lr = f32(base_lr) * (f32(warmup_decay) + (f32(1.0) - f32(warmup_decay)) * w)
        t = min(max(epoch - f32(warmup_epochs) - f32(hold_epochs), f32(0.0)), f32(cooldown))
        cos = np.cos(f32(math.pi) * t / f32(cooldown))
        cos_lr = f32(lr_min) + (f32(base_lr) - f32(lr_min)) * f32(0.5) * (f32(1.0) + cos)
        if epoch < warmup_epochs:
            return float(warmup_lr)
        if epoch < warmup_epochs + hold_epochs:
            return float(f32(base_lr))
        return float(cos_lr)

    return schedule


def make_lr_schedule(
    base_lr: float,
    *,
    epochs: int,
    steps_per_epoch: int,
    warmup_epochs: int = 5,
    warmup_decay: float = 0.01,
    hold_epochs: int = 35,
    lr_min: float = 3e-6,
):
    """Step-indexed view: step (int) -> lr, at epoch step // steps_per_epoch."""
    epoch_schedule = make_epoch_lr_schedule(
        base_lr,
        epochs=epochs,
        warmup_epochs=warmup_epochs,
        warmup_decay=warmup_decay,
        hold_epochs=hold_epochs,
        lr_min=lr_min,
    )

    def schedule(step) -> float:
        return epoch_schedule(int(step) // max(steps_per_epoch, 1))

    return schedule
