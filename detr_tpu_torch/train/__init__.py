from detr_tpu_torch.train.optimizer import AccumulatingAdamW, build_optimizer
from detr_tpu_torch.train.schedule import make_epoch_lr_schedule, make_lr_schedule
from detr_tpu_torch.train.train_step import (
    TrainState,
    build_criterion,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "AccumulatingAdamW",
    "build_optimizer",
    "make_epoch_lr_schedule",
    "make_lr_schedule",
    "TrainState",
    "build_criterion",
    "make_eval_step",
    "make_train_step",
]
