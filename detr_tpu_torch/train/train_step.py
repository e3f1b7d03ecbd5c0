"""The train step: forward in train mode -> match -> set loss -> backward ->
accumulate, clip, update (counterpart of ``detr_tpu/train/train_step.py``).

PyTorch runs eagerly and updates in place, so the step mutates the
``TrainState`` it is given (there is no donation) and returns it with the
step's metrics: the criterion's loss dict, the total ``loss``, and the
micro-step's own gradient norm ``grad_norm``, as the JAX step does.  Mixed
precision follows the model's configuration: fp32 parameters, compute in
``DETRConfig.dtype``, the matcher and the loss in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.losses.criterion import SetCriterion, total_loss
from detr_tpu_torch.matcher.hungarian import HungarianMatcher
from detr_tpu_torch.models.detr import DETR
from detr_tpu_torch.ops.image_norm import prepare_batch_image
from detr_tpu_torch.train.optimizer import AccumulatingAdamW, global_norm


@dataclass
class TrainState:
    """What a train step reads and updates: the model (its parameters and
    frozen-BN statistics), the optimizer (its moments and the accumulated
    gradient), the CPU generator that draws the dropout seeds, and the count
    of micro-steps taken."""

    model: DETR
    optimizer: AccumulatingAdamW
    generator: torch.Generator
    step: int = 0


def build_criterion(train_config: TrainingConfig, detr_config: DETRConfig) -> SetCriterion:
    """Matcher and criterion from the training configuration."""
    matcher = HungarianMatcher(
        cost_class=train_config.set_cost_class,
        cost_bbox=train_config.set_cost_bbox,
        cost_giou=train_config.set_cost_giou,
        eps_min=train_config.matcher_eps_min,
    )
    return SetCriterion(
        num_classes=detr_config.num_classes,
        matcher=matcher,
        weight_label_ce=train_config.label_ce_loss_coef,
        weight_bbox_l1=train_config.bbox_loss_coef,
        weight_bbox_giou=train_config.giou_loss_coef,
        eos_coef=train_config.eos_coef,
    )


def targets_of_batch(batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    keys = ("class_idx", "boxes_normalized", "gt_valid", "image_valid")
    return {k: batch[k] for k in keys if k in batch}


def make_train_step(
    model: DETR, criterion: SetCriterion, canvas_map: Optional[dict] = None
) -> Callable[[TrainState, dict[str, torch.Tensor]], tuple[TrainState, dict[str, torch.Tensor]]]:
    """step(state, batch) -> (state, metrics); ``batch`` holds tensors on the
    model's device: image (B, H, W, 3), fp32 normalised or uint8 (normalised
    here, ``ops.image_norm``), height, width, and the targets.
    ``canvas_map`` (source canvas -> target canvas) takes the device-resize
    wire's batches (``ops.image_norm.prepare_batch_image``)."""

    def step(state: TrainState, batch: dict[str, torch.Tensor]):
        model.train()
        image = prepare_batch_image(batch, canvas_map)
        outputs = model(image, batch["height"], batch["width"], state.generator)
        loss_dict = criterion(outputs, targets_of_batch(batch))
        loss = total_loss(loss_dict)
        params = state.optimizer.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        state.optimizer.apply_gradients(grads)
        state.step += 1
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = global_norm(grads)
        return state, metrics

    return step


def make_eval_step(
    model: DETR, criterion: Optional[SetCriterion] = None, canvas_map: Optional[dict] = None
) -> Callable[[dict[str, torch.Tensor]], tuple[dict, dict]]:
    """step(batch) -> (outputs, loss dict): the eval-mode forward, and the
    losses when a criterion is given and the batch has targets;
    ``canvas_map`` as ``make_train_step``'s."""

    @torch.no_grad()
    def step(batch: dict[str, torch.Tensor]):
        model.eval()
        image = prepare_batch_image(batch, canvas_map)
        outputs = model(image, batch["height"], batch["width"])
        loss_dict = {}
        if criterion is not None and "gt_valid" in batch:
            loss_dict = criterion(outputs, targets_of_batch(batch))
        return outputs, loss_dict

    return step
