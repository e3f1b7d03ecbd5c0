"""The train step: forward in train mode -> match -> set loss -> backward ->
accumulate, clip, update (counterpart of ``detr_tpu/train/train_step.py``).

PyTorch runs eagerly and updates in place, so the step mutates the
``TrainState`` it is given (there is no donation) and returns it with the
step's metrics: the criterion's loss dict, the total ``loss``, and the
micro-step's own gradient norm ``grad_norm``, as the JAX step does.  Mixed
precision follows the model's configuration: fp32 parameters, compute in
``DETRConfig.dtype``, the matcher and the loss in fp32.

On a grid of ranks (``parallel``) the step computes the JAX mesh step on
the global batch: each rank runs its row block (``batch_offset`` places it
for the dropout masks), the criterion sums over the data-parallel group, and
an all-reduce (SUM) over that group of the micro-step's gradients gives
every rank the global gradient; ``grad_norm`` and the clip count each
tensor-parallel slice once.  Under tensor parallelism the replicated
parameters' gradients are summed over all ranks and divided by the
tensor-parallel size instead: the ranks of a tensor-parallel group compute
them each on their own, and kernels that add in a run-dependent order
(cuDNN's weight gradients on the card) make those copies differ in their
last bits, which would let the replicas drift apart; in exact arithmetic it
is the same sum.  ``DistributedDataParallel`` is not used: its hooks fire on
``.backward()``, and this step takes ``torch.autograd.grad``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.losses.criterion import SetCriterion, total_loss
from detr_tpu_torch.matcher.hungarian import HungarianMatcher
from detr_tpu_torch.models import class_head
from detr_tpu_torch.models.detr import DETR
from detr_tpu_torch.ops.image_norm import prepare_batch_image
from detr_tpu_torch.train.optimizer import AccumulatingAdamW
from detr_tpu_torch.utils.profiling import span


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
    """Matcher and criterion from the training configuration, both with the
    model's class head (``models.class_head``)."""
    head = class_head(detr_config)
    matcher = HungarianMatcher(
        cost_class=train_config.set_cost_class,
        cost_bbox=train_config.set_cost_bbox,
        cost_giou=train_config.set_cost_giou,
        eps_min=train_config.matcher_eps_min,
        head=head,
    )
    return SetCriterion(
        num_classes=detr_config.num_classes,
        matcher=matcher,
        weight_label_ce=train_config.label_ce_loss_coef,
        weight_bbox_l1=train_config.bbox_loss_coef,
        weight_bbox_giou=train_config.giou_loss_coef,
        eos_coef=train_config.eos_coef,
        head=head,
    )


def targets_of_batch(batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    keys = ("class_idx", "boxes_normalized", "gt_valid", "image_valid")
    return {k: batch[k] for k in keys if k in batch}


def _all_reduce_flat(grads: list[torch.Tensor], group: Any, scale: float = 1.0) -> list:
    """The tensors summed over ``group`` in one all-reduce of their
    concatenation, times ``scale``."""
    if not grads:
        return []
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view(g.shape).to(g.dtype))
        i += g.numel()
    return out


def all_reduce_gradients(grads: list[torch.Tensor], grid: Any,
                         sharded: list[bool]) -> list[torch.Tensor]:
    """One micro-step's gradients (one per parameter, ``sharded`` flagging
    the tensor-parallel slices) summed over ``grid``'s data-parallel ranks:
    the slices over the data-parallel group, the replicated ones over every
    rank and divided by the tensor-parallel size (module docstring)."""
    split = _all_reduce_flat([g for g, s in zip(grads, sharded) if s], grid.dp_group)
    whole = _all_reduce_flat([g for g, s in zip(grads, sharded) if not s], None,
                             1.0 / grid.tp_size)
    split.reverse()
    whole.reverse()
    return [split.pop() if s else whole.pop() for s in sharded]


def make_train_step(
    model: DETR, criterion: SetCriterion, canvas_map: Optional[dict] = None,
    grid: Optional[Any] = None,
) -> Callable[[TrainState, dict[str, torch.Tensor]], tuple[TrainState, dict[str, torch.Tensor]]]:
    """step(state, batch) -> (state, metrics); ``batch`` holds tensors on the
    model's device: image (B, H, W, 3), fp32 normalised or uint8 (normalised
    here, ``ops.image_norm``), height, width, and the targets.
    ``canvas_map`` (source canvas -> target canvas) takes the device-resize
    wire's batches (``ops.image_norm.prepare_batch_image``).  ``grid``
    (``parallel.Grid``): ``batch`` is this rank's block of B rows of a global
    batch of B * dp_size, at row dp_rank * B.

    Spans (``utils.profiling``): ``train.step`` and within it
    ``train.prepare``, ``train.forward``, ``train.loss`` (the criterion, its
    matcher in ``train.match``), ``train.backward`` (``autograd.grad`` and
    the all-reduce on a grid) and ``train.optimizer`` (the update and the
    micro-step's gradient norm)."""
    group = None if grid is None else grid.dp_group

    def step(state: TrainState, batch: dict[str, torch.Tensor]):
        with span("train.step"):
            model.train()
            with span("train.prepare"):
                image = prepare_batch_image(batch, canvas_map)
            offset = 0 if grid is None else grid.dp_rank * image.shape[0]
            with span("train.forward"):
                outputs = model(image, batch["height"], batch["width"], state.generator, offset)
            with span("train.loss"):
                loss_dict = criterion(outputs, targets_of_batch(batch), group)
                loss = total_loss(loss_dict)
            params = state.optimizer.params
            with span("train.backward"):
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
                if group is not None:
                    grads = all_reduce_gradients(grads, grid, state.optimizer.sharded)
            with span("train.optimizer"):
                state.optimizer.apply_gradients(grads)
                state.step += 1
                metrics = {k: v.detach() for k, v in loss_dict.items()}
                metrics["loss"] = loss.detach()
                metrics["grad_norm"] = state.optimizer.global_norm(grads)
        return state, metrics

    return step


def make_eval_step(
    model: DETR, criterion: Optional[SetCriterion] = None, canvas_map: Optional[dict] = None,
    grid: Optional[Any] = None,
) -> Callable[[dict[str, torch.Tensor]], tuple[dict, dict]]:
    """step(batch) -> (outputs, loss dict): the eval-mode forward, and the
    losses when a criterion is given and the batch has targets (global over
    ``grid``'s data-parallel group, whose ranks hold the batch's row blocks);
    ``canvas_map`` as ``make_train_step``'s."""
    group = None if grid is None else grid.dp_group

    @torch.no_grad()
    def step(batch: dict[str, torch.Tensor]):
        model.eval()
        image = prepare_batch_image(batch, canvas_map)
        outputs = model(image, batch["height"], batch["width"])
        loss_dict = {}
        if criterion is not None and "gt_valid" in batch:
            loss_dict = criterion(outputs, targets_of_batch(batch), group)
        return outputs, loss_dict

    return step
