"""Optimizer: AdamW with two learning-rate groups, global-norm clipping and
gradient accumulation (counterpart of ``detr_tpu/train/optimizer.py``).

  * ``torch.optim.AdamW``: betas 0.9/0.999, eps 1e-8, weight decay 1e-4 on
    every trainable parameter (optax's unmasked ``adamw``), or, with
    ``norm_weight_decay`` set, that rate on the LayerNorm parameters (a name
    component ``norm*``, the JAX package's path rule) and ``weight_decay``
    on the rest, each in a parameter group of its own;
  * two parameter groups: ``backbone.*`` at ``lr_backbone``, the rest at
    ``lr``;
  * gradient accumulation with ``optax.MultiSteps`` semantics: an update
    every k micro-steps, from the mean of their gradients;
  * clipping at ``gradient_max_norm`` of the global norm of that averaged
    gradient.  Documented divergence from the reference, kept from the JAX
    package: the reference's ``clip_grad_norm_`` runs on the partially
    accumulated gradient every micro-step (an Accelerate quirk); the clip
    here is on the final averaged gradient;
  * per-epoch learning rates: the trainer sets them from the epoch schedule
    with ``set_learning_rates`` (the reference's ``scheduler.step()`` per
    epoch); an update applies the last values set, and
    ``get_learning_rates`` reads them back.

Under a tensor-parallel group (the model's ``tp``, ``parallel.tp``) each
rank updates its slices of the split parameters: AdamW is elementwise, so
its moments and the accumulated gradient are split like their parameter.
The global norm of the clip counts each split parameter's slices once
(their sums of squares added over the group) and each replicated parameter
once; ``state_dict`` gathers the split moments and gradients into full
tensors and ``load_state_dict`` cuts full ones for this rank, so the state
saved by one layout restores into another.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from detr_tpu_torch.config import TrainingConfig
from detr_tpu_torch.parallel.tp import gather_state_tp, param_specs, shard_state_tp
from detr_tpu_torch.train.schedule import make_epoch_lr_schedule

GROUPS = ("backbone", "rest")


def is_norm_parameter(name: str) -> bool:
    """True for a parameter of a LayerNorm: a component of its dotted name
    starts with ``norm`` (``encoder.layers.0.norm1.weight``)."""
    return any(part.startswith("norm") for part in name.split("."))


def global_norm(tensors: Iterable[torch.Tensor], sharded: Optional[Sequence[bool]] = None,
                group: Optional[Any] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32.  With a
    tensor-parallel ``group``, the tensors flagged ``sharded`` are this
    rank's slices: their squares are summed over the group, the others
    (replicated) counted once."""
    tensors = list(tensors)
    if group is None:
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))
    def squares(ts):
        return torch.stack([torch.linalg.vector_norm(t.float()) ** 2 for t in ts]).sum()

    replicated = squares([t for t, s in zip(tensors, sharded) if not s])
    shards = squares([t for t, s in zip(tensors, sharded) if s])
    dist.all_reduce(shards, group=group)
    return torch.sqrt(replicated + shards)


class AccumulatingAdamW:
    """AdamW over a model's trainable parameters behind gradient
    accumulation and clipping; ``apply_gradients`` is one micro-step."""

    def __init__(self, model: nn.Module, config: TrainingConfig, lrs: dict[str, float]):
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]
        self.names = [n for n, _ in named]
        self.tp = getattr(model, "tp", None)
        specs = param_specs(self.names)
        self.sharded = [self.tp is not None and specs[n] is not None for n in self.names]
        wd_norm = config.norm_weight_decay
        groups = []  # one per (LR group, decay rate) that has parameters
        for g in GROUPS:
            members = [(n, p) for n, p in named
                       if (n.split(".")[0] == "backbone") == (g == "backbone")]
            rates = [(config.weight_decay, members)]
            if wd_norm is not None:
                rates = [(config.weight_decay, [m for m in members if not is_norm_parameter(m[0])]),
                         (wd_norm, [m for m in members if is_norm_parameter(m[0])])]
            groups += [{"params": [p for _, p in ps], "lr": lrs[g], "name": g,
                        "weight_decay": float(wd)} for wd, ps in rates if ps]
        self.adamw = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)
        # AdamW's state_dict numbers the parameters group by group
        by_id = {id(p): n for n, p in named}
        self._state_names = [by_id[id(p)] for g in groups for p in g["params"]]
        self.every_k = config.gradient_accumulation_steps
        self.max_norm = config.gradient_max_norm
        self.mini_step = 0  # micro-steps accumulated towards the next update
        self.updates = 0
        self._acc: list[torch.Tensor] | None = None

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> bool:
        """Accumulate one micro-step's gradients (one per parameter, in
        ``self.params`` order); on every k-th call, update the parameters
        with the clipped mean.  Returns whether it updated."""
        if self._acc is None:
            self._acc = [g.detach().float().clone() for g in grads]
        else:
            torch._foreach_add_(self._acc, [g.float() for g in grads])
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        mean = self._acc
        if self.every_k > 1:
            torch._foreach_div_(mean, float(self.every_k))
        if self.max_norm > 0:
            norm = self.global_norm(mean)
            # optax.clip_by_global_norm: g * max_norm / norm when norm >= max_norm
            coef = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
            torch._foreach_mul_(mean, coef)
        for p, g in zip(self.params, mean):
            p.grad = g.to(p.dtype)
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self._acc = None
        self.mini_step = 0
        self.updates += 1
        return True

    def global_norm(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """``global_norm`` of one tensor per parameter (in ``self.params``
        order), over this optimizer's tensor-parallel group."""
        if self.tp is None:
            return global_norm(tensors)
        return global_norm(tensors, self.sharded, self.tp.group)

    def set_learning_rates(self, lrs: dict[str, float]) -> None:
        """Set the per-group LRs ({"backbone": x, "rest": y}) for the next
        updates: once per epoch, from the schedule."""
        for group in self.adamw.param_groups:
            group["lr"] = float(lrs[group["name"]])

    def get_learning_rates(self) -> dict[str, float]:
        return {group["name"]: group["lr"] for group in self.adamw.param_groups}

    def state_dict(self) -> dict:
        """AdamW's moments, step counts and groups (with their decay rates),
        the accumulated gradient
        (None between updates), the micro-steps accumulated and the update
        count; tensors are the live ones, not copies."""
        state = {"adamw": self.adamw.state_dict(), "acc": self._acc,
                 "mini_step": self.mini_step, "updates": self.updates}
        if self.tp is None:
            return state
        return self._map_split(state, lambda named: gather_state_tp(named, self.tp))

    def _map_split(self, state: dict, fn: Callable[[dict], dict]) -> dict:
        """``state`` with its per-parameter tensors (moments, the
        accumulated gradient) replaced by ``fn`` of them keyed by parameter
        name: the gather or the cut of the split ones.  A new dict: the live
        state is not touched."""
        adamw = dict(state["adamw"])
        moments = {i: dict(v) for i, v in adamw["state"].items()}
        for key in ("exp_avg", "exp_avg_sq"):
            named = fn({self._state_names[i]: v[key] for i, v in moments.items()})
            for i, v in moments.items():
                v[key] = named[self._state_names[i]]
        adamw["state"] = moments
        acc = state["acc"]
        if acc is not None:
            named = fn(dict(zip(self.names, acc)))
            acc = [named[n] for n in self.names]
        return {**state, "adamw": adamw, "acc": acc}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s content onto this optimizer's
        parameters (AdamW casts its moments to each parameter's device);
        full tensors are cut for this rank under a tensor-parallel group."""
        if self.tp is not None:
            state = self._map_split(state, lambda named: shard_state_tp(named, self.tp))
        self.adamw.load_state_dict(state["adamw"])
        acc = state["acc"]
        self._acc = None if acc is None else [
            a.to(device=p.device, dtype=torch.float32, copy=True) for a, p in zip(acc, self.params)]
        self.mini_step = int(state["mini_step"])
        self.updates = int(state["updates"])


def build_optimizer(
    model: nn.Module, config: TrainingConfig, *, start_epoch: int = 0
) -> tuple[AccumulatingAdamW, dict[str, Callable]]:
    """Returns (optimizer, schedules), schedules mapping group name
    ("backbone" / "rest") to its epoch-indexed LR schedule; the LRs start at
    ``schedules[g](start_epoch)``."""
    schedules = {
        group: make_epoch_lr_schedule(
            base_lr,
            epochs=config.epochs,
            warmup_epochs=config.lr_warmup_epochs,
            warmup_decay=config.lr_warmup_decay,
            hold_epochs=config.lr_hold_max_epochs,
            # one absolute eta_min for both groups, as torch's
            # CosineAnnealingLR has in the reference
            lr_min=config.lr_min,
        )
        for group, base_lr in (("backbone", config.lr_backbone), ("rest", config.lr))
    }
    lrs = {g: s(start_epoch) for g, s in schedules.items()}
    return AccumulatingAdamW(model, config, lrs), schedules
