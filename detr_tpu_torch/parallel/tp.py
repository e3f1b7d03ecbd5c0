"""Tensor (model) parallelism for the DETR transformer, Megatron style
(counterpart of ``detr_tpu/parallel/tp.py``).

The ``tp_size`` adjacent ranks of one row of the grid split every
transformer block between them:

  * ``query_proj``, ``key_proj``, ``value_proj`` and ``ffn.layers.0`` (fc1)
    by columns: in ``nn.Linear`` the weight's rows and the bias.  The layout
    is head-major, so rank t holds heads ``[t·H/tp, (t+1)·H/tp)`` and the
    attention itself stays local;
  * ``output_proj`` and ``ffn.layers.3`` (fc2) by rows: the weight's
    columns.  Each rank's product is a partial sum, all-reduced
    (``reduce_from_group``: all-reduce forward, identity backward), and the
    bias, replicated, is added once after it;
  * at each block's input, ``copy_to_group`` (identity forward, all-reduce
    backward) sums the input gradients of the ranks' heads or columns;
  * everything else (the backbone, norms, embeddings, heads) is replicated.

The JAX package states these rules on its (in, out) kernels; ``param_specs``
gives them in the torch layout, by parameter name.  The AdamW moments and
the accumulated gradient follow their parameter's split
(``train.optimizer``); checkpoints hold the full tensors, gathered by
``gather_state_tp`` and cut again by ``shard_state_tp``, so they restore
into any layout.  ``num_attention_heads`` must divide by the group's size
(``validate_tp``), and a group may not span nodes: the port runs one process
per card, so its groups span processes of one node, the JAX package's
layout (TP within a host, DP across hosts).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from detr_tpu_torch.parallel.distributed import _host_collectives, host_group
from detr_tpu_torch.parallel.mesh import Grid, _world

# (name fragment, split of the weight, split of the bias); the first match
# wins.  0 is a column split of nn.Linear (its output features), 1 a row
# split (its input features), None replicated.
_RULES = (
    (".query_proj.", 0, 0),
    (".key_proj.", 0, 0),
    (".value_proj.", 0, 0),
    (".output_proj.", 1, None),
    (".ffn.layers.0.", 0, 0),
    (".ffn.layers.3.", 1, None),
)


@dataclass(frozen=True)
class TensorParallel:
    """A tensor-parallel group as the model's modules see it."""

    group: Any
    rank: int
    size: int


def make_mesh_2d(num_devices: int = 0, model_parallel: int = 1) -> Grid:
    """The (data, model) grid: rows of ``model_parallel`` adjacent ranks are
    the tensor-parallel groups, columns the data-parallel groups.  Every rank
    creates every group, in one order, as ``new_group`` requires."""
    rank, world, distributed = _world(num_devices)
    if model_parallel > 1 and not distributed:
        raise ValueError(f"model_parallel={model_parallel} needs that many ranks: launch with "
                         "torchrun (one process per card)")
    if world % model_parallel:
        raise ValueError(f"{world} ranks not divisible by model_parallel={model_parallel}")
    if not distributed:
        return Grid()
    dp_size = world // model_parallel
    tp_group = dp_group = None
    for row in range(dp_size):
        g = dist.new_group([row * model_parallel + t for t in range(model_parallel)])
        if rank // model_parallel == row:
            tp_group = g
    for col in range(model_parallel):
        g = dist.new_group([d * model_parallel + col for d in range(dp_size)])
        if rank % model_parallel == col:
            dp_group = g
    return Grid(rank=rank, world=world, tp_size=model_parallel, dp_group=dp_group,
                tp_group=tp_group, host_group=host_group())


def tensor_parallel(grid: Grid) -> Optional[TensorParallel]:
    """The model's view of the grid's tensor-parallel group; None without
    one."""
    if grid.tp_size <= 1:
        return None
    return TensorParallel(grid.tp_group, grid.tp_rank, grid.tp_size)


def validate_tp(detr_config, grid: Grid) -> None:
    """The JAX package's rules: whole heads per rank, and each
    tensor-parallel group within one node (torchrun's ``LOCAL_WORLD_SIZE``
    ranks per node, numbered node by node)."""
    tp = grid.tp_size
    if tp <= 1:
        return
    heads = detr_config.num_attention_heads
    if heads % tp:
        raise ValueError(f"num_attention_heads={heads} must divide by the model-axis size {tp} "
                         "(whole heads are sharded)")
    ffn = detr_config.ffn_hidden_size
    if ffn % tp:
        raise ValueError(f"the FFN width {ffn} must divide by the model-axis size {tp}")
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", grid.world))
    if per_node % tp:
        first = grid.rank - grid.tp_rank
        raise ValueError(
            f"model-axis group {list(range(first, first + tp))} spans nodes of {per_node} ranks "
            "each: tensor-parallel groups must stay within one node (DP across nodes x TP "
            "within a node); pick a model_parallel that divides the ranks per node")


def _split(name: str) -> tuple[Optional[int], Optional[int]]:
    for fragment, weight, bias in _RULES:
        if fragment in f".{name}":
            return weight, bias
    return None, None


def param_specs(names) -> dict[str, Optional[int]]:
    """{parameter name: the dim it is split on in the torch layout, or None
    when replicated}, for an iterable of ``state_dict`` names (a module's
    ``named_parameters`` names, say)."""
    specs = {}
    for name in names:
        weight, bias = _split(name)
        specs[name] = weight if name.endswith(".weight") else bias if name.endswith(".bias") \
            else None
    return specs


def shard_state_tp(state: dict[str, torch.Tensor], tp: Optional[TensorParallel]) -> dict:
    """This rank's slices of full tensors by name (parameters, or anything
    keyed like them: moments, gradients); replicated entries as they are."""
    if tp is None:
        return dict(state)
    specs = param_specs(state)
    out = {}
    for name, t in state.items():
        dim = specs[name]
        if dim is None:
            out[name] = t
        else:
            n = t.shape[dim] // tp.size
            out[name] = t.narrow(dim, tp.rank * n, n).contiguous()
    return out


def gather_state_tp(state: dict[str, torch.Tensor], tp: Optional[TensorParallel]) -> dict:
    """The inverse of ``shard_state_tp``: full tensors by name, on every rank
    of the group (on the CPU under gloo), from each rank's slices."""
    if tp is None:
        return dict(state)
    specs = param_specs(state)
    out = {}
    for name, t in state.items():
        dim = specs[name]
        if dim is None:
            out[name] = t
            continue
        src = t.detach().contiguous()
        if _host_collectives():
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(tp.size)]
        dist.all_gather(parts, src, group=tp.group)
        out[name] = torch.cat(parts, dim=dim).to(t.device)
    return out


def _all_reduce_fp32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group, added in fp32 and returned in x's dtype
    (gloo and NCCL alike take fp32 on the card and the host)."""
    y = x.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_fp32(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """x, whose gradient is summed over ``group`` (a block's input)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group``, with the identity gradient: every rank's x
    receives the gradient of the sum (a row split's partial products; the
    criterion's sums over the data-parallel group)."""
    return _ReduceFromGroup.apply(x, group)
