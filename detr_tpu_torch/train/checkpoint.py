"""Checkpoints of the training state (counterpart of
``detr_tpu/train/checkpoint.py``, in the port's own format instead of orbax).

``<output_dir>/checkpoints/<step>/state.pt`` is one ``torch.save`` of
tensors and plain Python, on the CPU whatever device trained it:

  * ``params``: the model's parameters by ``state_dict`` name;
  * ``frozen``: its buffers (the frozen-BN statistics);
  * ``opt_state``: ``AccumulatingAdamW.state_dict()`` (moments, step counts,
    learning rates, the accumulated gradient, micro-step and update counts);
  * ``step``: ``TrainState.step``; ``rng``: the CPU generator's state, which
    draws the dropout seeds;
  * ``extra``: ``{"epoch"}``.

A checkpoint is written under a temporary name and renamed into place, so a
crash never leaves a half-written one where ``latest_step`` looks; the
newest ``max_to_keep`` are kept.  ``restore_params_only`` and
``save_params_only`` are the weights-only resume of the reference (fresh
optimizer, schedule fast-forwarded by ``start_epoch``), and read either
layout.  Loading uses ``torch.load(weights_only=True)``.

Multi-rank runs (``parallel``): a checkpoint holds the full tensors, as the
JAX package's ``jax.device_get(state)`` does.  ``save`` is called on every
rank: the tensor-parallel slices of the parameters, moments and accumulated
gradient are gathered (a collective), rank 0 alone writes, and every rank
waits for the file at a barrier.  A restore reads the full tensors on every
rank and cuts this rank's slices, so a checkpoint of one layout restores
into any other.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

from detr_tpu_torch.parallel.distributed import barrier, is_primary
from detr_tpu_torch.parallel.tp import gather_state_tp, shard_state_tp
from detr_tpu_torch.utils.trees import tree_map

STATE_FILE = "state.pt"
_TMP_PREFIX = ".tmp-"


def load_model_payload(model: torch.nn.Module, payload: dict) -> None:
    """Copy a payload's params and frozen statistics into ``model`` (strict:
    every name, no other); full tensors are cut for a tensor-parallel
    model's rank."""
    params = shard_state_tp(payload["params"], getattr(model, "tp", None))
    model.load_state_dict({**params, **payload["frozen"]}, strict=True)


def model_params(model: torch.nn.Module) -> dict:
    """The model's parameters by name, full tensors (a tensor-parallel
    model's slices gathered over its group: a collective)."""
    return gather_state_tp(dict(model.named_parameters()), getattr(model, "tp", None))


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.path.join(directory, "checkpoints"))
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def steps(self) -> list[int]:
        """Complete checkpoints, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(os.path.join(self.directory, d, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _write(self, step: int, payload: dict) -> None:
        """Rank 0 writes; every rank returns once the file is in place."""
        if is_primary():
            self._write_file(step, payload)
        barrier()

    def _write_file(self, step: int, payload: dict) -> None:
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)  # and the checkpoints directory, the first time
        torch.save(tree_map(lambda t: t.detach().cpu(), payload), os.path.join(tmp, STATE_FILE))
        final = self._path(step)
        if os.path.exists(final):  # saving a step again replaces it
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old))

    def save(self, step: int, state: Any, extra: Optional[dict] = None) -> None:
        """Full state of a ``TrainState`` at ``step``; ``extra`` {"epoch"}.
        Every rank of a multi-rank run calls it."""
        self._write(step, {
            "params": model_params(state.model),
            "frozen": dict(state.model.named_buffers()),
            "opt_state": state.optimizer.state_dict(),
            "step": int(state.step),
            "rng": state.generator.get_state(),
            "extra": {"epoch": int((extra or {}).get("epoch", 0))},
        })

    def save_params_only(self, step: int, params: dict, frozen: dict) -> None:
        """A weights-only artifact: {params, frozen} by ``state_dict`` name."""
        self._write(step, {"params": params, "frozen": frozen})

    def restore_payload(self, step: Optional[int] = None) -> dict:
        """The saved dict as it is, on the CPU (the serving engine reads its
        params and frozen statistics from it)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(os.path.join(self._path(step), STATE_FILE), map_location="cpu",
                          weights_only=True)

    def restore(self, state: Any, step: Optional[int] = None) -> tuple[Any, dict]:
        """Full-state restore into ``state`` (its model, optimizer and
        generator, in place, on their devices); returns (state, extra)."""
        payload = self.restore_payload(step)
        if "opt_state" not in payload:
            raise ValueError(f"checkpoint {step} under {self.directory} holds weights only")
        load_model_payload(state.model, payload)
        state.optimizer.load_state_dict(payload["opt_state"])
        state.generator.set_state(payload["rng"])
        state.step = int(payload["step"])
        return state, payload["extra"]

    def restore_params_only(self, state: Any, step: Optional[int] = None) -> Any:
        """Weights-only resume: params and frozen statistics from a full or a
        weights-only checkpoint; the optimizer, step and generator stay."""
        load_model_payload(state.model, self.restore_payload(step))
        return state
