"""Entry points of the port (counterpart of the repository's
``__graft_entry__.py``).

``entry()``  -> (fn, example_args): the forward of DETR-R50 (the default
                ``DETRConfig``: bf16 compute, fp32 parameters) in eval mode
                on the card, random weights from seed 0 (or ``state_dict``),
                with a 640x640 synthetic image as its example arguments.
``dryrun_multichip(n)`` -> one full train step (forward, matching, set
                loss, backward, AdamW update) at tiny shapes over ``n``
                gloo ranks on the CPU, spawned here: dp x tp with tp = 2 when
                ``n`` is even (``parallel.tp``: the heads and the FFN split
                Megatron style), pure dp when it is odd.

    python -m detr_tpu_torch.entry            # entry() on the card
    python -m detr_tpu_torch.entry --dryrun 4  # dryrun_multichip(4) on the CPU
"""

from __future__ import annotations

import argparse
import math
from typing import Optional

import numpy as np
import torch

from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.data.synthetic import synthetic_batch
from detr_tpu_torch.models import build_detector


def entry(device: Optional[str] = None, state_dict: Optional[dict] = None):
    """(fn, (images, heights, widths)): ``fn`` is the eval-mode forward of
    DETR-R50 at full width (``models.build_detector`` on the default
    ``DETRConfig``) on ``device`` (the card by default), returning
    ``pred_logits`` and ``pred_boxes``; the weights are the seed-0 random
    init, or ``state_dict``."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry() runs on a CUDA card; pass device='cpu' for the CPU")
    model = build_detector(DETRConfig())
    if state_dict is None:
        model.reset_parameters(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state_dict, strict=True)
    model.to(device).eval()
    batch = synthetic_batch(np.random.default_rng(0), batch_size=1, height=640, width=640,
                            max_gt=25)
    args = tuple(torch.from_numpy(batch[k]).to(device) for k in ("image", "height", "width"))

    @torch.no_grad()
    def fn(images, heights, widths):
        return model(images, heights, widths)

    return fn, args


def _dryrun_rank(rank: int, n_devices: int) -> dict:
    """One rank of ``dryrun_multichip``."""
    from detr_tpu_torch.parallel import assert_divisible, make_mesh, make_mesh_2d, shard_batch
    from detr_tpu_torch.parallel import validate_tp
    from detr_tpu_torch.train.optimizer import build_optimizer
    from detr_tpu_torch.train.train_step import TrainState, build_criterion, make_train_step
    from detr_tpu_torch.train.trainer import build_model, to_device

    detr_config = DETRConfig(dtype="float32")  # the full flagship architecture
    tp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    if tp > 1:
        grid = make_mesh_2d(n_devices, model_parallel=tp)
        validate_tp(detr_config, grid)
    else:
        grid = make_mesh(n_devices)
    batch_size = grid.dp_size  # one image per data-parallel rank
    assert_divisible(batch_size, grid)
    train_config = TrainingConfig(cumulative_train_batch_size=1, train_batch_size=1,
                                  num_devices=n_devices, model_parallel=tp)
    model = build_model(detr_config, 0, grid)
    optimizer, _ = build_optimizer(model, train_config)
    state = TrainState(model, optimizer, torch.Generator().manual_seed(0))
    batch = synthetic_batch(np.random.default_rng(0), batch_size=batch_size, height=64, width=64,
                            max_gt=10)
    block, _ = shard_batch(batch, grid)
    step = make_train_step(model, build_criterion(train_config, detr_config), grid=grid)
    state, metrics = step(state, to_device(block, torch.device("cpu")))
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss in the multi-rank dry run: {loss}")
    if state.step != 1 or optimizer.updates != 1:
        raise AssertionError(f"{state.step} steps and {optimizer.updates} updates, want 1 and 1")
    q = model.encoder.layers[0].self_attention.query_proj.weight
    if tuple(q.shape) != (detr_config.hidden_size // tp, detr_config.hidden_size):
        raise AssertionError(f"query_proj is {tuple(q.shape)} on a rank of tp={tp}")
    return {"loss": loss, "dp": grid.dp_size, "tp": tp}


def dryrun_multichip(n_devices: int, timeout: float = 900.0) -> dict:
    """One full train step over ``n_devices`` gloo ranks on the CPU (dp x tp
    with tp = 2 when even, pure dp when odd): a finite loss, one update, the
    tensor-parallel parameters split.  Returns rank 0's
    {"loss", "dp", "tp"}."""
    from detr_tpu_torch.parallel.launch import spawn

    results = spawn(_dryrun_rank, n_devices, args=(n_devices,), backend="gloo", timeout=timeout)
    losses = {r["loss"] for r in results}
    if len(losses) != 1:
        raise AssertionError(f"the ranks report different global losses: {sorted(losses)}")
    out = results[0]
    print(f"dryrun_multichip({n_devices}): ok, loss={out['loss']:.4f} "
          f"(dp={out['dp']} x tp={out['tp']})")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("The port's entry points.")
    parser.add_argument("--dryrun", type=int, default=0,
                        help="run dryrun_multichip(N) on the CPU instead of entry()")
    args = parser.parse_args(argv)
    if args.dryrun:
        dryrun_multichip(args.dryrun)
        return 0
    fn, example = entry()
    out = fn(*example)
    print({k: tuple(v.shape) for k, v in out.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
