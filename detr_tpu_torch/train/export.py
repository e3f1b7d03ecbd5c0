"""Distil a full training checkpoint into a weights-only artifact
(counterpart of ``scripts/export_weights.py``).

    python -m detr_tpu_torch.train.export RUN_DIR OUT_DIR [--step N]

reads ``RUN_DIR``'s checkpoint (the newest, or step ``N``) through
``CheckpointManager``, writes its parameters and frozen-BN statistics alone
(``save_params_only``: no AdamW moments, accumulated gradient or generator,
a fraction of the bytes) under ``OUT_DIR/checkpoints/<step>/``, and writes
``OUT_DIR/EPOCH``, the epoch after the checkpoint's.  A later run resumes
from the artifact with the weights-only path::

    python -m detr_tpu_torch.train.trainer --resume-from-checkpoint OUT_DIR \\
        --start-epoch $(cat OUT_DIR/EPOCH) ...

``EPOCH`` is written under a temporary name and renamed, so a run cut
between the two writes never leaves an artifact whose ``EPOCH`` belongs to
another checkpoint.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from detr_tpu_torch.train.checkpoint import CheckpointManager

EPOCH_FILE = "EPOCH"


def export_weights(run_dir: str, out_dir: str, step: Optional[int] = None) -> tuple[int, Optional[int]]:
    """Write ``run_dir``'s checkpoint ``step`` (default: the newest) as a
    weights-only artifact in ``out_dir``; returns (step, epoch), the epoch
    None when the checkpoint records none (then no ``EPOCH`` is written)."""
    src = CheckpointManager(run_dir)
    step = src.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {run_dir}")
    payload = src.restore_payload(step)
    CheckpointManager(out_dir, max_to_keep=1).save_params_only(
        step, payload["params"], payload["frozen"])
    epoch = payload.get("extra", {}).get("epoch")
    if epoch is not None:
        path = os.path.join(out_dir, EPOCH_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(int(epoch) + 1))
        os.replace(tmp, path)
    return step, epoch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("Export a checkpoint's weights (params + frozen).")
    parser.add_argument("run_dir", help="the trainer's output dir (holds checkpoints/)")
    parser.add_argument("out_dir", help="the artifact's dir (checkpoints/ and EPOCH inside)")
    parser.add_argument("--step", type=int, default=None, help="default: the newest")
    args = parser.parse_args(argv)
    try:
        step, epoch = export_weights(args.run_dir, args.out_dir, args.step)
    except FileNotFoundError as e:
        raise SystemExit(str(e))
    print(f"exported step {step} (epoch {epoch}) -> {args.out_dir}: params + frozen only")
    return 0


if __name__ == "__main__":
    sys.exit(main())
