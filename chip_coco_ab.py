#!/usr/bin/env python3
"""Phase 10 of ``chip_smoke.py`` on several checkouts of the port, one card.

Phase 10 trains DETR-R50 at full width for 24 micro-steps on 200
COCO-format JPEGs (the training augmentation in 2 spawned loader workers,
the default buckets, uint8, one validation batch), then times the loader
alone at 0 and 2 workers.  This script runs that phase once per argument,
each in a process of its own, in the order given, and prints one JSON line
per run and a summary.  An argument is a checkout's root, optionally with
environment settings for that run after an ``@``:

    git archive <parent> | tar -x -C build/parent
    python3 chip_coco_ab.py build/parent . .@OMP_NUM_THREADS=2 \\
        .@OMP_NUM_THREADS=2 . build/parent

Each run imports the named checkout's ``detr_tpu_torch`` (ahead of this
one's) and builds its kernels and, where it has them, its host C++
libraries before the phase; the phase's code is this checkout's
``chip_smoke.py``.  Compare runs only within one call: the card's power
limit is printed with each.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def run_one(tree: str) -> dict:
    """Phase 10 with ``tree``'s package, in this process."""
    sys.path.insert(0, str(Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)

    import detr_tpu_torch

    _, smi = smoke.phase_device()
    smoke.phase_build()
    try:  # built here, before the workers spawn, as chip_smoke.py does
        from detr_tpu_torch.data import _native
    except ImportError:
        native = None
    else:
        native = _native.built_flags() if _native.load() is not None else "did not build"
    root, t_gen = smoke.make_coco_data()
    t0 = time.perf_counter()
    try:
        report = smoke.phase_train_coco(smi, root, t_gen)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(
        tree=tree, package=str(Path(detr_tpu_torch.__file__).parent), card=smi,
        native_image_ops=native,
        env={k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "GOMP_SPINCOUNT")},
        phase_s=time.perf_counter() - t0, images_per_s=report["images_per_s"],
        ms_per_micro_step_median=report["ms_per_micro_step_median"],
        window_split=report["window_split"], losses=report["losses"],
        launches=report["launches"], loader_alone=report["loader_alone"])


def main(args: list[str]) -> None:
    if len(args) == 2 and args[0] == "--one":
        print("RESULT " + json.dumps(run_one(args[1])), flush=True)
        return
    if not args:
        raise SystemExit(__doc__)
    results = []
    for arg in args:
        tree, _, assignments = arg.partition("@")
        env = dict(os.environ)
        env.update(dict(a.split("=", 1) for a in assignments.split(",") if a))
        proc = subprocess.run([sys.executable, __file__, "--one", tree], env=env, cwd=HERE,
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", file=sys.stderr)
            raise SystemExit(f"{arg}: exit {proc.returncode}")
        result = json.loads(lines[-1][len("RESULT "):])
        result["arg"] = arg
        print(json.dumps(result), flush=True)
        results.append(result)
    for r in results:
        alone = {a["num_workers"]: round(a["images_per_s"], 2) for a in r["loader_alone"]}
        print(f"{r['arg']}: {r['images_per_s']:.2f} images/s, median micro-step "
              f"{r['ms_per_micro_step_median']:.1f} ms, waiting "
              f"{r['window_split']['waiting_for_batch_s']:.3f} s, loader alone {alone}, "
              f"native {r['native_image_ops']!r}, {r['card']}")


if __name__ == "__main__":
    main(sys.argv[1:])
