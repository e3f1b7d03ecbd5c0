"""The readings that the Deformable DETR cell's correctness limits are set
from, outside the benchmark's own runs (``benchmark.control``'s training
readings, for the ``train_deformable`` kind).

    python3 -m benchmark.control_deformable --workload train_deformable_resident --seeds 11,12
    python3 -m benchmark.control_deformable --workload train_deformable_resident --seeds 11,12 \
        --program --no-faults

For each seed it makes a run's weights and batches and prints one JSON line
per reading of the numbers the cell compares, each against the reference in
fp32 with its own exact assignment: ``control``, the reference in fp8
(float8 e4m3 operands, per-tensor scale, the sampled value maps too: the
precision below the configuration's bf16) in the program's place;
``fault.half_batch``, the reference on the first half of each batch (left
out with ``--no-faults``); with ``--program``, ``program``: the port's
checked steps as the cell runs them (``drivers.train_deformable``'s
``Program`` and ``drivers.train.checked_steps``), so that one fp32
reference serves the program's reading and the control's.  A state left
unchanged reads 1 in ``change_gap`` by construction.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time

import torch


def readings(run, device, program: bool = False, faults: bool = True) -> list[dict]:
    from benchmark.drivers import train as base
    from benchmark.drivers import train_deformable as td
    from benchmark.reference import deformable_weights
    from benchmark.reference import model as rm

    detr, tc = td.configs(run)
    tr, cfg = run.traffic, run.config["model"]
    k = tr["accumulation"]
    sd = deformable_weights.make(cfg, run.seed, device)
    sd_cpu = {n: t.to("cpu", copy=True) for n, t in sd.items()}
    tmp = tempfile.mkdtemp(prefix="bench_control_")
    feed, _ = base.make_feed(run, detr, tc, device, tmp)
    prog_readings = None
    try:
        if program:
            prog = td.Program(detr, tc, sd, run.seed, device)
            prog_readings, batches, _ = base.checked_steps(prog, feed, tr["checked_steps"], k,
                                                           sd_cpu)
            del prog
        else:
            batches = [{key: v.cpu() for key, v in next(feed).items()}
                       for _ in range(tr["checked_steps"] * k)]
    finally:
        feed.close()
        shutil.rmtree(tmp, ignore_errors=True)
    del sd, feed
    gc.collect()
    torch.cuda.empty_cache()
    args = (sd_cpu, cfg, run.config["train"], batches, run.seed, device, tr)
    t0 = time.perf_counter()
    ref = td.follow(*args)
    out = [{"reading": "reference_seconds", "seconds": time.perf_counter() - t0}]
    if prog_readings is not None:
        out.append({"reading": "program", **td.compare(prog_readings, ref, k),
                    "worst_leaves": worst_leaves(prog_readings, ref)})
    low = td.follow(*args, P=rm.FP8)
    out.append({"reading": "control", **td.compare(low, ref, k),
                "worst_leaves": worst_leaves(low, ref)})
    if faults:
        out.append({"reading": "fault.half_batch",
                    **td.compare(td.follow(*args, fault="half_batch"), ref, k)})
    return out


def worst_leaves(got: dict, ref: dict, n: int = 3) -> dict:
    """The ``n`` leaves of the largest first-gradient and parameter-change
    gaps, each over the reference's norm of the leaf or of the median leaf,
    whichever is larger (``compare``'s per-leaf gap), for the reader."""
    from statistics import median

    out = {}
    for key in ("grad_norms", "change_norms"):
        r, g = ref[key], got[key]
        med = median(r.values())
        gaps = sorted(((abs(g[x] - r[x]) / max(r[x], med), x) for x in r), reverse=True)
        out[key] = [[x, gap] for gap, x in gaps[:n]]
    return out


def main(argv=None) -> int:
    import benchmark.run  # noqa: F401  (the environment of a run)
    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true",
                    help="also read the port's checked steps against the same reference")
    ap.add_argument("--no-faults", action="store_true", help="leave out the half-batch fault")
    args = ap.parse_args(argv)
    manifest = harness.load_manifest()
    workload, config, traffic = harness.cell(manifest, args.workload)
    if not torch.cuda.is_available():
        print("benchmark.control_deformable: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(workload, config, traffic, seed, 0.0, False, 0.0)
        for r in readings(run, device, args.program, not args.no_faults):
            print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
