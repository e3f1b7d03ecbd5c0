"""The readings that the correctness limits are set from, outside the
benchmark's own runs.

    python3 -m benchmark.control --workload <name> --seeds 11,12,13

For each seed it makes a run's inputs (weights, batches or the pool, the
sample of requests), and prints one JSON line per reading of the numbers the
cell compares:

- ``control``: the reference in fp8 (float8 e4m3 operands, per-tensor
  scale; the precision below the configuration's bf16) in the program's
  place, against the reference in fp32;
- training, ``fault.half_batch``: the reference on the first half of each
  batch, the mean over that half, in the program's place;
- serving, ``fault.answer``: the reference's answers with each query's label
  moved to the next class and its box shifted by a tenth of its side.

A state left unchanged (the step that returns its state as it was) reads 1
in ``change_gap`` by construction and needs no run.  The program's own
readings (the lower ones) are those of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch


def train_readings(run, device) -> list[dict]:
    from benchmark.drivers import train
    from benchmark.reference import model as rm
    from benchmark.reference import weights

    detr, tc = train.configs(run)
    tr, cfg = run.traffic, run.config["model"]
    sd_cpu = {n: t.cpu() for n, t in weights.make(cfg, run.seed, device).items()}
    tmp = tempfile.mkdtemp(prefix="bench_control_")
    feed, loader = train.make_feed(run, detr, tc, device, tmp)
    try:
        batches = [{k: v.cpu() for k, v in next(feed).items()}
                   for _ in range(tr["checked_steps"] * tr["accumulation"])]
    finally:
        feed.close()
        if loader is not None:
            loader.close()
        shutil.rmtree(tmp, ignore_errors=True)
    args = (sd_cpu, cfg, run.config["train"], batches, run.seed, device, tr)
    t0 = time.perf_counter()
    ref = train.follow(*args)
    out = [{"reading": "reference_seconds", "seconds": time.perf_counter() - t0}]
    for label, kw in (("control", {"P": rm.FP8}), ("fault.half_batch", {"fault": "half_batch"})):
        got = train.follow(*args, **kw)
        out.append({"reading": label, **train.compare(got, ref, tr["accumulation"])})
    return out


def serve_readings(run, device) -> list[dict]:
    from benchmark import data
    from benchmark.drivers import serve
    from benchmark.reference import model as rm
    from benchmark.reference import weights

    tr, cfg = run.traffic, run.config["model"]
    sd_cpu = {n: t.cpu() for n, t in weights.make(cfg, run.seed, device).items()}
    pool = data.serve_pool(tr, run.seed, device)
    rng = np.random.default_rng(run.seed)
    imgs = [pool[i] for i in rng.choice(len(pool), size=tr["checked_requests"], replace=False)]
    sizes = [img.shape[:2] for img in imgs]
    ref = serve.reference(sd_cpu, cfg, tr, imgs, device)
    low = serve.reference(sd_cpu, cfg, tr, imgs, device, rm.FP8)

    def served(dets):
        return [{k: d[k].cpu().numpy() for k in ("scores", "labels", "boxes")} for d in dets]

    altered = []
    for d in served(ref):
        side = np.concatenate([d["boxes"][:, 2:] - d["boxes"][:, :2]] * 2, axis=1)
        altered.append({"scores": d["scores"], "labels": (d["labels"] + 1) % len(ref[0]["probs"][0]),
                        "boxes": d["boxes"] + 0.1 * side})
    return [{"reading": "control", **serve.compare(served(low), ref, sizes)},
            {"reading": "fault.answer", **serve.compare(altered, ref, sizes)}]


def main(argv=None) -> int:
    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    manifest = harness.load_manifest()
    workload, config, traffic = harness.cell(manifest, args.workload)
    if not torch.cuda.is_available():
        print("benchmark.control: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(workload, config, traffic, seed, 0.0, False, 0.0)
        readings = (train_readings if traffic["kind"] == "train" else serve_readings)(run, device)
        for r in readings:
            print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
