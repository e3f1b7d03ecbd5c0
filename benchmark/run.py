"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

loads the cell's configuration and traffic (``BENCHMARK.json``), sets up
the program (weights from the seed, data, warm-up of every shape the cell
uses), measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, ``breakdown`` (traced), and ``checks``, each number compared
beside its limit, which also end standard error.  Without a CUDA card, or
with fewer cards than the cell asks for, it exits 3 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
# Caches of the run stay in the checkout (the port builds its kernels into
# build/ there); no library loads JAX behind the port's back.
os.environ.setdefault("TRITON_CACHE_DIR", str(_ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    from benchmark import harness

    t_start = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    manifest = harness.load_manifest()
    workload, config, traffic = harness.cell(manifest, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"benchmark: needs {workload['chips']} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    run = harness.Run(workload, config, traffic, args.seed, args.seconds, bool(args.trace),
                      t_start, harness.limits(args.workload))
    harness.driver(traffic["kind"]).run(run, torch.device("cuda"))
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}", file=sys.stderr)
        return 4
    line = harness.result_line(run, manifest)
    for name, (value, limit) in run.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
