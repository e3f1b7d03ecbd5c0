"""The control of the correctness check at a size a test run holds: the
reference computed in fp8 (the precision below the configuration's) in the
program's place comes out as not correct, for training and for serving.

On the card, ``python3 -m benchmark.control --workload <cell> --seeds a,b,c``
reads the same at each cell's own size (``PERF.md`` holds the readings).

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import pytest
import torch

import tiny
from benchmark import control

torch.set_num_threads(2)


@pytest.mark.parametrize("kind", ["resident", "backlog"])
def test_control_is_not_correct(kind):
    run = tiny.make_run(kind)
    readings = {r["reading"]: r for r in
                (control.train_readings if run.traffic["kind"] == "train"
                 else control.serve_readings)(run, torch.device("cpu"))}
    limits = tiny.LIMITS[run.traffic["kind"]]
    for label in [r for r in readings if r.startswith(("control", "fault"))]:
        assert any(readings[label][n] > lim for n, lim in limits.items()), readings[label]
