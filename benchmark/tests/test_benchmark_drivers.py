"""A rehearsal of both drivers on the CPU at a tiny size, through the loop,
the result line and the correctness comparison; the faults that the
comparison must catch; and, on a card, one real run of each cell.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest
import torch

import tiny
from benchmark import harness

torch.set_num_threads(2)
MANIFEST = harness.load_manifest()


def _drive(run):
    harness.driver(run.traffic["kind"]).run(run, torch.device("cpu"))
    return run


@pytest.mark.parametrize("kind", sorted(tiny.TRAFFIC))
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(kind, trace):
    run = _drive(tiny.make_run(kind, trace))
    assert run.correct, run.checks
    assert set(run.checks) == set(tiny.LIMITS[run.traffic["kind"]])
    assert run.attempted > 0 and run.failed == 0
    assert run.metrics["setup_s"][0] > 0
    rate = "train_images_per_s" if run.traffic["kind"] == "train" else (
        "serve_p95_ms" if kind == "poisson" else "serve_images_per_s")
    assert run.metrics[rate][0] > 0
    line = harness.result_line(run, MANIFEST)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    json.dumps(line)
    if trace:
        assert run.record  # a CPU trace holds no device work: readers return None
        assert all(harness.reader(m["name"])(run.record) is None or
                   math.isfinite(harness.reader(m["name"])(run.record))
                   for m in MANIFEST["per_layer"])


def test_fault_state_unchanged(monkeypatch):
    """The optimizer accumulates but never updates: the step returns its
    parameters as they were."""
    from detr_tpu_torch.train import optimizer

    def no_update(self, grads):
        self.mini_step = (self.mini_step + 1) % self.every_k
        return False

    monkeypatch.setattr(optimizer.AccumulatingAdamW, "apply_gradients", no_update)
    run = _drive(tiny.make_run("resident"))
    assert not run.correct
    assert run.checks["change_gap"][0] > 0.5


def test_fault_half_batch(monkeypatch):
    """The step trains on the first half of each batch, the mean over it."""
    from benchmark.drivers import train

    inner = train.Program.__call__

    def half(self, batch):
        n = batch["image"].shape[0] // 2
        return inner(self, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(train.Program, "__call__", half)
    run = _drive(tiny.make_run("coco"))
    assert not run.correct
    assert run.checks["loss_gap"][0] > run.checks["loss_gap"][1]


@pytest.mark.parametrize("what", ["labels", "boxes"])
def test_fault_answer_altered(monkeypatch, what):
    """Each answer is altered where it is produced: its label moved to the
    next class, or its box shifted by a tenth of its side."""
    from detr_tpu_torch.serve import engine

    inner = engine.postprocess_predictions

    def altered(*args):
        det = inner(*args)
        if what == "labels":
            det["labels"] = (det["labels"] + 1) % 80
        else:
            side = (det["boxes"][..., 2:] - det["boxes"][..., :2]).repeat(1, 1, 2)
            det["boxes"] = det["boxes"] + 0.1 * side
        return det

    monkeypatch.setattr(engine, "postprocess_predictions", altered)
    run = _drive(tiny.make_run("backlog"))
    assert not run.correct


def test_no_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "serve_r50_offline", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=tiny.ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed",
         str(2**31 + 101), "--seconds", "5", "--trace", "1"], cwd=tiny.ROOT,
        capture_output=True, text=True, timeout=360, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
