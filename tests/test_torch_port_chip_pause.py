"""The port's card sharing (``detr_tpu_torch.utils.chip_pause``): the cases
of ``tests/test_chip_pause.py`` on the port's module, and the training loop
waiting before its next micro-step while a fresh pause file is held by
another process, and ignoring a stale one; on two gloo ranks, both wait
when one of them finds the file."""

import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import torch

import torch_ranks
from detr_tpu_torch.config import TrainingConfig
from detr_tpu_torch.parallel.launch import spawn
from detr_tpu_torch.train import trainer
from detr_tpu_torch.utils import chip_pause as cp
from detr_tpu_torch.utils.profiling import StepTimer

ROOT = Path(__file__).resolve().parent.parent


def test_request_and_release(tmp_path):
    path = str(tmp_path / "pause")
    assert not cp.pause_requested(path)
    with cp.request_chip_pause(path):
        # held, with our pid, and visible to other processes only: a holder
        # that honoured its own file would wait for itself
        assert os.path.exists(path)
        assert open(path).read() == str(os.getpid())
        assert not cp.pause_requested(path)
    assert not cp.pause_requested(path)
    assert not os.path.exists(path)


def test_another_process_pause_is_honoured(tmp_path):
    path = str(tmp_path / "pause")
    with open(path, "w") as f:
        f.write(str(os.getpid() + 1))
    assert cp.pause_requested(path)


def test_stale_file_is_ignored(tmp_path):
    path = str(tmp_path / "pause")
    with open(path, "w") as f:
        f.write("dead-bench")
    old = time.time() - cp.FRESH_SECS - 10
    os.utime(path, (old, old))
    assert not cp.pause_requested(path)


def test_the_path_is_named_by_the_environment_or_in_the_temporary_directory():
    assert cp.PAUSE_FILE == os.environ.get(
        "DETR_CHIP_PAUSE_FILE", os.path.join(tempfile.gettempdir(), "detr_chip_pause"))


class _Dog:
    def __init__(self):
        self.beats = 0

    def beat(self):
        self.beats += 1


def _release_after(path: str, secs: float) -> threading.Thread:
    def release():
        time.sleep(secs)
        os.unlink(path)

    t = threading.Thread(target=release)
    t.start()
    return t


def test_wait_while_paused_blocks_then_returns(tmp_path):
    path = str(tmp_path / "pause")
    with open(path, "w") as f:
        f.write("bench")
    dog = _Dog()
    t = _release_after(path, 0.5)
    waited = cp.wait_while_paused(dog, poll_secs=0.05, path=path)
    t.join(timeout=10)
    assert not t.is_alive()
    assert waited >= 0.4
    assert dog.beats >= 5  # the watchdog kept alive throughout


def test_wait_without_a_pause_is_instant(tmp_path):
    assert cp.wait_while_paused(None, poll_secs=0.05, path=str(tmp_path / "x")) < 0.05


def test_sigterm_while_holding_the_pause_removes_the_file(tmp_path):
    path = str(tmp_path / "pause")
    code = ("import time\n"
            "from detr_tpu_torch.utils.chip_pause import request_chip_pause\n"
            f"with request_chip_pause({path!r}):\n"
            "    print('held', flush=True)\n"
            "    time.sleep(60)\n")
    p = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
                         cwd=ROOT)
    try:
        assert p.stdout.readline().strip() == "held"
        assert os.path.exists(path)
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=30) == 143
    finally:
        p.kill()
        p.stdout.close()
    assert not os.path.exists(path)


class _Tracker:
    def log_scalars(self, scalars, step):
        pass

    def log_loss_dict(self, loss_dict, step, split="train"):
        pass


def _epoch(path: Path, on_first_step=None) -> list[float]:
    """Three micro-steps of ``trainer._train_epoch`` with a stub step;
    returns the time each began."""
    starts = []

    def step(state, batch):
        starts.append(time.monotonic())
        if len(starts) == 1 and on_first_step is not None:
            on_first_step()
        state.step += 1
        return state, {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(0.5)}

    config = TrainingConfig(prefetch_depth=0, log_frequency=100, host_rss_limit_gb=0)
    trainer._train_epoch(config, [{}, {}, {}], lambda b: b, step, SimpleNamespace(step=0), 0,
                         {"backbone": 1e-5, "rest": 1e-4}, StepTimer(1), _Tracker(), _Dog())
    return starts


def test_the_training_loop_waits_for_a_fresh_pause(tmp_path, monkeypatch, caplog):
    """A benchmark takes the card during the first micro-step and leaves
    0.5 s later: the second micro-step starts only after it left, and the
    loop logs the wait."""
    path = tmp_path / "pause"
    monkeypatch.setattr(cp, "PAUSE_FILE", str(path))
    releasers = []

    def bench_arrives():
        path.write_text("another pid")
        releasers.append(_release_after(str(path), 0.5))

    with caplog.at_level(logging.INFO, logger="detr_tpu_torch.train.trainer"):
        starts = _epoch(path, bench_arrives)
    releasers[0].join(timeout=10)
    assert len(starts) == 3 and starts[1] - starts[0] >= 0.5
    assert [r for r in caplog.records if "chip pause honoured" in r.getMessage()]


def test_the_training_loop_ignores_a_stale_pause(tmp_path, monkeypatch, caplog):
    path = tmp_path / "pause"
    path.write_text("dead-bench")
    old = time.time() - cp.FRESH_SECS - 10
    os.utime(path, (old, old))
    monkeypatch.setattr(cp, "PAUSE_FILE", str(path))
    with caplog.at_level(logging.INFO, logger="detr_tpu_torch.train.trainer"):
        starts = _epoch(path)
    assert len(starts) == 3 and starts[-1] - starts[0] < 0.5
    assert not [r for r in caplog.records if "chip pause" in r.getMessage()]


def test_ranks_pause_together(tmp_path):
    """Rank 0 finds a fresh pause file during the first micro-step and rank 1
    does not: both ranks wait before the second, and both watchdogs beat
    through the wait.  A rank that waited alone would leave the other
    blocked in the step's all-reduce, its watchdog silent."""
    hold = 0.5
    ranks = spawn(torch_ranks.pause_rank, 2, args=(dict(dir=str(tmp_path), hold=hold),),
                  timeout=120)
    for r in ranks:
        starts, beats = r["starts"], r["beats"]
        assert len(starts) == 3 and starts[1] - starts[0] >= hold
        assert len([b for b in beats if starts[0] < b < starts[1]]) >= 2  # the step's, a wait's
