"""``benchmark/spans.py`` and the readers of the program's spans and counters,
held to hand-made buffers and device intervals: self time, clipping to the
window, the idle time by innermost span, and None without spans.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, spans

MS = 1_000_000  # ns
PID, TID = 10, 11


def _record(buffer, window_ms, counters=None, **extra):
    return dict(extra, spans=buffer, counters=counters or {}, span_pid=PID, span_tid=TID,
                trace={"window_s": window_ms / 1e3})


def _s(name, a, b, parent=-1, pid=PID, tid=TID):
    return (name, a * MS, b * MS, pid, tid, parent)


# A traced window of 100 ms from t=0 on the loop's thread: two micro-steps,
# each a wait and a step of five parts; a worker's items, one begun before
# the window; a prefetch thread's placement.
TRAIN = [
    _s("data.wait", 0, 10),                      # 0
    _s("train.step", 10, 50),                    # 1
    _s("train.prepare", 10, 12, 1),              # 2
    _s("train.forward", 12, 20, 1),              # 3
    _s("train.loss", 20, 30, 1),                 # 4
    _s("train.match", 22, 28, 4),                # 5
    _s("train.backward", 30, 45, 1),             # 6
    _s("train.optimizer", 45, 49, 1),            # 7
    _s("data.wait", 50, 55),                     # 8
    _s("train.step", 55, 95),                    # 9
    _s("train.prepare", 55, 57, 9),              # 10
    _s("train.forward", 57, 65, 9),              # 11
    _s("train.loss", 65, 75, 9),                 # 12
    _s("train.backward", 75, 90, 9),             # 13
    _s("train.optimizer", 90, 94, 9),            # 14
    _s("data.load", -20, 20, pid=20, tid=21),    # 15: half in the window
    _s("data.decode", -20, 0, 15, 20, 21),       # 16
    _s("data.load", 30, 90, pid=20, tid=22),     # 17
    _s("data.place", 60, 62, tid=30),            # 18
]


def test_window_starts_at_the_loops_first_span():
    rec = _record([_s("data.place", -5, -1, tid=30)] + TRAIN, 100)
    assert spans.window(rec) == (0, 100 * MS)
    assert spans.window(dict(rec, trace=None)) is None


def test_stats_self_time_and_clipping():
    got = spans.stats(TRAIN, (0, 100 * MS))
    assert got["train.step"]["count"] == 2
    assert got["train.step"]["total_s"] == pytest.approx(0.080)
    assert got["train.step"]["self_s"] == pytest.approx(0.002)  # 49-50 and 94-95
    assert got["train.loss"]["self_s"] == pytest.approx(0.014)  # 20 ms less the match's 6
    assert got["data.load"]["total_s"] == pytest.approx(0.080)  # 20 of 40 ms + 60
    assert got["data.load"]["self_s"] == pytest.approx(0.080)  # its decode lies outside
    assert "data.decode" not in got
    clipped = spans.stats(TRAIN, (0, 40 * MS))
    assert clipped["train.step"]["total_s"] == pytest.approx(0.030)
    assert clipped["train.backward"]["total_s"] == pytest.approx(0.010)


def test_idle_by_innermost_span():
    busy = [(12 * MS, 18 * MS), (40 * MS, 60 * MS), (96 * MS, 120 * MS)]
    got = spans.idle_by_span(TRAIN, (PID, TID), (0, 100 * MS), busy)
    # idle 0-12, 18-40, 60-96
    expect = {"data.wait": 0.010, "train.prepare": 0.002, "train.forward": 0.002 + 0.005,
              "train.loss": 0.004 + 0.010, "train.match": 0.006, "train.backward": 0.010 + 0.015,
              "train.optimizer": 0.004, "train.step": 0.001, spans.OUTSIDE: 0.001}
    assert got.keys() == expect.keys()
    for name, value in expect.items():
        assert got[name] == pytest.approx(value), name
    assert sum(got.values()) == pytest.approx(0.100 - 0.006 - 0.020 - 0.004)


def test_train_readers():
    rec = _record(TRAIN, 100, {"data.h2d_bytes": 2 * 6_709_248 + 5_000, "data.images": 4})
    read = {m: harness.reader(m)(rec) for m in (
        "data_wait_share.train", "loader_busy_workers.train", "h2d_mb_per_image.train",
        "forward_host_ms.train", "loss_host_ms.train", "backward_host_ms.train",
        "optimizer_host_ms.train")}
    assert read["data_wait_share.train"] == pytest.approx(15.0)
    assert read["loader_busy_workers.train"] == pytest.approx(0.8)
    assert read["h2d_mb_per_image.train"] == pytest.approx(3.355874)
    assert read["forward_host_ms.train"] == pytest.approx(8.0)
    assert read["loss_host_ms.train"] == pytest.approx(10.0)
    assert read["backward_host_ms.train"] == pytest.approx(15.0)
    assert read["optimizer_host_ms.train"] == pytest.approx(4.0)


SERVE = [
    _s("serve.predict", 0, 90),
    _s("serve.transform", 0, 20, 0),
    _s("serve.transform", 20, 44, 0),
    _s("serve.assemble", 44, 50, 0),
    _s("serve.h2d", 50, 54, 0),
    _s("serve.forward", 54, 80, 0),
    _s("serve.readback", 80, 90, 0),
]


def test_serve_readers():
    rec = _record(SERVE, 100, {"serve.h2d_bytes": 2 * 12_902_400 + 64, "serve.images": 2})
    assert harness.reader("transform_ms_per_image.serve_offline")(rec) == pytest.approx(22.0)
    assert harness.reader("batch_prep_ms.serve_offline")(rec) == pytest.approx(10.0)
    assert harness.reader("h2d_mb_per_image.serve_offline")(rec) == pytest.approx(12.902432)


NEW = ("data_wait_share.train", "loader_busy_workers.train", "h2d_mb_per_image.train",
       "forward_host_ms.train", "loss_host_ms.train", "backward_host_ms.train",
       "optimizer_host_ms.train", "transform_ms_per_image.serve_offline",
       "batch_prep_ms.serve_offline", "h2d_mb_per_image.serve_offline")


@pytest.mark.parametrize("name", NEW)
def test_reader_is_none_without_spans(name, monkeypatch):
    """Spans drained empty, a program that keeps none, and a record from a
    run with no trace: nothing to read."""
    from detr_tpu_torch.utils import profiling

    assert harness.reader(name)({"trace": {"window_s": 1.0}, "spans": [], "counters": {}}) is None
    monkeypatch.delattr(profiling, "take_spans")
    assert harness.reader(name)({"trace": {"window_s": 1.0}}) is None


def test_program_drains_the_buffer_once():
    from detr_tpu_torch.utils import profiling

    profiling.take_spans()
    with torch.profiler.profile():
        with profiling.span("data.wait"):
            profiling.count("data.images", 3)
    rec = {"trace": {"window_s": 1.0}}
    got = spans.program(rec)
    assert [s[0] for s in got] == ["data.wait"]
    assert rec["counters"]["data.images"] >= 3
    assert spans.program(rec) is got and profiling.take_spans() == []


def test_from_profile_reads_the_harness_window():
    from benchmark import trace as trace_mod
    from detr_tpu_torch.utils import profiling

    with torch.profiler.profile() as prof:
        with torch.profiler.record_function(trace_mod.WINDOW):
            with profiling.span("serve.predict"):
                torch.ones(8).sum()
    (span,) = profiling.take_spans()
    (w0, w1), busy = spans.from_profile(prof)
    assert busy == []  # a CPU profile holds no device work
    assert w0 <= span[1] + 5 * MS and span[2] <= w1 + 5 * MS
