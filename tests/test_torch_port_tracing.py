"""The port's spans and counters (``detr_tpu_torch.utils.profiling``): the off
path, the buffer under a profiler with its parents, the clock against the
profiler's, the prefetch thread's and the loader workers' spans, every span
of the serving engine and the train step, the byte counters, overflow, and
``trace``'s ``spans.json``.  CPU only."""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.data import BucketedLoader, CocoDataset, get_train_transforms, synthetic_batch
from detr_tpu_torch.data.make_synthetic_coco import generate_split
from detr_tpu_torch.data.prefetch import DevicePlacement, prefetch_to_device
from detr_tpu_torch.models import DETR
from detr_tpu_torch.serve import InferenceEngine
from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, make_train_step
from detr_tpu_torch.utils import profiling
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

TINY = DETRConfig(num_object_queries=8, num_encoder_layers=1, num_decoder_layers=2,
                  num_attention_heads=2, hidden_size=16, ffn_scale_factor=2, num_classes=3,
                  dtype="float32")
BUCKETS = ((256, 384), (384, 256), (320, 320))
SERVE = ("serve.predict", "serve.transform", "serve.assemble", "serve.h2d", "serve.forward",
         "serve.readback", "model.backbone", "model.transformer", "attention")
TRAIN = ("train.step", "train.prepare", "train.forward", "train.loss", "train.match",
         "train.backward", "train.optimizer", "model.backbone", "model.transformer",
         "attention")


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.take_spans()
    yield
    profiling.take_spans()


def _names(spans) -> set:
    return {s[0] for s in spans}


def _parent_name(spans, s) -> str | None:
    return spans[s[5]][0] if s[5] >= 0 else None


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    generate_split(root, "train", 8, num_classes=3, seed=0)
    return root


def _loader(root, num_workers, mode="process"):
    ds = CocoDataset(root, "train", get_train_transforms(seed=0, normalize=False))
    return BucketedLoader(ds, 2, buckets=BUCKETS, max_gt=10, num_workers=num_workers, seed=0,
                          image_dtype="uint8", worker_mode=mode)


def test_off_path_is_a_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("x"), profiling.span("y")
    assert a is b is profiling._NULL
    with profiling.span("x"):
        with profiling.span("y"):
            pass
    profiling.add_spans([("data.load", 1, 2, 3, 4, -1)])
    assert profiling.take_spans() == []


def test_spans_buffered_with_parents_and_as_profiler_ranges():
    with torch.profiler.profile() as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
            with profiling.span("second"):
                pass
    spans = profiling.take_spans()
    assert [s[0] for s in spans] == ["outer", "inner", "second"]
    outer, inner, second = spans
    assert outer[5] == -1 and inner[5] == 0 and second[5] == 0
    assert outer[1] <= inner[1] <= inner[2] <= second[1] <= second[2] <= outer[2]
    assert all(s[3] == os.getpid() and s[4] == threading.get_native_id() for s in spans)
    ranges = [e.name() for e in prof.profiler.kineto_results.events()]
    assert {"detr.outer", "detr.inner", "detr.second"} <= set(ranges)
    assert profiling.take_spans() == []


def test_spans_keep_the_interpreter_lock():
    """With another Python thread busy, a span that released the lock on
    entry and exit would wait out the 5 ms switch interval each time."""
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            pass

    busy = threading.Thread(target=spin, daemon=True)
    busy.start()
    try:
        with torch.profiler.profile():
            t0 = time.perf_counter()
            for _ in range(100):
                with profiling.span("x"):
                    pass
            took = time.perf_counter() - t0
    finally:
        stop.set()
        busy.join()
    assert len(profiling.take_spans()) == 100
    assert took < 0.1, took


def test_span_clock_is_the_profilers():
    t_before = time.time_ns()
    with torch.profiler.profile() as prof:
        with profiling.span("clock"):
            time.sleep(0.01)
    (buffered,) = profiling.take_spans()
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "detr.clock"]
    assert abs(event.start_ns() - buffered[1]) < 5_000_000
    assert buffered[1] >= t_before and buffered[2] - buffered[1] >= 10_000_000


def _epochs(loader):
    while True:
        yield from loader


def test_prefetch_thread_spans_and_byte_counters(coco_root):
    """The prefetch thread starts before the profiler, which does not follow
    it: its spans reach the buffer all the same."""
    loader = _loader(coco_root, 0)
    placement = DevicePlacement("cpu")
    sent = []
    inner = placement.place

    def place(batch):
        sent.append(sum(np.ascontiguousarray(v).nbytes for v in batch.values()))
        return inner(batch)

    before = profiling.counters()
    feed = prefetch_to_device(_epochs(loader), place, 1, placement.take)
    next(feed)
    with torch.profiler.profile():
        got = [next(feed) for _ in range(3)]  # the third is made inside the profile
    feed.close()
    after = profiling.counters()
    spans = profiling.take_spans()
    assert all(b["image"].shape[0] == 2 for b in got)
    main = threading.get_native_id()
    assert {"data.place", "data.assemble", "data.load"} <= _names(spans)
    assert all(s[4] != main for s in spans if s[0] in ("data.place", "data.assemble"))
    assert [s[4] for s in spans if s[0] == "data.wait"] == [main] * 3
    # num_workers=0: items load on the prefetch thread, in this process
    assert all(s[3] == os.getpid() for s in spans)
    assert after["data.h2d_bytes"] - before.get("data.h2d_bytes", 0) == sum(sent)
    assert after["data.images"] - before.get("data.images", 0) == 2 * len(sent)
    assert after["data.batches"] - before.get("data.batches", 0) == len(sent)


@pytest.mark.parametrize("mode", ["process", "thread"])
def test_loader_worker_spans(coco_root, mode):
    loader = _loader(coco_root, 2, mode)
    try:
        with torch.profiler.profile():
            t0 = time.time_ns()
            batch = next(iter(loader))
            t1 = time.time_ns()
    finally:
        loader.close()
    assert batch["image"].shape[0] == 2
    spans = profiling.take_spans()
    loads = [i for i, s in enumerate(spans) if s[0] == "data.load"]
    assert len(loads) >= 2
    workers = {(spans[i][3], spans[i][4]) for i in loads}
    if mode == "process":
        assert all(pid != os.getpid() for pid, _ in workers)
    assert threading.get_native_id() not in {tid for _, tid in workers}
    for i in loads:
        load = spans[i]
        assert t0 <= load[1] <= load[2] <= t1
        kids = [s for s in spans if s[5] == i]
        assert [k[0] for k in kids] == ["data.decode", "data.augment", "data.fit"]
        assert kids[0][1] == load[1] and kids[-1][2] == load[2]
        assert all(k[3:5] == load[3:5] for k in kids)


def test_unsplit_dataset_item_spans():
    """A dataset with only ``__getitem__``: the item's load and its bucket
    fit, no decode or augment."""
    from detr_tpu_torch.data import loader as loader_mod

    class Plain:
        def __getitem__(self, i):
            time.sleep(0.002)
            return np.zeros((200, 300, 3), np.uint8), {
                "boxes": np.zeros((0, 4), np.float32), "class_idx": np.zeros((0,), np.int64)}

    with torch.profiler.profile():
        _, _, stamps = loader_mod._load_fitted(Plain(), 0, BUCKETS)
        loader_mod._item_spans(stamps)
    load, fit = profiling.take_spans()
    assert (load[0], fit[0], fit[5]) == ("data.load", "data.fit", 0)
    assert load[1] + 2_000_000 <= fit[1] <= fit[2] == load[2]


def test_engine_emits_every_serving_span_and_counts_its_bytes():
    engine = InferenceEngine(TINY, batch_size=2, buckets=((64, 96), (96, 64)), min_size=64,
                             max_size=96, device="cpu")
    rng = np.random.default_rng(0)
    images = [(rng.random((64, 96, 3)) * 255).astype(np.uint8) for _ in range(3)]
    sent = []
    inner = engine._predict

    def predict(*arrays):
        sent.append(sum(a.nbytes for a in arrays))
        return inner(*arrays)

    engine._predict = predict
    before, traced_before = profiling.counters(), profiling.counters(traced=True)
    with torch.profiler.profile():
        out = engine.predict(images)
    after, traced = profiling.counters(), profiling.counters(traced=True)
    spans = profiling.take_spans()
    assert len(out) == 3
    assert set(SERVE) <= _names(spans)
    by = {n: [s for s in spans if s[0] == n] for n in SERVE}
    assert len(by["serve.predict"]) == 1 and len(by["serve.transform"]) == 3
    assert len(by["serve.assemble"]) == len(by["serve.forward"]) == len(sent) == 2
    for name in ("serve.transform", "serve.assemble"):
        assert {_parent_name(spans, s) for s in by[name]} == {"serve.predict"}
    assert {_parent_name(spans, s) for s in by["model.backbone"]} == {"serve.forward"}
    delta = {k: after[k] - before.get(k, 0) for k in after}
    assert delta["serve.h2d_bytes"] == sum(sent)
    assert delta["serve.images"] == 3 and delta["serve.padded_rows"] == 1
    assert delta["serve.batches"] == 2
    assert traced["serve.h2d_bytes"] - traced_before.get("serve.h2d_bytes", 0) == sum(sent)


def test_train_step_emits_every_span():
    cfg = TrainingConfig(cumulative_train_batch_size=4, train_batch_size=2)
    model = DETR(TINY)
    model.reset_parameters(torch.Generator().manual_seed(0))
    optimizer, _ = build_optimizer(model, cfg)
    state = TrainState(model, optimizer, torch.Generator().manual_seed(0))
    step = make_train_step(model, build_criterion(cfg, TINY))
    batch = DevicePlacement("cpu")(synthetic_batch(np.random.default_rng(0), 2, 64, 64,
                                                   max_gt=5, num_classes=3))
    with torch.profiler.profile():
        state, metrics = step(state, batch)
    spans = profiling.take_spans()
    assert torch.isfinite(metrics["loss"])
    assert set(TRAIN) <= _names(spans)
    (top,) = [i for i, s in enumerate(spans) if s[0] == "train.step"]
    kids = [s for s in spans if s[5] == top]
    assert [k[0] for k in kids] == ["train.prepare", "train.forward", "train.loss",
                                    "train.backward", "train.optimizer"]
    step_ns = spans[top][2] - spans[top][1]
    assert sum(k[2] - k[1] for k in kids) >= 0.9 * step_ns
    (match,) = [s for s in spans if s[0] == "train.match"]
    assert _parent_name(spans, match) == "train.loss"


def test_counters_name_the_launch_counters():
    got = profiling.counters()
    for name in ("attention.launches", "attention.launches_bwd_dkv",
                 "attention.launches_bwd_dq", "auction.launches"):
        assert isinstance(got[name], int)


def test_overflow_is_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    before = profiling.counters().get("spans.dropped", 0)
    with torch.profiler.profile():
        for _ in range(5):
            with profiling.span("x"):
                pass
        profiling.add_spans([("w", 1, 2, 3, 4, -1), ("w.kid", 1, 2, 3, 4, 0)])
    assert len(profiling.take_spans()) == 3
    assert profiling.counters()["spans.dropped"] - before == 4


def test_trace_writes_spans_beside_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
    assert (tmp_path / profiling.TRACE_FILE).stat().st_size > 0
    got = json.loads((tmp_path / profiling.SPANS_FILE).read_text())
    assert got["fields"] == list(profiling.SPAN_FIELDS)
    assert [s[0] for s in got["spans"]] == ["outer", "inner"]
    assert got["spans"][1][5] == 0
    assert "attention.launches" in got["counters"]
    assert profiling.take_spans() == []
