"""Serving cells: ``InferenceEngine.predict`` on uint8 images, under an
open loop of arrivals (``arrivals: "poisson"``) or a backlog that never
empties (``"backlog"``), checked against the plain reference.

The server process runs ``host_threads`` host threads (OpenMP and torch):
on a host shared with other work, an OpenMP team as wide as the machine
waits on its slowest thread, which spread the served rates over 19 % and
the tail over 35 % from run to run.

Set-up makes the weights from the seed and loads them into the engine,
makes the pool of images, and warms every shape the cell uses (the engine's
``warmup`` over its buckets at its batch, and one ``predict`` of pool
images of each orientation, which also loads the host C++ transforms).

Poisson: the arrival times are the quantiles of the exponential law at the
cell's rate, in an order drawn from the seed (every seed offers the same
set of gaps), over ``--seconds``; each request is one pool image.  One
server thread hands ``predict`` every request that has arrived, up to the
engine's batch, and sleeps until the next arrival when none has.  A
request's latency runs from when it was due to when ``predict`` returned it;
``serve_p95_ms`` is the 95th percentile over every request due in the
window, each served however late.

Backlog: each call gets ``batch_size`` images of one orientation, the
orientations in turn, until ``--seconds`` have passed; ``serve_images_per_s``
is the images returned over the time until the last call returned.

A traced run profiles ``trace_seconds`` more of arrivals, or
``trace_calls`` more calls.  After the window a sample of the served
requests, drawn from the seed, is run through the plain reference.
"""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np
import torch

from benchmark import data, flops, harness, instrument
from benchmark import trace as trace_mod
from benchmark.reference import images as ri
from benchmark.reference import model as rm
from benchmark.reference import weights


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of a Poisson stream: the
    exponential gaps' quantiles at (i + 0.5) / n, n = rate * seconds, in an
    order drawn from the seed."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    order = np.random.default_rng(seed).permutation(n)
    return np.cumsum(gaps[order])


def buckets(traffic: dict) -> tuple:
    """The engine's (H, W) canvases: landscape first, then portrait."""
    return tuple(tuple(b) for b in traffic["buckets"])


class Served:
    """The engine, its forwards counted; with ``traced`` set, its forward
    and its per-image transform run in ``bench.*`` spans."""

    def __init__(self, cfg: dict, sd: dict, traffic: dict, device):
        from detr_tpu_torch.config import DETRConfig
        from detr_tpu_torch.serve.engine import InferenceEngine

        self.engine = InferenceEngine(
            DETRConfig(**cfg), batch_size=traffic["batch_size"], buckets=buckets(traffic),
            min_size=traffic["min_size"], max_size=traffic["max_size"], device=str(device))
        self.engine.model.load_state_dict(sd, strict=True)
        self.forwards = 0
        self.traced = False
        forward, transform = self.engine._predict, self.engine.transform

        def counted(*args):
            self.forwards += 1
            with instrument.span("engine_forward", self.traced):
                return forward(*args)

        def transformed(*args):
            with instrument.span("engine_transform", self.traced):
                return transform(*args)

        self.engine._predict = counted
        self.engine.transform = transformed

    def predict(self, images: list) -> list:
        return self.engine.predict(images)


def run(run, device) -> None:
    tr, cfg = run.traffic, run.config["model"]
    # The server's host threads: its C++ transforms' OpenMP team (read when
    # the library loads, at the first transform) and torch's own.
    os.environ["OMP_NUM_THREADS"] = str(tr["host_threads"])
    torch.set_num_threads(tr["host_threads"])
    sd = weights.make(cfg, run.seed, device)
    sd_cpu = {n: t.to("cpu", copy=True) for n, t in sd.items()}
    calls = instrument.AttentionCalls()
    if run.trace:
        calls.install()
    try:
        served = Served(cfg, sd, tr, device)
        del sd
        pool = data.serve_pool(tr, run.seed, device)
        served.engine.warmup()
        orient = [0 if img.shape[0] <= img.shape[1] else 1 for img in pool]
        for o in (0, 1):
            served.predict([img for img, x in zip(pool, orient) if x == o][:tr["batch_size"]])
        instrument.sync(device)
        if tr["arrivals"] == "poisson":
            answers = poisson(run, served, pool, device, calls)
        elif tr["arrivals"] == "backlog":
            answers = backlog(run, served, pool, orient, device, calls)
        else:
            raise ValueError(f"unknown arrivals {tr['arrivals']!r}")
    finally:
        calls.remove()
    del served
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(run.seed)
    sample = rng.choice(len(answers), size=min(tr["checked_requests"], len(answers)),
                        replace=False)
    checked = [answers[i] for i in sample]
    run.log("window done, reference starts")
    refs = reference(sd_cpu, cfg, tr, [pool[idx] for idx, _ in checked], device)
    run.log("reference done")
    for name, value in compare([det for _, det in checked], refs,
                               [pool[idx].shape[:2] for idx, _ in checked]).items():
        if name in run.limits:  # a number with no limit is not compared (PERF.md)
            run.check(name, value, run.limits[name]["limit"])


def _finish(run, device, peak, traced, record):
    run.device = instrument.device_info(device, peak, traced)
    run.record = dict(record, trace=traced)
    if run.trace:
        run.breakdown = instrument.breakdown(traced)


def poisson(run, served: Served, pool, device, calls) -> list:
    tr = run.traffic
    B = tr["batch_size"]
    due = schedule(tr["rate_per_s"], run.seconds, run.seed)
    picks = np.random.default_rng(run.seed + 1).permutation(len(due)) % len(pool)

    def serve(due, picks, traced):
        latency, wait, answers = [], [], []
        forwards0 = served.forwards
        nxt = 0
        t0 = time.perf_counter()
        while nxt < len(due):
            now = time.perf_counter() - t0
            if due[nxt] > now:
                with instrument.span("idle_wait", traced):
                    time.sleep(due[nxt] - now)
                continue
            end = nxt
            while end < len(due) and end - nxt < B and due[end] <= now:
                end += 1
            start = time.perf_counter() - t0
            with instrument.span("predict", traced):
                out = served.predict([pool[i] for i in picks[nxt:end]])
            done = time.perf_counter() - t0
            for j in range(nxt, end):
                latency.append(done - due[j])
                wait.append(start - due[j])
                answers.append((int(picks[j]), out[j - nxt]))
            nxt = end
        return latency, wait, answers, served.forwards - forwards0, time.perf_counter() - t0

    instrument.reset_peak(device)
    run.setup_done()
    latency, wait, answers, forwards, elapsed = serve(due, picks, False)
    peak = instrument.peak_bytes(device)
    run.attempted = len(due)
    run.failed = len(due) - len(answers)
    run.metrics["serve_p95_ms"] = (harness.quantile(latency, 0.95) * 1e3, "ms")
    run.metrics["peak_mem_gib"] = (peak / 2**30, "GiB")
    traced = None
    if run.trace:
        more = schedule(tr["rate_per_s"], tr["trace_seconds"], run.seed + 2)
        served.traced = True
        with instrument.profiler(device) as prof:
            with torch.profiler.record_function(trace_mod.WINDOW):
                serve(more, np.arange(len(more)) % len(pool), True)
        traced = trace_mod.reduce_profile(prof)
    _finish(run, device, peak, traced, {
        "kind": "serve", "requests": len(latency), "window_s": elapsed,
        "latency_s": latency, "queue_waits_s": wait, "forwards": forwards, "batch_size": B,
    })
    return answers


def backlog(run, served: Served, pool, orient, device, calls) -> list:
    tr = run.traffic
    B = tr["batch_size"]
    cfg = run.config["model"]
    by_orient = [[i for i, o in enumerate(orient) if o == x] for x in (0, 1)]
    cursor = [0, 0]

    def next_call(c: int) -> list[int]:
        group = by_orient[c % 2]
        picks = [group[(cursor[c % 2] + j) % len(group)] for j in range(B)]
        cursor[c % 2] += B
        return picks

    def serve(deadline, count, traced):
        answers, c, work = [], 0, 0
        t0 = time.perf_counter()
        while True:
            picks = next_call(c)
            with instrument.span("predict", traced):
                out = served.predict([pool[i] for i in picks])
            bucket = buckets(tr)[c % 2]
            work += B * flops.forward_flops(cfg, *bucket)
            answers += list(zip(picks, out))
            c += 1
            if (count is None and time.perf_counter() >= deadline) or c == count:
                break
        return answers, time.perf_counter() - t0, work

    instrument.reset_peak(device)
    run.setup_done()
    t0 = time.perf_counter()
    answers, elapsed, work = serve(t0 + run.seconds, None, False)
    peak = instrument.peak_bytes(device)
    run.attempted = len(answers)
    run.metrics["serve_images_per_s"] = (len(answers) / elapsed, "images/s")
    run.metrics["peak_mem_gib"] = (peak / 2**30, "GiB")
    traced, bound = None, 0.0
    if run.trace:
        calls.recording = served.traced = True
        with instrument.profiler(device) as prof:
            with torch.profiler.record_function(trace_mod.WINDOW):
                serve(0.0, tr["trace_calls"], True)
        calls.recording = False
        traced = trace_mod.reduce_profile(prof)
        for b, lq, s, h, d, masked, dtype in calls.calls:
            bound += flops.attention_bounds(b, lq, s, masked, h, d, dtype)[0]
    _finish(run, device, peak, traced, {
        "kind": "serve", "images": len(answers), "window_s": elapsed, "flops": work,
        "peak_flops": flops.PEAK_FLOPS[cfg["dtype"]], "attention_bound_s": bound,
        "attention_calls": len(calls.calls),
    })
    return answers


def reference(sd_cpu: dict, cfg: dict, traffic: dict, imgs: list, device,
              P: rm.Precision = rm.FP32) -> list:
    """The reference's detections of each image, one at a time."""
    undo = rm.no_tf32()
    try:
        sd = {n: t.to(device, copy=True) for n, t in sd_cpu.items()}
        out = []
        with torch.no_grad():
            for img in imgs:
                x, th, tw = ri.serve_input(img, device, traffic["min_size"],
                                           traffic["max_size"], buckets(traffic))
                h = torch.tensor([th], device=device)
                w = torch.tensor([tw], device=device)
                o = rm.forward(sd, cfg, x, h, w, P)
                out.append(ri.detections(o["pred_logits"][0, -1], o["pred_boxes"][0, -1],
                                         img.shape[0], img.shape[1]))
        return out
    finally:
        undo()


def compare(served: list, refs: list, sizes: list) -> dict:
    """The numbers compared, worst over the sampled requests and their
    queries: how far the served score lies from the reference's
    probability of the served label, in log space (``score_gap``; a served
    label that is not the reference's best reads its whole log ratio to the
    best, since the served score is the program's best), and how far the
    served box lies from the reference's, over the image's longer side
    (``box_gap``)."""
    score_gap = box_gap = 0.0
    for det, ref, (h, w) in zip(served, refs, sizes):
        probs = ref["probs"].cpu()
        labels = torch.as_tensor(np.asarray(det["labels"]), dtype=torch.long)
        scores = torch.as_tensor(np.asarray(det["scores"]), dtype=torch.float64)
        boxes = torch.as_tensor(np.asarray(det["boxes"]), dtype=torch.float64)
        if len(labels) != len(probs):
            return {"score_gap": math.inf, "box_gap": math.inf}
        mine = probs.gather(1, labels[:, None])[:, 0]
        score_gap = max(score_gap, float((scores.log() - mine.log()).abs().max()))
        box_gap = max(box_gap, float((boxes - ref["boxes"].cpu()).abs().max()) / max(h, w))
    return {"score_gap": score_gap, "box_gap": box_gap}
