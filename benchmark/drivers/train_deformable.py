"""Deformable DETR training cells: the port's train step on
``DeformableDETRConfig`` at the configuration's micro-batch and
accumulation, fed as the traffic says, and checked against the plain
reference (``reference.deformable``, ``reference.focal``) over its first
optimizer steps.

It runs as ``drivers.train`` runs DETR's cells and reuses its feed
(``make_feed``), its checked steps (``checked_steps``) and its comparison
(``compare``, with the typical leaf's gaps beside the worst leaf's): set-up makes the weights from the seed
(``reference.deformable_weights``), builds the model through the port's
factory (``models.build_detector``), ``AccumulatingAdamW`` (its third
group, the sampling offsets and reference points at ``lr *
lr_linear_proj_mult``), the focal criterion and ``make_train_step``'s
step; the first ``checked_steps`` updates are the warm-up.  The window and
the record are ``drivers.train``'s, with this model's FLOP count
(``flops_deformable.forward_flops``).  A traced run also records every
MSDA call's shapes (the model's ``ms_deform_attn``, wrapped) and, from the
profile, the device time of the kernels launched under the program's
``msda`` span or autograd's ``MSDeformAttnBackward`` node: the readers
``msda_roofline.train`` and ``msda_share.train`` take ``msda_bound_s``,
``msda_device_s`` and the trace's busy time.

The reference takes its own exact assignment (scipy) under its fp32
costs, as ``drivers.train``'s does, so the comparison holds the program's
matcher too.  With 300 queries, near-ties in the matching cost that bf16
and fp32 break apart move a few leaves (the reference points' bias, the
sum of every matched box's centre gradient) by up to ~10 % in a sound run,
as far as a lower precision moves them; ``compare`` therefore adds the
median leaf's gaps, which a near-tie leaves where they are and a lower
precision, moving every leaf, does not.

A program without Deformable DETR (older than it) fails at once: the
import of the model's module raises before anything is built.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import shutil
import tempfile
import time
from statistics import median

import torch

from benchmark import flops, flops_deformable, instrument
from benchmark import trace as trace_mod
from benchmark.drivers import train as base
from benchmark.reference import deformable as rd
from benchmark.reference import deformable_weights
from benchmark.reference import focal as rf
from benchmark.reference import images as ri
from benchmark.reference import model as rm

MSDA_SPAN = "detr.msda"
MSDA_BACKWARD_NODE = "MSDeformAttnBackward"


def configs(run):
    """(DeformableDETRConfig, TrainingConfig) of the cell."""
    from detr_tpu_torch.config import DeformableDETRConfig, TrainingConfig

    tr = run.traffic
    model = run.config["model"]
    keys = {f.name for f in dataclasses.fields(DeformableDETRConfig)}
    detr = DeformableDETRConfig(**{k: v for k, v in model.items() if k in keys})
    train = {k: v for k, v in run.config["train"].items()
             if k in {f.name for f in dataclasses.fields(TrainingConfig)}}
    tc = TrainingConfig(
        **train,
        train_batch_size=tr["micro_batch"],
        cumulative_train_batch_size=tr["micro_batch"] * tr["accumulation"],
        num_workers=tr.get("num_workers", 0),
        prefetch_depth=tr["prefetch_depth"],
        photometric_distort=tr.get("photometric_distort", True),
        max_gt_boxes=tr["max_gt"],
        seed=run.seed,
    )
    return detr, tc


class Program(base.Program):
    """The port's training objects for Deformable DETR, built as the trainer
    builds them (``models.build_detector``)."""

    def __init__(self, detr, tc, sd: dict, seed: int, device):
        from detr_tpu_torch.models import build_detector
        from detr_tpu_torch.train.optimizer import AccumulatingAdamW
        from detr_tpu_torch.train.train_step import TrainState, build_criterion, make_train_step

        with torch.device(device):
            model = build_detector(detr)
        model.load_state_dict(sd, strict=True)
        self.model = model
        self.optimizer = AccumulatingAdamW(model, tc, {"backbone": tc.lr_backbone, "rest": tc.lr})
        self.state = TrainState(model, self.optimizer, torch.Generator().manual_seed(seed))
        self.step = make_train_step(model, build_criterion(tc, detr))


class MSDACalls:
    """Wraps the model's MSDA entry in traced runs; ``calls`` holds (B, Lq,
    S, H, D, L, P, dtype) of each call while ``recording``."""

    def __init__(self):
        self.calls: list[tuple] = []
        self.recording = False
        self._undo = None

    def install(self) -> None:
        from detr_tpu_torch.models import deformable_detr

        inner = deformable_detr.ms_deform_attn

        def traced(value, spatial_shapes, loc, weights):
            if self.recording:
                B, S, H, D = value.shape
                _, Lq, _, L, P, _ = loc.shape
                self.calls.append((B, Lq, S, H, D, L, P, str(value.dtype).replace("torch.", "")))
            return inner(value, spatial_shapes, loc, weights)

        deformable_detr.ms_deform_attn = traced
        self._undo = lambda: setattr(deformable_detr, "ms_deform_attn", inner)

    def remove(self) -> None:
        if self._undo is not None:
            self._undo()
            self._undo = None

    def bound_s(self) -> float:
        """The recorded calls' least time, forward and backward."""
        total = 0.0
        for b, lq, s, h, d, levels, points, dtype in self.calls:
            total += sum(flops_deformable.msda_bounds(b, lq, s, h, d, levels, points, dtype))
        return total


def msda_device(prof) -> tuple[float, int]:
    """(device seconds, count) of the kernels in the profile's traced window
    launched from inside a ``detr.msda`` range or an ``MSDeformAttnBackward``
    node, with ``benchmark.trace``'s reading of events."""
    t = trace_mod
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if t._host(e)]
    windows = [e for e in host if e.name() == t.WINDOW]
    if len(windows) != 1:
        return 0.0, 0
    w0 = t._start(windows[0])
    w1 = w0 + t._dur(windows[0])
    launches = {e.correlation_id(): (t._start(e), t._tid(e)) for e in host
                if e.name().startswith(t._LAUNCH)}
    ranges = [(t._start(e), t._start(e) + t._dur(e), t._tid(e)) for e in host
              if e.name() == MSDA_SPAN or MSDA_BACKWARD_NODE in e.name()]
    total, n = 0, 0
    for e in events:
        if t._kind(e) != "kernel" or not w0 <= t._start(e) < w1:
            continue
        for cid in (e.correlation_id(), getattr(e, "linked_correlation_id", lambda: -1)()):
            if cid in launches:
                at, tid = launches[cid]
                if any(a <= at < b and tid == rt for a, b, rt in ranges):
                    total += t._dur(e)
                    n += 1
                break
    return total / 1e9, n


def run(run, device) -> None:
    detr, tc = configs(run)
    tr, cfg = run.traffic, run.config["model"]
    k = tr["accumulation"]
    B = tr["micro_batch"]
    sd = deformable_weights.make(cfg, run.seed, device)
    sd_cpu = {n: t.to("cpu", copy=True) for n, t in sd.items()}
    tmp = tempfile.mkdtemp(prefix="bench_train_deformable_")
    calls = MSDACalls()
    feed = prog = None
    try:
        prog = Program(detr, tc, sd, run.seed, device)
        if run.trace:
            calls.install()
        del sd
        feed, _ = base.make_feed(run, detr, tc, device, tmp)
        run.log("program and feed built")
        readings, batches, _ = base.checked_steps(prog, feed, tr["checked_steps"], k, sd_cpu)
        instrument.sync(device)
        window(run, prog, feed, cfg, B, device, calls)
    finally:
        calls.remove()
        if feed is not None:
            feed.close()
        shutil.rmtree(tmp, ignore_errors=True)
    del prog, feed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.log("window done, reference starts")
    ref = follow(sd_cpu, cfg, run.config["train"], batches, run.seed, device, tr)
    run.log("reference done")
    for name, value in compare(readings, ref, k).items():
        if name in run.limits:  # a number with no limit is not compared (PERF.md)
            run.check(name, value, run.limits[name]["limit"])


def compare(prog: dict, ref: dict, k: int) -> dict:
    """``drivers.train.compare``'s three numbers (the worst leaf's), and
    ``grad_gap_median`` and ``change_gap_median``: the median over the
    same leaves of the same per-leaf gaps."""
    gr, gp = ref["grad_norms"], prog["grad_norms"]
    g_med = median(gr.values())
    moved = [n for n in gr if gr[n] >= base.STILL_LEAF * g_med]
    cr, cp = ref["change_norms"], prog["change_norms"]
    c_med = median(cr[n] for n in moved)
    return {**base.compare(prog, ref, k),
            "grad_gap_median": median(abs(gp[n] - gr[n]) / max(gr[n], g_med) for n in gr),
            "change_gap_median": median(abs(cp[n] - cr[n]) / max(cr[n], c_med)
                                        for n in moved)}


def window(run, prog, feed, cfg: dict, B: int, device, calls: MSDACalls) -> None:
    """The measured window (and, traced, the profiled micro-steps after it),
    as ``drivers.train.window``."""
    step_flops: dict = {}

    def micro_step_flops(batch) -> int:
        shape = tuple(batch["image"].shape[1:3])
        if shape not in step_flops:
            step_flops[shape] = 3 * B * flops_deformable.forward_flops(cfg, *shape)
        return step_flops[shape]

    def loop(deadline: float, count, traced: bool):
        n = done = 0
        wait = 0.0
        pending = None
        t0 = time.perf_counter()
        while True:
            tw = time.perf_counter()
            with instrument.span("input_wait", traced):
                batch = next(feed)
            wait += time.perf_counter() - tw
            with instrument.span("step", traced):
                loss = prog(batch)["loss"]
            done += micro_step_flops(batch)
            if pending is not None:
                with instrument.span("loss_read", traced):
                    if not math.isfinite(float(pending)):
                        run.failed += 1
            pending = loss
            n += 1
            if (count is None and time.perf_counter() >= deadline) or n == count:
                break
        with instrument.span("loss_read", traced):
            if not math.isfinite(float(pending)):
                run.failed += 1
        instrument.sync(device)
        return n, time.perf_counter() - t0, wait, done

    instrument.reset_peak(device)
    run.setup_done()
    t0 = time.perf_counter()
    n, elapsed, wait, done = loop(t0 + run.seconds, None, False)
    peak = instrument.peak_bytes(device)
    run.attempted = n
    run.metrics["train_images_per_s"] = (n * B / elapsed, "images/s")
    run.metrics["peak_mem_gib"] = (peak / 2**30, "GiB")
    traced = None
    if run.trace:
        calls.recording = True
        with instrument.profiler(device) as prof:
            with torch.profiler.record_function(trace_mod.WINDOW):
                m, _, _, _ = loop(0.0, run.traffic["trace_micro_steps"], True)
        calls.recording = False
        traced = trace_mod.reduce_profile(prof)
        msda_s, msda_kernels = msda_device(prof)
        run.record = {
            "kind": "train", "micro_steps": n, "window_s": elapsed, "input_wait_s": wait,
            "flops": done, "peak_flops": flops.PEAK_FLOPS[cfg["dtype"]],
            "profiled_micro_steps": m, "trace": traced,
            "msda_bound_s": calls.bound_s(), "msda_calls": len(calls.calls),
            "msda_device_s": msda_s, "msda_kernels": msda_kernels,
        }
        run.breakdown = instrument.breakdown(traced)
    run.device = instrument.device_info(device, peak, traced)


def follow(sd_cpu: dict, cfg: dict, train: dict, batches: list, seed: int, device,
           traffic: dict, P: rm.Precision = rm.FP32, fault: str | None = None) -> dict:
    """The reference through the checked micro-steps -> the readings
    ``checked_steps`` gives.  ``P`` and ``fault`` put a lower precision or a
    planted fault in the program's place (the controls)."""
    undo = rm.no_tf32()
    try:
        return _follow(sd_cpu, cfg, train, batches, seed, device, traffic, P, fault)
    finally:
        undo()


def _follow(sd_cpu, cfg, train, batches, seed, device, traffic, P, fault):
    frozen = {n.rsplit(".", 1)[0] for n in sd_cpu if n.endswith(".running_mean")}
    sd = {n: t.to(device, copy=True) for n, t in sd_cpu.items()}
    names = [n for n in sd if n.rsplit(".", 1)[0] not in frozen]
    for n in names:
        sd[n].requires_grad_(True)
    opt = rd.AdamW({n: sd[n] for n in names}, train["lr"], train["lr_backbone"],
                   train["weight_decay"], train["gradient_max_norm"], traffic["accumulation"],
                   cfg["lr_linear_proj_mult"])
    costs = {"class": train["set_cost_class"], "bbox": train["set_cost_bbox"],
             "giou": train["set_cost_giou"]}
    coefs = {"ce": train["label_ce_loss_coef"], "bbox": train["bbox_loss_coef"],
             "giou": train["giou_loss_coef"]}
    alpha = cfg["focal_alpha"]
    gen = torch.Generator().manual_seed(seed)
    rows = traffic["reference_rows"]
    losses, grad_norms = [], None
    for batch in batches:
        b = {key: v.to(device) for key, v in batch.items()}
        if fault == "half_batch":
            half = b["image"].shape[0] // 2
            b = {key: v[:half] for key, v in b.items()}
        seeds = rm.Seeds.draw(gen, rd.seeds_per_forward(cfg))
        image = ri.normalize(b["image"], b["height"], b["width"])
        gt = (b["class_idx"], b["boxes_normalized"], b["gt_valid"] & b["image_valid"][:, None])
        num_boxes = gt[2].float().sum()
        grads = {n: torch.zeros_like(sd[n]) for n in names}
        total = 0.0
        for lo, hi in base._blocks(image.shape[0], rows):
            out = rd.forward(sd, cfg, image[lo:hi], b["height"][lo:hi], b["width"][lo:hi], P,
                             seeds, lo)
            block_gt = [g[lo:hi] for g in gt]
            matches = rf.assign(out["pred_logits"], out["pred_boxes"], *block_gt, costs, alpha)
            s = rf.sums(out["pred_logits"], out["pred_boxes"], *block_gt, matches, alpha)
            loss = rf.loss(s, num_boxes, coefs)
            got = torch.autograd.grad(loss, [sd[n] for n in names], allow_unused=True)
            for n, g in zip(names, got):
                if g is not None:
                    grads[n] += g
            total += float(loss.detach())
            del out, s, loss, got
        losses.append(total)
        applied = opt.micro_step(grads)
        if applied is not None and grad_norms is None:
            grad_norms = dict(zip(names, base._leaf_norms([applied[n] for n in names])))
    change = {n: float(torch.linalg.vector_norm((sd[n].detach() - sd_cpu[n].to(device)).double()))
              for n in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
