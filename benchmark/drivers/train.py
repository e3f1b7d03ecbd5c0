"""Training cells: the port's train step at the configuration's micro-batch
and accumulation, fed as the traffic says, and checked against the plain
reference over its first optimizer steps.

Set-up makes the weights from the seed (``reference.weights``) and loads
them into ``DETR``; builds ``AccumulatingAdamW``, the criterion and
``make_train_step``'s step; starts the feed (``coco``: JPEGs written from the
seed into a directory under ``TMPDIR``, ``CocoDataset`` with the training
augmentation, ``BucketedLoader``'s spawned workers, ``prefetch_to_device``;
``resident``: uint8 batches made on the card from the seed, cycled through
``prefetch_to_device``); then drives the step through its first
``checked_steps`` optimizer updates, recording each micro-step's loss, the
first update's gradient (from AdamW's first moment) and the parameters'
change after the last, and runs one more micro-step per bucket the loader
has not shown yet.  Those micro-steps are the warm-up.

The window runs micro-steps as the trainer's loop does (the next batch, the
step, a read of the previous step's loss) until ``--seconds`` have passed,
then waits for the card: ``train_images_per_s`` is the images of every
micro-step in the window over its length.  A traced run then profiles
``trace_micro_steps`` more.  After the window the program is freed and the
reference follows the same micro-steps from the same weights, batches and
dropout seeds in fp32, in blocks of ``reference_rows`` rows.
"""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import time
from statistics import mean, median

import torch

from benchmark import data, flops, instrument
from benchmark import trace as trace_mod
from benchmark.reference import criterion as rc
from benchmark.reference import images as ri
from benchmark.reference import model as rm
from benchmark.reference import optim as ro
from benchmark.reference import weights

BATCH_KEYS = ("image", "height", "width", "class_idx", "boxes_normalized", "gt_valid",
              "image_valid")
BETA1 = 0.9


def configs(run):
    """(DETRConfig, TrainingConfig) of the cell."""
    from detr_tpu_torch.config import DETRConfig, TrainingConfig

    tr = run.traffic
    detr = DETRConfig(**run.config["model"])
    extra = {}
    if "buckets" in tr:
        extra["shape_buckets"] = tuple(tuple(b) for b in tr["buckets"])
    tc = TrainingConfig(
        **run.config["train"],
        train_batch_size=tr["micro_batch"],
        cumulative_train_batch_size=tr["micro_batch"] * tr["accumulation"],
        num_workers=tr.get("num_workers", 0),
        prefetch_depth=tr["prefetch_depth"],
        photometric_distort=tr.get("photometric_distort", True),
        max_gt_boxes=tr["max_gt"],
        seed=run.seed,
        **extra,
    )
    return detr, tc


class Program:
    """The port's training objects, built as the trainer builds them."""

    def __init__(self, detr, tc, sd: dict, seed: int, device):
        from detr_tpu_torch.models.detr import DETR
        from detr_tpu_torch.train.optimizer import AccumulatingAdamW
        from detr_tpu_torch.train.train_step import TrainState, build_criterion, make_train_step

        with torch.device(device):
            model = DETR(detr)
        model.load_state_dict(sd, strict=True)
        self.model = model
        self.optimizer = AccumulatingAdamW(model, tc, {"backbone": tc.lr_backbone, "rest": tc.lr})
        self.state = TrainState(model, self.optimizer, torch.Generator().manual_seed(seed))
        self.step = make_train_step(model, build_criterion(tc, detr))

    def __call__(self, batch):
        self.state, metrics = self.step(self.state, batch)
        return metrics


def _epochs(loader):
    while True:
        yield from loader


def _cycle(items):
    while True:
        yield from items


def make_feed(run, detr, tc, device, tmp: str):
    """(batches on the device, the loader or None)."""
    from detr_tpu_torch.data.prefetch import DevicePlacement, prefetch_to_device

    tr = run.traffic
    if tr["feed"] == "coco":
        from detr_tpu_torch.data.coco import CocoDataset
        from detr_tpu_torch.data.loader import BucketedLoader
        from detr_tpu_torch.data.transforms import get_train_transforms

        data.write_coco(tmp, tr, run.seed, device)
        dataset = CocoDataset(tmp, "train", get_train_transforms(
            seed=run.seed, normalize=False, photometric=tc.photometric_distort))
        loader = BucketedLoader(dataset, tc.train_batch_size, buckets=tc.shape_buckets,
                                max_gt=tc.max_gt_boxes, shuffle=True, drop_last=True,
                                num_workers=tc.num_workers, seed=run.seed, image_dtype="uint8")
        placement = DevicePlacement(device, BATCH_KEYS)
        return prefetch_to_device(_epochs(loader), placement.place, tc.prefetch_depth,
                                  placement.take), loader
    if tr["feed"] == "resident":
        pool = data.resident_batches(tr, detr.num_classes, run.seed, device)
        return prefetch_to_device(_cycle(pool), None, tc.prefetch_depth), None
    raise ValueError(f"unknown feed {tr['feed']!r}")


def _leaf_norms(tensors) -> list[float]:
    return torch.stack([torch.linalg.vector_norm(t.double()) for t in tensors]).tolist()


def checked_steps(prog: Program, feed, n_updates: int, k: int, sd_cpu: dict) -> tuple:
    """The first ``n_updates`` updates' micro-steps -> (readings, batches on
    the host, canvases seen)."""
    losses, batches, seen = [], [], set()
    grad_norms = None
    opt = prog.optimizer
    for i in range(n_updates * k):
        batch = next(feed)
        batches.append({key: v.cpu() for key, v in batch.items()})
        seen.add(tuple(batch["image"].shape[1:3]))
        losses.append(prog(batch)["loss"])
        if i + 1 == k:
            # a step that never updated holds no moments: nothing reached the optimizer
            moments = [opt.adamw.state[p].get("exp_avg", torch.zeros(())) for p in opt.params]
            grad_norms = [n / (1 - BETA1) for n in _leaf_norms(moments)]
    change = [float(torch.linalg.vector_norm((p.detach().cpu() - sd_cpu[n]).double()))
              for n, p in zip(opt.names, opt.params)]
    readings = {"losses": [float(x) for x in losses],
                "grad_norms": dict(zip(opt.names, grad_norms)),
                "change_norms": dict(zip(opt.names, change))}
    return readings, batches, seen


def _bucket_batch(batch: dict, shape) -> dict:
    """``batch`` moved into another canvas (its pixels cropped or padded)."""
    H, W = shape
    img = batch["image"]
    out = torch.zeros(img.shape[0], H, W, 3, dtype=img.dtype, device=img.device)
    h, w = min(H, img.shape[1]), min(W, img.shape[2])
    out[:, :h, :w] = img[:, :h, :w]
    return dict(batch, image=out, height=batch["height"].clamp(max=H),
                width=batch["width"].clamp(max=W))


def run(run, device) -> None:
    detr, tc = configs(run)
    tr, cfg = run.traffic, run.config["model"]
    k = tr["accumulation"]
    B = tr["micro_batch"]
    sd = weights.make(cfg, run.seed, device)
    sd_cpu = {n: t.to("cpu", copy=True) for n, t in sd.items()}
    tmp = tempfile.mkdtemp(prefix="bench_train_")
    calls = instrument.AttentionCalls()
    if run.trace:
        calls.install()
    loader = feed = prog = None
    try:
        prog = Program(detr, tc, sd, run.seed, device)
        del sd
        feed, loader = make_feed(run, detr, tc, device, tmp)
        run.log("program and feed built")
        readings, batches, seen = checked_steps(prog, feed, tr["checked_steps"], k, sd_cpu)
        last = batches[-1]
        for shape in tc.shape_buckets if tr["feed"] == "coco" else ():
            if tuple(shape) not in seen:  # warm the canvases the loader has not shown
                prog(_bucket_batch({n: v.to(device) for n, v in last.items()}, shape))
        instrument.sync(device)
        window(run, prog, feed, cfg, B, device, calls)
    finally:
        calls.remove()
        if feed is not None:
            feed.close()
        if loader is not None:
            loader.close()
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


def window(run, prog: Program, feed, cfg: dict, B: int, device, calls) -> None:
    """The measured window (and, traced, the profiled micro-steps after it)."""
    step_flops: dict = {}

    def micro_step_flops(batch) -> int:
        shape = tuple(batch["image"].shape[1:3])
        if shape not in step_flops:
            step_flops[shape] = 3 * B * flops.forward_flops(cfg, *shape)
        return step_flops[shape]

    def loop(deadline: float, count: int | None, traced: bool):
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
        from detr_tpu_torch.ops import masked_attention as ma

        launches0 = ma.launches
        calls.recording = True
        with instrument.profiler(device) as prof:
            with torch.profiler.record_function(trace_mod.WINDOW):
                m, _, _, _ = loop(0.0, run.traffic["trace_micro_steps"], True)
        calls.recording = False
        traced = trace_mod.reduce_profile(prof)
        fwd = bwd = 0.0
        for b, lq, s, h, d, masked, dtype in calls.calls:
            f, g = flops.attention_bounds(b, lq, s, masked, h, d, dtype)
            fwd, bwd = fwd + f, bwd + g
        run.record = {
            "kind": "train", "micro_steps": n, "window_s": elapsed, "input_wait_s": wait,
            "flops": done, "peak_flops": flops.PEAK_FLOPS[cfg["dtype"]],
            "profiled_micro_steps": m, "trace": traced,
            "attention_bound_s": fwd + bwd, "attention_calls": len(calls.calls),
            "attention_forward_launches": ma.launches - launches0,
        }
        run.breakdown = instrument.breakdown(traced)
    run.device = instrument.device_info(device, peak, traced)


def _blocks(n: int, rows: int):
    return [(r, min(r + rows, n)) for r in range(0, n, rows)]


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
    opt = ro.AdamW({n: sd[n] for n in names}, train["lr"], train["lr_backbone"],
                   train["weight_decay"], train["gradient_max_norm"], traffic["accumulation"])
    costs = {"class": train["set_cost_class"], "bbox": train["set_cost_bbox"],
             "giou": train["set_cost_giou"]}
    coefs = {"ce": train["label_ce_loss_coef"], "bbox": train["bbox_loss_coef"],
             "giou": train["giou_loss_coef"]}
    gen = torch.Generator().manual_seed(seed)
    rows = traffic["reference_rows"]
    losses, grad_norms = [], None
    for batch in batches:
        b = {key: v.to(device) for key, v in batch.items()}
        if fault == "half_batch":
            half = b["image"].shape[0] // 2
            b = {key: v[:half] for key, v in b.items()}
        seeds = rm.Seeds.draw(gen, rm.seeds_per_forward(cfg))
        image = ri.normalize(b["image"], b["height"], b["width"])
        gt = (b["class_idx"], b["boxes_normalized"], b["gt_valid"] & b["image_valid"][:, None])
        den = rc.denominators(gt[2], cfg["num_object_queries"], train["eos_coef"])
        grads = {n: torch.zeros_like(sd[n]) for n in names}
        total = 0.0
        for lo, hi in _blocks(image.shape[0], rows):
            out = rm.forward(sd, cfg, image[lo:hi], b["height"][lo:hi], b["width"][lo:hi], P,
                             seeds, lo)
            block_gt = [g[lo:hi] for g in gt]
            matches = rc.assign(out["pred_logits"], out["pred_boxes"], *block_gt, costs)
            s = rc.sums(out["pred_logits"], out["pred_boxes"], *block_gt, matches,
                        cfg["num_classes"], train["eos_coef"])
            loss = rc.loss(s, den, coefs)
            got = torch.autograd.grad(loss, [sd[n] for n in names], allow_unused=True)
            for n, g in zip(names, got):
                if g is not None:
                    grads[n] += g
            total += float(loss.detach())
        losses.append(total)
        applied = opt.micro_step(grads)
        if applied is not None and grad_norms is None:
            grad_norms = dict(zip(names, _leaf_norms([applied[n] for n in names])))
    change = {n: float(torch.linalg.vector_norm((sd[n].detach() - sd_cpu[n].to(device)).double()))
              for n in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


# A leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone: its change is not compared.
STILL_LEAF = 1e-3


def compare(prog: dict, ref: dict, k: int) -> dict:
    """The numbers compared: the worst step's relative loss gap, the worst
    leaf's gap of first-gradient norms, and of parameter-change norms after
    the checked steps, each gap over the reference's norm of that leaf or of
    the median leaf, whichever is larger."""
    steps = len(ref["losses"]) // k
    loss_gap = max(
        abs(mean(prog["losses"][s * k:(s + 1) * k]) - mean(ref["losses"][s * k:(s + 1) * k]))
        / abs(mean(ref["losses"][s * k:(s + 1) * k])) for s in range(steps))
    gr, gp = ref["grad_norms"], prog["grad_norms"]
    g_med = median(gr.values())
    grad_gap = max(abs(gp[n] - gr[n]) / max(gr[n], g_med) for n in gr)
    moved = [n for n in gr if gr[n] >= STILL_LEAF * g_med]
    cr, cp = ref["change_norms"], prog["change_norms"]
    c_med = median(cr[n] for n in moved)
    change_gap = max(abs(cp[n] - cr[n]) / max(cr[n], c_med) for n in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
