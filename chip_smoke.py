#!/usr/bin/env python3
"""Drive the PyTorch port (``detr_tpu_torch``) on one CUDA card and check it.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile every ``detr_tpu_torch/csrc/*.cu`` with nvcc (sm_90a),
     print the build seconds and ptxas's registers / shared memory.
  3. kernels vs plain, serving shapes: the masked-attention forward kernel
     against its plain PyTorch version on the card, at the three DETR-R50
     serving shapes in bf16 and fp32, plus a fully masked image and a ragged
     query length (bf16 out: at most 1 ulp per element and 1 % of elements
     differing; fp32 out and lse: 1e-4), a second launch for the same bits;
     CUDA-event times of the kernel, the plain version, the
     ``F.scaled_dot_product_attention`` yardstick, and the least time the
     card could take.
  4. card vs CPU: full-width DETR-R50 forward in fp32 (TF32 off), batch 2 at
     800x1344, kernel path on the card against the plain path on the CPU.
  5. serve: ``InferenceEngine(DETRConfig(), batch_size=8)`` (R50, bf16,
     800x1344 and 1344x800 buckets): warmup, 20 batch-1 requests, then
     batch-8 batches over a mix of image sizes; every attention must go
     through the kernel, 18 launches per forward.
  6. breakdown: where one batch-8 request's time goes (host transform,
     assembly, copy, forward wall and device time).
  7. kernels vs plain, training shapes: the forward with dropout 0.1 and the
     two backward kernels (dK/dV, dQ) against their plain versions, bf16 and
     fp32, at the three DETR-R50 training shapes (B=5, 832x1344), at DC5's
     S=4200 (B=2), at a fully masked image and at a ragged L=37, and with a
     nonzero dropout hash base (b_off, h_off, H_total) = (5, 4, 8), a rank's
     block of 4 of 8 heads, at the encoder and the decoder's cross-attention
     (bf16: at most 1 ulp per element and 1 % of elements differing; fp32:
     1e-4; the base must move the mask), each kernel launched twice for the
     same bits; the autograd path on
     the card; the auction kernel against its plain version (the same
     assignments and rounds, the same bits twice) and scipy at N=30,
     Q=G=100 (the training step's matching, near-identical rows, and a dense
     batch with up to 100 valid GT) and at Q=2048, G=20 (the chunked build);
     times against the library yardsticks and the bounds, and the auction's
     microseconds per round.  Then ``--tiny``'s model (head size 8, padded
     to the kernels' 32): one fp32 train step with dropout on the card
     against the CPU, and the ``--tiny --synthetic`` CLI on the card (two
     micro-steps and one validation batch).
  7b. MSDA, Deformable DETR's multi-scale deformable attention, at the
     deformable cell's shapes (B=4, the four levels of 832x1344, 8 heads of
     32, 4 points, bf16) with the encoder's 23,205 queries and the
     decoder's 300: the forward and backward kernels through the wrapper's
     autograd against the plain ``grid_sample`` version (out and d value:
     phase 7's bf16 rule; d locations and d weights, fp32: 1e-4 of the
     largest, the same bits twice); kernel, plain and bound
     (``benchmark.flops_deformable.msda_bounds``) times; then one Deformable
     DETR train micro-step on the card (``build_detector``,
     ``make_train_step``) with the MSDA counters zeroed before it: 12
     forward and 12 backward launches and a finite loss.
 8. train step, card vs CPU: one full-width fp32 step (TF32 off, dropout 0,
     B=2, 832x1344, accumulation 1) with the assignment computed on the card
     and injected on both sides: loss dict, grad_norm, parameters after the
     AdamW update.
  9. train: ``train_DETR`` at full width (R50, bf16, dropout 0.1, B=5,
     832x1344, 12 micro-steps per AdamW update) for 24 micro-steps on
     synthetic data through the prefetch thread: finite losses, parameters
     change at updates only, 18 forward, 18 + 18 backward and 1 auction
     launch per micro-step; images/s and the window split into waiting for
     the next batch, the step, the smoke's own checks and the rest; then the
     epoch's checkpoint and one validation batch of 5 (outside the window):
     18 forward launches, no backward.
 9b. trace: ``utils.profiling.trace`` over 4 micro-steps of phase 9's
     configuration after 2 of warm-up, batches through the prefetch thread,
     read from the profiler's events: the card's idle share of the window,
     host waits (``cudaStreamSynchronize`` and kin) and host-to-card copies
     per micro-step (no wait inside a micro-step, where the hash dropout and
     the position encoding run, and no copy from pageable memory), the top
     10 device operations, and device time by group (convolutions, attention
     kernels, the auction, the rest) and by part of the step (forward,
     backbone, hash dropout, criterion, backward, optimizer).
 10. train on COCO-format data: 200 training and 60 validation JPEGs written
     by the port's generator, ``train_DETR`` as in 9 but through
     ``CocoDataset``, the training augmentation in 2 worker processes, the
     three default buckets and uint8 batches normalised on the card: the
     same checks, every batch in one of the buckets, the card's normalisation of
     the first batch against the host's (1e-6, padding exactly 0), the same
     report, one validation batch, and the loader alone at 0 and 2 workers;
     one whole epoch of the seeded loader with no worker fills at least two
     buckets.
 11. validate, checkpoint, restore, serve: ``train_DETR`` on phase 10's data
     for one epoch of 12 micro-steps (one AdamW update), its checkpoint, and
     validation over all 60 validation images (18 forward launches per
     batch, no backward; COCO AP keys finite and in [0, 1] or -1); a restore
     into a fresh state on the card equal to the saved one bit for bit; a
     second ``train_DETR`` on the same output dir that auto-restores and
     trains epoch 1, keeping ``checkpoint_total_limit`` (1) checkpoints;
     ``InferenceEngine(checkpoint_dir=...)`` on 8 validation images equal,
     bit for bit, to the restored model's own forward and postprocess; the
     reference ``model.safetensors`` round trip bit for bit; save and
     restore seconds, bytes on disk, validation images/s, the evaluator's
     host seconds, the image grids' drawing and logging seconds, and peak
     device memory.
 12. the single-card trainer complete, on phase 10's data.  12a: the
     device-resize wire at full width, ``train_DETR`` as in phase 10 with
     ``TrainingConfig(device_resize=True)``: the same checks and report,
     every batch a default source canvas with its source extents on the
     card, the card's ``prepare_batch_image`` of the first batch against
     the CPU's (1e-4 on the normalised image, with TF32 switched on for
     the process: the resample must not use it; padding exactly 0), the
     host-to-card bytes per micro-step against phase 10's, the loader alone
     at 0 and 2 workers, and ``resize_on_device``'s device ms per
     micro-step against its fp32 bound.  12b: the CLI, ``main([...])`` on
     DETR-R101 with ``--device-resize --bn-recalibrate-epochs 1
     --shape-buckets 640x1088,1088x640 --val-min-size 640`` and the rates and
     coefficients from flags, 2 epochs of 4 micro-steps: the source
     canvases, a recalibration, a checkpoint and a validation (640x1088
     from 640x672 and 672x640) per epoch, the applied rates and
     coefficients, the launches, finite losses, AP keys; peak memory.
 13. multi-rank training, DC5 and the entry points.  13a: ``train_DETR``
     with ``DETRConfig(dilation=True)`` at full width (R50, bf16, dropout
     0.1), B=2 at 800x1344 on synthetic data, 8 micro-steps, a checkpoint
     and one validation batch: phase 9's checks, and 12 of every forward's
     18 attention launches at S=4200; images/s, median micro-step, peak
     memory.  13b: two processes sharing the card over gloo (NCCL's refusal
     of two ranks on one device is probed and logged): one fp32 step (TF32
     off, dropout 0, B=2 at 640x640, the card's assignment injected) for
     tp=2 and for dp=2 against the one-process step (phase 8's rule), then
     ``train_DETR`` in bf16 with dropout 0.1 for 4 micro-steps per layout,
     a checkpoint and a validation batch: finite losses, 18 + 18 + 18 + 1
     launches per rank and micro-step at 4 heads (tp=2) and 8 (dp=2), rank 1
     returning {}.  13c: the CLI with ``--num-devices 1 --model-parallel 1``
     in a process of its own under an NCCL group of one rank (2 micro-steps
     and a validation batch through the grid's collectives), then
     ``entry.entry()`` on the card.  13d: ``InferenceEngine`` with DC5 and
     with R101, batch 8 at 800x1344: 4 batch-1 requests and one of 8, 18
     launches per forward, every box finite and inside its image.
 14. the modules of the last slice.  14a: both host C++ libraries
     (``detr_tpu_torch/native/``) built with g++ right after phase 2, before
     any loader worker spawns, or the run fails; later, on phase 10's JPEGs,
     ``TrainTransform`` per image native against numpy/PIL, each operation
     alone and its agreement (resize within one uint8 level of PIL, float
     ops 5e-3, normalize 1e-5), OpenMP's threads in the loader's two
     spawned workers (one each), and the loader alone at 2 workers on each
     path.  14b: the evaluator at
     COCO-val scale (5000 images, 80 classes, 100 detections each, seed 0):
     native on all, numpy on the first 1000, which must agree exactly.
     14c: ``train_DETR`` with ``remat=True`` on phase 10's data, 8
     micro-steps (36 + 18 + 18 + 1 launches: the recomputation repeats the
     attention forwards) and a validation whose two image grids must be in
     the event file, with a benchmark's pause file held for 3 s mid-run;
     then 6 micro-steps without and with remat from the same seeds (R50
     B=5, DC5 B=2), equal, with each side's peak memory and median step
     time; the grids' drawing and logging seconds.  14d:
     the weights export of 14c's run and a weights-only resume from it,
     whose parameters before its first step equal the export bit for bit.
 15. the learning run (``detr_tpu_torch.examples.convergence_synthetic``).
     15a: the attention kernels (bf16 and fp32) and the auction at its
     shapes against their plain versions under phase 7's rules, timed: B=16
     at 256x256 (S=64), 4 heads; the small demo (D=16, zero-padded to 32,
     16 queries, dropout 0.1) and the mid preset (D=32, 50 queries, dropout
     0); the auction at N = 16 images x the decoder layers, Q=16 and Q=50,
     G=8.  15b: the small demo's first 3 steps (``build``, ``train_chunk``)
     on the card against the CPU, fp32 with TF32 off and dropout 0, the
     card's assignment injected: phase 8's rule on each step's loss dict
     and on the parameters after them.  15c: the small demo's ``main()`` on
     the card for LEARN_STEPS steps: 6 + 6 + 6 attention launches and 1
     auction per step, every evaluation's AP dict finite, the loss at the
     last evaluation below the first's by LEARN_LOSS_DROP; steps per second
     and the loss curve.
The line before the last is the JSON ``kernels`` report; the last line is
``{"ok": true, "device": {...}}``.  Weights are random, from seed 0.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import faulthandler
import json
import sys
import logging
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# Published H100 SXM peaks at 700 W (dense): bf16 tensor cores, fp32 outside
# the tensor cores, HBM3 bandwidth.
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
B, H, D = 8, 8, 32
TOKENS = 25 * 42  # 800x1344 bucket at stride 32
QUERIES = 100
# The forward's out: bf16 by ops.attention.bf16_agreement, as the backward's
# gradients below (the tensor cores sum in another fp32 order); fp32 (the
# scalar kernel) within 1e-4.
TOL_OUT_FP32 = 1e-4
TOL_LSE = 1e-4  # fp32 arithmetic on both sides
SERVE_SIZES = [(480, 640), (640, 480), (800, 1067), (1067, 800), (800, 800)]
# Training: micro-batch 5 at the first shape bucket, 832x1344 (26x42 tokens).
TRAIN_B = 5
TRAIN_TOKENS = 26 * 42
DC5_TOKENS = 4200  # DETR-DC5's encoder at 800x1344 (stride 16)
RATE = 0.1  # attention-probability dropout
# The bf16 kernels sum on tensor cores in another fp32 order than the plain
# versions, which flips the final bf16 rounding of a few elements: each bf16
# output or gradient is held to at most one bf16 ulp per element (of the
# plain value, or of a quarter of the tensor's largest where the value is
# smaller) and at most 1 % of its elements differing at all
# (ops.attention.bf16_agreement).  A fault in the bf16 arithmetic flips far
# more: P cast to bf16 before it is normalised (a one-pass forward) 44-53 %
# of out (tests/test_torch_port_attention_fwd.py); dS left in fp32 or P_d
# rounded to one bf16 value in dV 26-43 % of the gradients
# (tests/test_torch_port_attention_bwd.py).  fp32 backward (the scalar
# kernels): 1e-4 of each gradient's largest plain value.
BF16_RULE = ("bf16: at most 1 ulp per element (of the plain value, or of a quarter of the "
             "tensor's largest) and 1 % of elements differing")
TOL_BWD_FP32 = 1e-4
EPS_MIN = 1e-3  # the matcher's training epsilon (TrainingConfig.matcher_eps_min)
# The validation batch of phases 9, 10, 12a, 14c and 14d: their validations
# draw and log image grids of this many images, not the trainer's default 25
# (phase 11 keeps 25).
VAL_BATCH = 5
# The script must end within 1200 s: every thread's traceback goes to
# stderr shortly before, so that a hang shows where it is.
HANG_DUMP_S = 1140.0
_T_START = time.perf_counter()


def log(*args) -> None:
    print(*args, flush=True)


def progress(step: str) -> None:
    """One line on stderr as ``step`` starts, with the seconds since the
    script started."""
    print(f"chip_smoke: {step} at {time.perf_counter() - _T_START:.1f} s",
          file=sys.stderr, flush=True)


def _scratch_dir(prefix: str) -> str:
    """A new directory under the checkout's git-ignored ``build/``, for a
    run's output (checkpoints, logs) or data; the caller removes it."""
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=build)


def device_time_ms(fn, iters: int) -> float:
    """Device time per call: the calls queue behind a device-side sleep, so
    the events time the card's work back to back, not the host's launches."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    return kind, smi


def phase_build() -> None:
    from detr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"build: {len(paths)} kernel libraries in {time.perf_counter() - t0:.2f} s")
    for stem, path in paths.items():
        log(f"  {stem}: {path.name}")
        for line in _build.build_logs.get(stem, "").splitlines():
            if re.search(r"entry function|registers|spill", line):
                log(f"    {line.strip()}")


def _mask_from_extent(batch: int, h: int, w: int, fh: int, fw: int,
                      stride: int = 32) -> torch.Tensor:
    rows = torch.arange(fh, device="cuda")[:, None] >= -(-h // stride)
    cols = torch.arange(fw, device="cuda")[None, :] >= -(-w // stride)
    return (rows | cols).reshape(1, fh * fw).expand(batch, -1).contiguous()


def phase_kernels() -> list[dict]:
    from detr_tpu_torch.ops import masked_attention as ma

    mask = _mask_from_extent(B, 800, 1067, 25, 42)  # an 800x1067 image in 800x1344
    shapes = [  # (name, batch, Lq, S, mask, launches per forward)
        ("encoder_self", B, TOKENS, TOKENS, mask, 6),
        ("decoder_cross", B, QUERIES, TOKENS, mask, 6),
        ("decoder_self", B, QUERIES, QUERIES, None, 6),
    ]
    edge_mask = _mask_from_extent(2, 800, 1067, 25, 42)
    edge_mask[1] = True  # one image with every key padded
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, lq, s, m, per_fwd in shapes + [("edge_fully_masked_ragged_L", 2, 37, TOKENS,
                                                 edge_mask, 0)]:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(b, lq, H, D, device="cuda", generator=gen).to(dtype)
            k = torch.randn(b, s, H, D, device="cuda", generator=gen).to(dtype)
            v = torch.randn(b, s, H, D, device="cuda", generator=gen).to(dtype)
            out, lse = ma.masked_attention(q, k, v, m)
            again = ma.masked_attention(q, k, v, m)
            ref_out, ref_lse = ma.masked_attention_reference(q, k, v, m)
            torch.cuda.synchronize()
            row = dict(shape=name, dtype=str(dtype).replace("torch.", ""), B=b, H=H, L=lq,
                       S=s, D=D, masked=m is not None, launches_per_forward=per_fwd,
                       lse_err=float((lse - ref_lse).abs().max()), lse_tolerance=TOL_LSE,
                       fwd_same_bits_twice=torch.equal(again[0], out) and torch.equal(again[1], lse))
            ok = _out_check(row, out, ref_out) and row["lse_err"] <= TOL_LSE
            if not (ok and row["fwd_same_bits_twice"]):
                raise AssertionError(f"kernel disagrees with its plain version: {row}")
            if name.startswith("edge"):
                f32_min = torch.finfo(torch.float32).min
                if not bool((lse[1] == f32_min).all()):
                    raise AssertionError("fully masked rows must give lse == finfo(f32).min")
            else:
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                attn_mask = None if m is None else ~m[:, None, None, :]
                row["kernel_ms"] = device_time_ms(lambda: ma.masked_attention(q, k, v, m), 50)
                row["plain_ms"] = device_time_ms(
                    lambda: ma.masked_attention_reference(q, k, v, m), 10)
                row["library_ms"] = device_time_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=attn_mask), 50)
                bounds = _attention_bounds(dtype, b, lq, s, m is not None)
                row["bound_ms"], row["bound_by"] = bounds["fwd"]
                row["own_bound_ms"], row["own_bound_by"] = bounds["fwd_own"]
            log(f"kernel check: {json.dumps(row)}")
            rows.append(row)
    return rows


def phase_card_vs_cpu() -> None:
    from detr_tpu_torch.config import DETRConfig
    from detr_tpu_torch.models import DETR
    from detr_tpu_torch.ops import masked_attention as ma

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        config = DETRConfig(dtype="float32")
        per_forward = config.num_encoder_layers + 2 * config.num_decoder_layers
        model = DETR(config).eval()
        model.reset_parameters(torch.Generator().manual_seed(0))
        card = copy.deepcopy(model).cuda()
        rng = np.random.default_rng(0)
        imgs = rng.normal(size=(2, 800, 1344, 3)).astype(np.float32)
        imgs[1, :, 1067:] = 0.0
        hs, ws = np.array([800, 800], np.int32), np.array([1344, 1067], np.int32)
        args = [torch.from_numpy(x) for x in (imgs, hs, ws)]
        before = ma.launches
        with torch.inference_mode():
            t0 = time.perf_counter()
            got = card(*[a.cuda() for a in args])
            got = {k: v.cpu() for k, v in got.items()}
            t_card = time.perf_counter() - t0
            launched = ma.launches - before
            t0 = time.perf_counter()
            want = model(*args)
            t_cpu = time.perf_counter() - t0
        rel = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max()) for k in got}
        log(f"card vs cpu (fp32, TF32 off, B=2 800x1344): max|diff|/max|cpu| {rel}, "
            f"kernel launches {launched}, card {t_card:.3f} s (first call), cpu {t_cpu:.3f} s")
        # fp32 on both sides; sums run in other orders through 53 convolutions
        # and 12 transformer layers: 1e-4 of the largest output (2e-6 measured
        # on an H100).
        if launched != per_forward or not all(np.isfinite(v) and v <= 1e-4 for v in rel.values()):
            raise AssertionError("card forward disagrees with the CPU forward")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def phase_serve(smi: str):
    from detr_tpu_torch.config import DETRConfig
    from detr_tpu_torch.ops import masked_attention as ma
    from detr_tpu_torch.serve import InferenceEngine

    config = DETRConfig()
    per_forward = config.num_encoder_layers + 2 * config.num_decoder_layers  # 18
    engine = InferenceEngine(config, batch_size=8, score_threshold=0.5)
    t0 = time.perf_counter()
    engine.warmup()
    log(f"serve warmup: {time.perf_counter() - t0:.2f} s")

    forwards, finite = [0], []

    def on_forward(_module, _inputs, out):
        forwards[0] += 1
        finite.append(torch.isfinite(out["pred_logits"]).all()
                      & torch.isfinite(out["pred_boxes"]).all())

    engine.model.register_forward_hook(on_forward)
    rng = np.random.default_rng(3)

    def make_img(i):
        h, w = SERVE_SIZES[i % len(SERVE_SIZES)]
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)

    torch.cuda.reset_peak_memory_stats()
    ma.launches = 0  # the main path starts here
    lat, results = [], []
    for i in range(20):
        img = make_img(i)
        t0 = time.perf_counter()
        results.append((img, engine.predict([img])[0]))
        lat.append(time.perf_counter() - t0)
    batches = [[make_img(i * 8 + j) for j in range(8)] for i in range(3)]
    t0 = time.perf_counter()
    for imgs in batches:
        results.extend(zip(imgs, engine.predict(imgs)))
    dt = time.perf_counter() - t0
    launches, main_forwards = ma.launches, forwards[0]  # the main path ends here

    if launches != per_forward * main_forwards or main_forwards == 0:
        raise AssertionError(f"{launches} kernel launches for {main_forwards} forwards")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite model outputs")
    n_det = 0
    for img, det in results:
        oh, ow = img.shape[:2]
        b = det["boxes"]
        n_det += len(b)
        if not (np.isfinite(det["scores"]).all() and np.isfinite(b).all()):
            raise AssertionError("non-finite detections")
        if len(b) and not ((b >= -1e-3).all() and (b[:, [0, 2]] <= ow + 1e-3).all()
                           and (b[:, [1, 3]] <= oh + 1e-3).all()):
            raise AssertionError("boxes outside the original image")
        if len(b) and not (det["scores"] >= 0.5).all():
            raise AssertionError("detections below the score threshold")
    # At the 0.5 threshold random weights detect nothing; check every box of
    # every query once, at threshold 0, on one image of each size.
    engine.score_threshold = 0.0
    mix = [make_img(i) for i in range(len(SERVE_SIZES))]
    for img, det in zip(mix, engine.predict(mix)):
        oh, ow = img.shape[:2]
        b = det["boxes"]
        if not (len(b) == config.num_object_queries and np.isfinite(b).all()
                and (b >= -1e-3).all() and (b[:, [0, 2]] <= ow + 1e-3).all()
                and (b[:, [1, 3]] <= oh + 1e-3).all()):
            raise AssertionError(f"bad boxes for a {oh}x{ow} image")
    engine.score_threshold = 0.5
    lat_ms = np.sort(np.array(lat)) * 1e3
    serve = dict(
        card=smi,
        batch1_p50_ms=float(np.percentile(lat_ms, 50)),
        batch1_p99_ms=float(np.percentile(lat_ms, 99)),
        batch8_images_per_s=8 * len(batches) / dt,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        forwards=main_forwards,
        kernel_launches=launches,
        detections=n_det,
    )
    log(f"serve: {json.dumps(serve)}")
    return launches, engine


def phase_breakdown(engine, smi: str) -> None:
    """Where one batch-8 request's time goes, on the 800x1344 bucket: the
    host wire's transform of one 800x1067 image, batch assembly and
    host-to-device copy (a float request's path), and the forward's wall
    time (synchronised) against its device time (queued behind a
    device-side sleep, so host launch gaps do not count); then a whole
    ``predict`` of 8 uint8 requests, which take the source wire."""
    from detr_tpu_torch.serve.engine import _empty_target

    img = np.random.default_rng(4).integers(0, 256, (800, 1067, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    timg, _ = engine.transform(img, _empty_target())
    t_transform = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = np.zeros((engine.batch_size, 800, 1344, 3), np.float32)
    batch[:, : timg.shape[0], : timg.shape[1]] = timg
    t_assemble = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = torch.from_numpy(batch).cuda()
    torch.cuda.synchronize()
    t_copy = time.perf_counter() - t0
    hs = torch.full((engine.batch_size,), timg.shape[0], device="cuda")
    ws = torch.full((engine.batch_size,), timg.shape[1], device="cuda")
    with torch.inference_mode():
        engine.model(images, hs, ws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            engine.model(images, hs, ws)
        torch.cuda.synchronize()
        t_forward = (time.perf_counter() - t0) / 3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000_000)
        start.record()
        for _ in range(3):
            engine.model(images, hs, ws)
        end.record()
        end.synchronize()
        device_forward = start.elapsed_time(end) / 3
        start.record()
        for _ in range(3):
            engine.model.backbone(images)
        end.record()
        end.synchronize()
        t_backbone = start.elapsed_time(end) / 3  # queued behind the forwards above
    t0 = time.perf_counter()
    engine.predict([img] * engine.batch_size)
    t_predict = time.perf_counter() - t0
    log("serve breakdown: " + json.dumps(dict(
        card=smi, bucket=[800, 1344], batch=engine.batch_size,
        host_transform_ms_per_image=t_transform * 1e3,
        host_assemble_ms=t_assemble * 1e3,
        host_to_device_copy_ms=t_copy * 1e3,
        forward_wall_ms=t_forward * 1e3,
        forward_device_ms=device_forward,
        backbone_wall_on_device_ms=t_backbone,
        predict_batch8_ms=t_predict * 1e3,
    )))


def _rand(gen, shape, dtype):
    return torch.randn(*shape, device="cuda", generator=gen).to(dtype)


def _attention_bounds(dtype, b, lq, s, masked, heads: int = H, d: int = D) -> dict:
    """Least times of the forward, of the whole backward, and of each kernel
    of the split backward: operations (2 per multiply-add of each product it
    needs) over the peak for the dtype, or the bytes it must move (inputs
    once, outputs once) over the memory rate, whichever is larger.  "fwd" and
    "bwd" are the functions the Pallas ``_fwd_kernel`` and ``_bwd_kernel``
    compute (two and five products, each tensor moved once); "fwd_own" is the
    two-pass bf16 forward's, which computes s twice; "dkv" and "dq" each
    recompute s and dP, so their sum is the split design's bound, not the
    function's."""
    elt = torch.finfo(dtype).bits // 8
    rows = b * heads * d * elt
    stats = 4 * b * heads * lq  # one fp32 per query row: lse, delta
    mask = b * s if masked else 0
    work = {  # name: (operations, bytes)
        "fwd": (4 * b * heads * lq * s * d, rows * (2 * lq + 2 * s) + stats + mask),
        # s = q.k in each pass, O = P_d v
        "fwd_own": (6 * b * heads * lq * s * d, rows * (2 * lq + 2 * s) + stats + mask),
        # s = q.k, dP = g.v, dV = P g, dQ = dS k, dK = dS q; q, g, dq, k, v,
        # dk, dv, lse, delta and the mask once each
        "bwd": (10 * b * heads * lq * s * d, rows * (3 * lq + 4 * s) + 2 * stats + mask),
        # s = q.k, dP = g.v, dV += P g, dK += dS q
        "dkv": (8 * b * heads * lq * s * d, rows * (2 * lq + 4 * s) + 2 * stats + mask),
        # s = q.k, dP = g.v, dQ += dS k
        "dq": (6 * b * heads * lq * s * d, rows * (3 * lq + 2 * s) + 2 * stats + mask),
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / PEAK_OPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return out


def _rel_err(got, want) -> tuple[float, float]:
    """max |got - want| and the scale it is judged against, max |want|."""
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    return err, float(want.abs().max())


def _grad_check(row: dict, key: str, got, want) -> bool:
    """Record one gradient's agreement with its plain version in ``row``
    and say whether it holds: bf16 by ulps and share, fp32 by 1e-4."""
    from detr_tpu_torch.ops.attention import BF16_MAX_SHARE, BF16_MAX_ULPS, bf16_agreement

    err, scale = _rel_err(got, want)
    row[f"{key}_err"] = err
    if got.dtype == torch.bfloat16:
        max_ulps, share = bf16_agreement(got, want)
        row[f"{key}_max_ulps"], row[f"{key}_share_differing"] = max_ulps, share
        return max_ulps <= BF16_MAX_ULPS and share <= BF16_MAX_SHARE
    row[f"{key}_tolerance"] = TOL_BWD_FP32 * scale
    return err <= TOL_BWD_FP32 * scale


def _out_check(row: dict, out, ref_out) -> bool:
    """Record the forward's out against its plain version in ``row`` and say
    whether it holds: bf16 by ulps and share, fp32 within TOL_OUT_FP32."""
    from detr_tpu_torch.ops.attention import BF16_MAX_SHARE, BF16_MAX_ULPS, bf16_agreement

    row["out_err"] = float((out.float() - ref_out.float()).abs().max())
    if out.dtype == torch.bfloat16:
        max_ulps, share = bf16_agreement(out, ref_out)
        row["out_max_ulps"], row["out_share_differing"] = max_ulps, share
        return max_ulps <= BF16_MAX_ULPS and share <= BF16_MAX_SHARE
    row["out_tolerance"] = TOL_OUT_FP32
    return row["out_err"] <= TOL_OUT_FP32


def _check_attention_shapes(gen, shapes, rate: float = RATE, d: int = D,
                            label: str = "train kernel check") -> list[dict]:
    """Each shape's forward (at dropout ``rate``) and backward kernels
    against their plain versions on the card, bf16 and fp32, at head size
    ``d`` (below 32 the wrappers zero-pad it); each kernel launched twice
    for the same bits; the timed shapes' kernel, plain, library and bound
    times.  ``shapes``: (name, batch, heads, Lq, S, mask, hash base,
    launches per micro-step, timed)."""
    from detr_tpu_torch.ops import masked_attention as ma

    rows = []
    for name, b, heads, lq, s, m, base, per_step, timed in shapes:
        kw = {} if base is None else {"hash_base": base}
        for dtype in (torch.bfloat16, torch.float32):
            q, g = (_rand(gen, (b, lq, heads, d), dtype) for _ in range(2))
            k, v = (_rand(gen, (b, s, heads, d), dtype) for _ in range(2))
            seed = 1234 + len(rows)
            out, lse = ma.forward_cuda(q, k, v, m, seed, rate, **kw)
            fwd_again = ma.forward_cuda(q, k, v, m, seed, rate, **kw)
            ref_out, ref_lse = ma.masked_attention_reference(q, k, v, m, seed, rate, **kw)
            # backward_inputs zero-pads a head size below 32: the kernels
            # take the true scale, and their gradients' first d columns count
            qc, kc, vc, gc, delta = ma.backward_inputs(q, k, v, g, out)
            bkw = dict(kw, scale=1.0 / d**0.5)
            dk, dv = ma.bwd_dkv_cuda(qc, kc, vc, m, gc, lse, delta, seed, rate, **bkw)
            dq = ma.bwd_dq_cuda(qc, kc, vc, m, gc, lse, delta, seed, rate, **bkw)
            again = (ma.bwd_dq_cuda(qc, kc, vc, m, gc, lse, delta, seed, rate, **bkw),
                     *ma.bwd_dkv_cuda(qc, kc, vc, m, gc, lse, delta, seed, rate, **bkw))
            if d < ma.HEAD_SIZE:
                again, dq, dk, dv = ([x[..., :d] for x in again],
                                     *(x[..., :d] for x in (dq, dk, dv)))
            ref = ma.masked_attention_backward_reference(q, k, v, m, g, out, lse, seed, rate,
                                                         **kw)
            torch.cuda.synchronize()
            row = dict(shape=name, dtype=str(dtype).replace("torch.", ""), B=b, H=heads, L=lq,
                       S=s, D=d, masked=m is not None, dropout=rate, hash_base=base,
                       launches_per_step=per_step,
                       lse_err=float((lse - ref_lse).abs().max()), lse_tolerance=TOL_LSE)
            ok = _out_check(row, out, ref_out) and row["lse_err"] <= TOL_LSE
            for key, got, want in (("dq", dq, ref[0]), ("dk", dk, ref[1]), ("dv", dv, ref[2])):
                ok = _grad_check(row, key, got, want) and ok
            # no atomics: a second launch gives the same bits
            row["fwd_same_bits_twice"] = torch.equal(fwd_again[0], out) and torch.equal(fwd_again[1], lse)
            row["same_bits_twice"] = all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))
            ok = ok and row["same_bits_twice"] and row["fwd_same_bits_twice"]
            if base is not None:
                # the base must move the mask: against the same call at base 0
                other = ma.masked_attention_reference(q, k, v, m, seed, rate)[0]
                row["mask_moved_by_base"] = not torch.equal(other, ref_out)
                ok = ok and row["mask_moved_by_base"]
            if not ok:
                raise AssertionError(f"a kernel disagrees with its plain version: {row}")
            if name.startswith("edge") and not bool((lse[1] == torch.finfo(torch.float32).min).all()):
                raise AssertionError("fully masked rows must give lse == finfo(f32).min")
            if timed:
                seed_t = seed
                row["fwd_ms"] = device_time_ms(lambda: ma.forward_cuda(q, k, v, m, seed_t, rate), 20)
                row["dkv_ms"] = device_time_ms(
                    lambda: ma.bwd_dkv_cuda(qc, kc, vc, m, gc, lse, delta, seed_t, rate,
                                            1.0 / d**0.5), 20)
                row["dq_ms"] = device_time_ms(
                    lambda: ma.bwd_dq_cuda(qc, kc, vc, m, gc, lse, delta, seed_t, rate,
                                           1.0 / d**0.5), 20)
                row["fwd_plain_ms"] = device_time_ms(
                    lambda: ma.masked_attention_reference(q, k, v, m, seed_t, rate), 3)
                row["bwd_plain_ms"] = device_time_ms(
                    lambda: ma.masked_attention_backward_reference(
                        q, k, v, m, g, out, lse, seed_t, rate), 3)
                # Yardstick: the library's fused attention with the boolean
                # mask and dropout; its backward alone (all of dq, dk, dv).
                qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
                gt = g.transpose(1, 2)
                am = None if m is None else ~m[:, None, None, :]
                row["fwd_library_ms"] = device_time_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                                           dropout_p=rate), 20)
                lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am, dropout_p=rate)
                row["bwd_library_ms"] = device_time_ms(
                    lambda: torch.autograd.grad(lib_out, (qt, kt, vt), gt, retain_graph=True), 20)
                del lib_out
                bounds = _attention_bounds(dtype, b, lq, s, m is not None, heads, d)
                for kname, (t, by) in bounds.items():
                    row[f"{kname}_bound_ms"], row[f"{kname}_bound_by"] = t, by
            log(f"{label}: {json.dumps(row)}")
            rows.append(row)
            del q, k, v, g, out, lse, fwd_again, ref_out, ref_lse, qc, kc, vc, gc, delta, dk, dv, dq
            del ref, again
        torch.cuda.empty_cache()
    return rows


def phase_train_kernels() -> list[dict]:
    """The attention forward with dropout and the backward kernels against
    their plain versions on the card, at the training shapes."""
    from detr_tpu_torch.ops import masked_attention as ma

    mask = _mask_from_extent(TRAIN_B, 700, 1100, 26, 42)  # a 700x1100 image in 832x1344
    dc5_mask = _mask_from_extent(2, 800, 1067, 50, 84, stride=16)  # 800x1344 at stride 16
    edge_mask = _mask_from_extent(2, 700, 1100, 26, 42)
    edge_mask[1] = True  # one image with every key padded
    # (name, batch, heads, Lq, S, mask, hash base, launches per R50 micro-step, timed); the
    # two dc5 rows (B=2, 800x1344, S=4200) are phase 13a's encoder and decoder
    # cross-attention; the hash
    # base (b_off, h_off, H_total) places a rank's block in the global batch and heads: the
    # last two cases are rank 3 of dp 2 x tp 2 (B=5 per rank, its 4 heads of 8) at the
    # encoder and at the decoder's cross-attention.
    shapes = [
        ("encoder_self", TRAIN_B, H, TRAIN_TOKENS, TRAIN_TOKENS, mask, None, 6, True),
        ("decoder_cross", TRAIN_B, H, QUERIES, TRAIN_TOKENS, mask, None, 6, True),
        ("decoder_self", TRAIN_B, H, QUERIES, QUERIES, None, None, 6, True),
        ("dc5_encoder_self", 2, H, DC5_TOKENS, DC5_TOKENS, dc5_mask, None, 0, True),
        ("dc5_decoder_cross", 2, H, QUERIES, DC5_TOKENS, dc5_mask, None, 0, True),
        ("edge_fully_masked_ragged_L", 2, H, 37, TRAIN_TOKENS, edge_mask, None, 0, False),
        ("hash_base_encoder_self", TRAIN_B, H // 2, TRAIN_TOKENS, TRAIN_TOKENS, mask,
         (TRAIN_B, H // 2, H), 0, False),
        ("hash_base_decoder_cross", TRAIN_B, H // 2, QUERIES, TRAIN_TOKENS, mask,
         (TRAIN_B, H // 2, H), 0, False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = _check_attention_shapes(gen, shapes)

    # The autograd path on the card: an output with a grad_fn whose backward
    # runs the two kernels and gives their gradients.
    q, k, v = (_rand(gen, (2, 37, H, D), torch.bfloat16).requires_grad_() for _ in range(3))
    g = _rand(gen, (2, 37, H, D), torch.bfloat16)
    counts = (ma.launches, ma.launches_bwd_dkv, ma.launches_bwd_dq)
    out, lse = ma.masked_attention(q, k, v, None, RATE, 99)
    if out.grad_fn is None:
        raise AssertionError("masked_attention on CUDA gives no grad_fn")
    out.backward(g)
    want = ma.masked_attention_backward_reference(q, k, v, None, g, out, lse, 99, RATE)
    torch.cuda.synchronize()
    if (ma.launches - counts[0], ma.launches_bwd_dkv - counts[1],
            ma.launches_bwd_dq - counts[2]) != (1, 1, 1):
        raise AssertionError("the autograd path did not go through the kernels")
    for key, got, ref in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad), want):
        row = {}
        if not _grad_check(row, key, got, ref):
            raise AssertionError(f"autograd gradients disagree: {row}")
    # And independently of the plain backward: autograd through the plain
    # forward, fp32, keys partly masked, dropout on.
    q, k, v = (_rand(gen, (2, 37, H, D), torch.float32).requires_grad_() for _ in range(3))
    g = _rand(gen, (2, 37, H, D), torch.float32)
    m = torch.arange(37, device="cuda")[None, :] >= torch.tensor([[30], [12]], device="cuda")
    out, _ = ma.masked_attention(q, k, v, m, RATE, 7)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref_out, _ = ma.masked_attention_reference(q, k, v, m, 7, RATE)
    want = torch.autograd.grad(ref_out, (q, k, v), g)
    for a, b in zip(got, want):
        err, scale = _rel_err(a, b)
        if not err <= TOL_BWD_FP32 * scale:
            raise AssertionError(f"kernel gradients disagree with autograd: {err} of {scale}")
    log("autograd path on the card: grad_fn present, 1 forward + 2 backward launches, "
        "gradients agree with the plain backward and with autograd through the plain forward")
    return rows


AUCTION_DENSE_VALID = (0, 1, 7, 31, 32, 33, 64, 100)  # n_valid of the dense case, cycled


def auction_cases() -> list[tuple[str, torch.Tensor, torch.Tensor]]:
    """The auction's phase-7 cases on the card, (name, cost (N, Q, G), gt_valid
    (N, G)), N=30, Q=G=100: the synthetic training step's matching (B=5 x 6
    decoder layers, Poisson(7) GT), near-identical rows (the early-training
    worst case) and a dense batch whose n_valid cycles over
    AUCTION_DENSE_VALID (crowded COCO images); and N=4, Q=2048, G=20, past
    the 1024 queries of the kernel's register build (its chunked build)."""
    from detr_tpu_torch.data.synthetic import synthetic_batch
    from detr_tpu_torch.matcher.hungarian import compute_cost_matrix

    rng = np.random.default_rng(5)
    L, Q, G = 6, QUERIES, 100
    batch = synthetic_batch(rng, TRAIN_B, 64, 64, max_gt=G)  # GT boxes and Poisson(7) validity
    valid = torch.from_numpy(batch["gt_valid"]).cuda()[:, None].expand(TRAIN_B, L, G)
    logits = torch.from_numpy(rng.normal(size=(TRAIN_B, L, Q, 81)).astype(np.float32)).cuda()
    boxes = torch.sigmoid(torch.from_numpy(rng.normal(size=(TRAIN_B, L, Q, 4)).astype(np.float32))).cuda()
    cost = compute_cost_matrix(
        logits, boxes, torch.from_numpy(batch["class_idx"]).cuda()[:, None].expand(TRAIN_B, L, G),
        torch.from_numpy(batch["boxes_normalized"]).cuda()[:, None].expand(TRAIN_B, L, G, 4),
        valid).reshape(-1, Q, G).contiguous()
    valid = valid.reshape(-1, G).contiguous()
    N = cost.shape[0]
    # near-identical rows: the early-training worst case
    contentious = (torch.from_numpy(rng.normal(size=(N, 1, G)) * 3
                                    + rng.normal(size=(N, Q, G)) * 0.01).float().cuda())
    # dense: every GT slot holds a box; the first n_valid of them are valid
    dense_batch = synthetic_batch(rng, N, 64, 64, max_gt=G, mean_boxes=1e4)
    n_valid = np.resize(np.array(AUCTION_DENSE_VALID), N)
    dense_valid = torch.from_numpy(np.arange(G)[None, :] < n_valid[:, None]).cuda()
    dense = compute_cost_matrix(
        torch.from_numpy(rng.normal(size=(N, Q, 81)).astype(np.float32)).cuda(),
        torch.sigmoid(torch.from_numpy(rng.normal(size=(N, Q, 4)).astype(np.float32))).cuda(),
        torch.from_numpy(dense_batch["class_idx"]).cuda(),
        torch.from_numpy(dense_batch["boxes_normalized"]).cuda(), dense_valid).contiguous()
    long = torch.from_numpy(rng.normal(size=(4, 2048, 20)).astype(np.float32) * 3).cuda()
    long_valid = torch.from_numpy(np.arange(20)[None, :] < np.array([[20], [13], [1], [0]])).cuda()
    return [("synthetic_train", cost, valid), ("contentious", contentious, valid),
            ("dense", dense, dense_valid), ("long_q2048", long, long_valid)]


def phase_auction_kernel(smi: str) -> list[dict]:
    return [_check_auction(name, c, valid, smi) for name, c, valid in auction_cases()]


def _check_auction(name: str, c: torch.Tensor, valid: torch.Tensor, smi: str) -> dict:
    """The auction kernel on one batch of problems (cost (N, Q, G), gt_valid
    (N, G)) against its plain version (the same assignments and rounds, the
    same bits on a second launch) and scipy's optimum (within the auction's
    bound); its time, the plain version's, scipy's and the byte bound."""
    from scipy.optimize import linear_sum_assignment

    from detr_tpu_torch.matcher import auction as au

    N, Q, G = c.shape
    qog, rounds = au.auction_lap(c, valid, eps_min=EPS_MIN)
    again = au.auction_lap(c, valid, eps_min=EPS_MIN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qog_p, rounds_p = au.auction_lap_reference(c, valid, eps_min=EPS_MIN)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    total = au.assignment_total_cost(c, qog, valid)
    total_p = au.assignment_total_cost(c, qog_p, valid)
    c_host, v_host, qog_host = c.cpu().numpy(), valid.cpu().numpy(), qog.cpu().numpy()
    t0 = time.perf_counter()
    opt = []
    for n in range(N):
        vc = np.flatnonzero(v_host[n])
        r, cc = linear_sum_assignment(c_host[n][:, vc]) if len(vc) else ([], [])
        opt.append(float(c_host[n][r, vc[cc]].sum()) if len(vc) else 0.0)
    scipy_ms = (time.perf_counter() - t0) * 1e3
    n_valid = v_host.sum(1)
    bound = 2 * n_valid * EPS_MIN + 1e-4  # the auction's bound + fp32 summation slack
    gap = total.cpu().numpy() - np.array(opt)
    for n in range(N):
        vc = np.flatnonzero(v_host[n])
        if len(np.unique(qog_host[n, vc])) != len(vc) or (qog_host[n][~v_host[n]] != -1).any():
            raise AssertionError(f"auction {name}: problem {n} is not an injective assignment")
    err = float((total - total_p).abs().max())
    rounds_total_max = int(rounds.sum(1).max())
    row = dict(case=name, N=N, Q=Q, G=G, eps_min=EPS_MIN, n_valid=[int(x) for x in n_valid],
               max_gap_to_scipy=float(gap.max()), gap_over_bound=float((gap / bound).max()),
               kernel_vs_plain_max_abs_err=err,
               same_assignment=bool(torch.equal(qog, qog_p)),
               same_rounds=bool(torch.equal(rounds, rounds_p)),
               same_bits_twice=bool(torch.equal(qog, again[0]) and torch.equal(rounds, again[1])),
               rounds_per_phase_max=rounds.max(0).values.tolist(),
               rounds_total_max=rounds_total_max)
    # the kernel runs the plain version's rounds: the same assignment and
    # round counts, bit for bit, and the same bits on a second launch
    if not (row["same_assignment"] and row["same_rounds"] and row["same_bits_twice"]):
        raise AssertionError(f"auction {name}: kernel differs from its plain version: {row}")
    if not (gap <= bound).all():
        raise AssertionError(f"auction {name} outside its bound: {row}")
    row["ms"] = device_time_ms(lambda: au.auction_lap(c, valid, eps_min=EPS_MIN), 10)
    # the rounds are a serial chain the byte bound cannot see
    row["us_per_round"] = row["ms"] * 1e3 / max(rounds_total_max, 1)
    row["plain_ms"] = plain_ms
    row["library_ms"] = scipy_ms  # scipy's host solve of the same problems
    nbytes = N * Q * G * 4 + N * G + N * G * 4 + rounds.numel() * 4
    row["bound_ms"], row["bound_by"] = nbytes / PEAK_BYTES * 1e3, "bytes"
    row["card"] = smi
    log(f"auction check: {json.dumps(row)}")
    return row


# Deformable DETR's cell (train_deformable_resident): micro-batch 4 at the
# 832x1344 canvas, whose four levels (strides 8-64) hold 23,205 tokens; 8
# heads of 32, 4 points per level; the encoder's 6 calls sample at every
# token, the decoder's 6 at its 300 queries.
MSDA_B = 4
MSDA_LEVELS = ((104, 168), (52, 84), (26, 42), (13, 21))
MSDA_POINTS = 4
MSDA_QUERIES = 300
MSDA_CANVAS = (832, 1344)
# fp32 sums of the same products in another order (the kernel's d value
# with atomics): 1e-4 of each tensor's largest element; fp8 e4m3 would miss
# by ~1e-1 (tests/test_torch_port_gpu.py).
TOL_MSDA_FP32 = 1e-4


def _msda_inputs(gen, b: int, lq: int):
    """bf16 value and fp32 locations and weights at the cell's levels: each
    location in a cell drawn from [-1, W_l] x [-1, H_l] (corners outside
    the map) at 0.05-0.95 of the way across it, away from the cell edges
    where the kernel's and grid_sample's pixel arithmetic, an ulp apart,
    would take neighbouring cells (tests/test_torch_port_gpu.py)."""
    S = sum(h * w for h, w in MSDA_LEVELS)
    value = _rand(gen, (b, S, H, D), torch.bfloat16)
    locs = []
    for h, w in MSDA_LEVELS:
        cell = torch.stack([
            torch.randint(-1, w, (b, lq, H, MSDA_POINTS), generator=gen, device="cuda"),
            torch.randint(-1, h, (b, lq, H, MSDA_POINTS), generator=gen, device="cuda")], -1)
        frac = 0.05 + 0.9 * torch.rand(b, lq, H, MSDA_POINTS, 2, generator=gen, device="cuda")
        size = torch.tensor([w, h], dtype=torch.float32, device="cuda")
        locs.append((cell.float() + frac + 0.5) / size)
    loc = torch.stack(locs, dim=3)
    L = len(MSDA_LEVELS)
    logits = torch.randn(b, lq, H, L * MSDA_POINTS, generator=gen, device="cuda")
    attn = torch.softmax(logits, -1).view(b, lq, H, L, MSDA_POINTS)
    return value, loc, attn


def _msda_main_path() -> dict:
    """Deformable DETR's train step on the card (``models.build_detector``,
    ``build_optimizer``, ``build_criterion``, ``make_train_step``; R50,
    bf16, dropout 0.1) at the cell's micro-batch and canvas on a synthetic
    batch: one micro-step to warm up, then one with the MSDA counters
    zeroed just before it -> its launches and loss."""
    from detr_tpu_torch.config import DeformableDETRConfig, TrainingConfig
    from detr_tpu_torch.data.synthetic import synthetic_batch
    from detr_tpu_torch.models import build_detector
    from detr_tpu_torch.ops import ms_deform_attn as msda
    from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, make_train_step
    from detr_tpu_torch.train.trainer import to_device

    config = DeformableDETRConfig()
    tc = TrainingConfig(train_batch_size=MSDA_B, cumulative_train_batch_size=8 * MSDA_B,
                        set_cost_class=2.0, label_ce_loss_coef=2.0)
    model = build_detector(config)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.cuda()
    opt, _ = build_optimizer(model, tc)
    state = TrainState(model, opt, torch.Generator().manual_seed(0))
    step = make_train_step(model, build_criterion(tc, config))
    batch = to_device(synthetic_batch(np.random.default_rng(3), MSDA_B, *MSDA_CANVAS,
                                      max_gt=tc.max_gt_boxes), torch.device("cuda"))
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    msda.launches = msda.launches_bwd = 0
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    got = dict(fwd=msda.launches, bwd=msda.launches_bwd, loss=loss)
    del state, step, opt, model
    if got["fwd"] != 12 or got["bwd"] != 12 or not np.isfinite(loss):
        raise AssertionError(f"deformable train micro-step: {got}, want 12 forward and 12 "
                             f"backward MSDA launches and a finite loss")
    return got


def phase_msda(smi: str) -> list[dict]:
    """Multi-scale deformable attention (``ops/ms_deform_attn.py``) at the
    deformable cell's shapes, bf16: the wrapper's forward and backward
    (autograd through ``ms_deform_attn``) against the plain ``grid_sample``
    version, at the encoder's and the decoder's query counts; kernel, plain
    and bound times (``benchmark.flops_deformable.msda_bounds``); then the
    launches of one main-path micro-step."""
    from benchmark.flops_deformable import msda_bounds
    from detr_tpu_torch.ops import ms_deform_attn as msda
    from detr_tpu_torch.ops.attention import BF16_MAX_SHARE, BF16_MAX_ULPS, bf16_agreement

    gen = torch.Generator(device="cuda").manual_seed(16)
    S = sum(h * w for h, w in MSDA_LEVELS)
    L = len(MSDA_LEVELS)
    rows = []
    for name, lq in (("encoder", S), ("decoder_cross", MSDA_QUERIES)):
        value, loc, attn = _msda_inputs(gen, MSDA_B, lq)
        leaves = [x.requires_grad_(True) for x in (value, loc, attn)]
        g = _rand(gen, (MSDA_B, lq, H, D), torch.bfloat16)
        out = msda.ms_deform_attn(value, MSDA_LEVELS, loc, attn)
        got = torch.autograd.grad(out, leaves, g)
        again = torch.autograd.grad(msda.ms_deform_attn(value, MSDA_LEVELS, loc, attn),
                                    leaves, g)
        ref = msda.ms_deform_attn_reference(value, MSDA_LEVELS, loc, attn)
        want = torch.autograd.grad(ref, leaves, g, retain_graph=True)  # timed below
        torch.cuda.synchronize()
        row = dict(shape=name, dtype="bfloat16", B=MSDA_B, Lq=lq, S=S, H=H, D=D, levels=L,
                   points=MSDA_POINTS, launches_per_step=6, card=smi)
        ok = True
        for key, a, b in (("out", out, ref), ("d_value", got[0], want[0])):
            row[f"{key}_max_ulps"], row[f"{key}_share_differing"] = bf16_agreement(a, b)
            ok = ok and row[f"{key}_max_ulps"] <= BF16_MAX_ULPS
            ok = ok and row[f"{key}_share_differing"] <= BF16_MAX_SHARE
        for key, a, b in (("d_loc", got[1], want[1]), ("d_weights", got[2], want[2])):
            err, scale = _rel_err(a, b)
            row[f"{key}_err_over_max"] = err / scale
            ok = ok and err <= TOL_MSDA_FP32 * scale
        row["same_bits_twice"] = torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
        if not (ok and row["same_bits_twice"]):
            raise AssertionError(f"MSDA kernels disagree with the plain version: {row}")
        fv, fl, fa = (x.detach() for x in leaves)
        row["fwd_ms"] = device_time_ms(lambda: msda.forward_cuda(fv, MSDA_LEVELS, fl, fa), 20)
        row["bwd_ms"] = device_time_ms(
            lambda: msda.backward_cuda(fv, MSDA_LEVELS, fl, fa, g), 20)
        row["fwd_plain_ms"] = device_time_ms(
            lambda: msda.ms_deform_attn_reference(fv, MSDA_LEVELS, fl, fa), 3)
        row["bwd_plain_ms"] = device_time_ms(
            lambda: torch.autograd.grad(ref, leaves, g, retain_graph=True), 3)
        fwd_s, bwd_s = msda_bounds(MSDA_B, lq, S, H, D, L, MSDA_POINTS, "bfloat16")
        row["fwd_bound_ms"], row["bwd_bound_ms"] = fwd_s * 1e3, bwd_s * 1e3
        log(f"msda kernel check: {json.dumps(row)}")
        rows.append(row)
        del value, loc, attn, leaves, out, got, again, ref, want, fv, fl, fa
        torch.cuda.empty_cache()
    launches = _msda_main_path()
    torch.cuda.empty_cache()
    log(f"msda main path (Deformable DETR train micro-step, B={MSDA_B} at "
        f"{MSDA_CANVAS[0]}x{MSDA_CANVAS[1]}): {json.dumps(launches)}")
    for row in rows:
        row["main_path_launches"] = launches
    return rows


def msda_kernels(msda_rows: list[dict], common: dict) -> list[dict]:
    """The ``kernels`` report's rows of the two MSDA kernels, from
    ``phase_msda``'s rows: per deformable training micro-step (6 launches
    of each shape), and per encoder call."""
    def msda_step(k):  # per deformable micro-step: 6 launches of each shape
        return sum(r[k] * r["launches_per_step"] for r in msda_rows)

    out = []
    for key, name, bf16_out, fp32_out in (
            ("fwd", "ms_deform_attn_fwd", "out", ()),
            ("bwd", "ms_deform_attn_bwd", "d_value", ("d_loc", "d_weights"))):
        out.append(dict(
            name=name, source=f"detr_tpu_torch/csrc/{name}.cu", replaces="none (new in the port)",
            launches_per_micro_step=msda_rows[0]["main_path_launches"][key],
            tolerance=f"{bf16_out}: {BF16_RULE}; d locations, d weights (fp32): "
                      f"{TOL_MSDA_FP32} of the largest",
            max_ulps=max(r[f"{bf16_out}_max_ulps"] for r in msda_rows),
            max_share_differing=max(r[f"{bf16_out}_share_differing"] for r in msda_rows),
            fp32_worst_err_over_max=max((r[f"{x}_err_over_max"] for r in msda_rows
                                         for x in fp32_out), default=None),
            same_bits_twice=all(r["same_bits_twice"] for r in msda_rows),
            ms=msda_step(f"{key}_ms"), plain_ms=msda_step(f"{key}_plain_ms"),
            bound_ms=msda_step(f"{key}_bound_ms"),
            encoder_call=dict(ms=msda_rows[0][f"{key}_ms"],
                              plain_ms=msda_rows[0][f"{key}_plain_ms"],
                              bound_ms=msda_rows[0][f"{key}_bound_ms"]),
            per=f"Deformable DETR training micro-step (B={MSDA_B}, {MSDA_CANVAS[0]}x"
                f"{MSDA_CANVAS[1]}, bf16, 6 encoder + 6 decoder calls); plain: grid_sample",
            shapes=msda_rows, **common))
    return out


def _hold_to_cpu(label: str, card: dict, cpu: dict, flips: dict) -> float:
    """Phase 8's rule on two loss dicts: each key of ``card`` within 1e-3
    of max(1, |the reference ``cpu``'s|), the argmax-based ones (by their
    name without the layer suffix) allowed ``flips`` more; returns the worst
    diff over its tolerance."""
    worst = 0.0
    for key, want in cpu.items():
        tol = 1e-3 * max(1.0, abs(want)) + flips.get(re.sub(r"_\d+$", "", key), 0.0)
        diff = abs(card[key] - want)
        worst = max(worst, diff / tol)
        if not diff <= tol:
            raise AssertionError(f"{label} {key}: card {card[key]} cpu {want}")
    return worst


def phase_train_step_card_vs_cpu() -> dict:
    """One full-width fp32 train step on the card and on the CPU from the
    same weights, with the card's assignment injected on both sides."""
    from detr_tpu_torch.config import DETRConfig, TrainingConfig
    from detr_tpu_torch.data.synthetic import synthetic_batch
    from detr_tpu_torch.models import DETR, calibrate_frozen_bn
    from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, make_train_step
    from detr_tpu_torch.train.trainer import to_device

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        config = DETRConfig(dtype="float32", hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
        tc = TrainingConfig(train_batch_size=2, cumulative_train_batch_size=2)
        batch = synthetic_batch(np.random.default_rng(0), 2, 832, 1344, max_gt=tc.max_gt_boxes,
                                learnable=True)
        cpu_b, card_b = to_device(batch, torch.device("cpu")), to_device(batch, torch.device("cuda"))
        model = DETR(config)
        model.reset_parameters(torch.Generator().manual_seed(0))
        calibrate_frozen_bn(model.backbone.backbone, cpu_b["image"])
        card = copy.deepcopy(model).cuda()
        criterion = build_criterion(tc, config)
        with torch.no_grad():
            out = card(card_b["image"], card_b["height"], card_b["width"])
            B, L, G = 2, config.num_decoder_layers, tc.max_gt_boxes
            qog = criterion.matcher(
                out["pred_logits"], out["pred_boxes"],
                card_b["class_idx"][:, None].expand(B, L, G),
                card_b["boxes_normalized"][:, None].expand(B, L, G, 4),
                card_b["gt_valid"][:, None].expand(B, L, G))
        results = {}
        for side, m, b in (("card", card, card_b), ("cpu", model, cpu_b)):
            fixed = dataclasses.replace(criterion, matcher=lambda *_a, q=qog.to(b["image"].device): q)
            opt, _ = build_optimizer(m, tc)
            state = TrainState(m, opt, torch.Generator().manual_seed(0))
            t0 = time.perf_counter()
            _, metrics = make_train_step(m, fixed)(state, b)
            results[side] = ({k: float(v) for k, v in metrics.items()},
                             time.perf_counter() - t0, opt.get_learning_rates())
        card_m, cpu_m = results["card"][0], results["cpu"][0]
        # Argmax-based entries may flip on a near-tie: allow one flip.
        flips = {"cardinality_error": 0.5, "class_error": 100.0 / max(1, int(batch["gt_valid"].sum())),
                 "diag_nonbg_frac": 1.0 / (B * config.num_object_queries)}
        worst = _hold_to_cpu("train step", card_m, cpu_m, flips)
        # The first AdamW step moves each element by about lr * sign(g): an
        # element whose gradient is at the noise floor (the key projection's
        # bias has an exactly zero gradient in exact arithmetic) may move the
        # other way on the other device, at most 2 lr apart.
        lrs = results["cpu"][2]
        n_all = n_flip = 0
        max_other = 0.0
        for (name, pc), pg in zip(model.named_parameters(), card.parameters()):
            lr = lrs["backbone" if name.startswith("backbone.") else "rest"]
            diff = (pg.detach().cpu() - pc.detach()).abs()
            if not bool((diff <= 2.002 * lr + 1e-6).all()):
                raise AssertionError(f"parameter {name} differs by {float(diff.max())}")
            flipped = diff > 1e-6
            n_all += diff.numel()
            n_flip += int(flipped.sum())
            max_other = max(max_other, float(diff[~flipped].max()) if (~flipped).any() else 0.0)
        report = dict(loss_card=card_m["loss"], loss_cpu=cpu_m["loss"],
                      grad_norm_card=card_m["grad_norm"], grad_norm_cpu=cpu_m["grad_norm"],
                      worst_key_diff_over_tolerance=worst,
                      params_moved_apart=n_flip, params=n_all,
                      max_diff_of_the_rest=max_other, card_step_s=results["card"][1],
                      cpu_step_s=results["cpu"][1], assignment_from="card")
        log(f"train step card vs cpu (fp32, TF32 off, dropout 0, B=2 832x1344): {json.dumps(report)}")
        if n_flip > 1e-3 * n_all:
            raise AssertionError("too many parameters moved apart after the update")
        return report
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def phase_tiny_train_card_vs_cpu() -> dict:
    """``--tiny``'s model (hidden 16, 2 heads: head size 8, which the
    attention kernels take zero-padded to 32), fp32 with dropout 0.1, TF32
    off: one train step on the card and on the CPU from the same weights and
    dropout seeds, the card's assignment injected on both sides; then the
    ``--tiny --synthetic`` CLI for two micro-steps on the card."""
    from detr_tpu_torch.config import DETRConfig, TrainingConfig
    from detr_tpu_torch.data.synthetic import synthetic_batch
    from detr_tpu_torch.matcher import auction as au
    from detr_tpu_torch.models import DETR
    from detr_tpu_torch.ops import masked_attention as ma
    from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, make_train_step
    from detr_tpu_torch.train import trainer
    from detr_tpu_torch.train.trainer import to_device

    tiny = DETRConfig(num_object_queries=8, num_encoder_layers=1, num_decoder_layers=2,
                      num_attention_heads=2, hidden_size=16, ffn_scale_factor=2, dtype="float32")
    tc = TrainingConfig(train_batch_size=2, cumulative_train_batch_size=2, max_gt_boxes=8)
    batch = synthetic_batch(np.random.default_rng(7), 2, 64, 64, max_gt=8, learnable=True)
    model = DETR(tiny)
    model.reset_parameters(torch.Generator().manual_seed(0))
    card = copy.deepcopy(model).cuda()
    card_b, cpu_b = to_device(batch, torch.device("cuda")), to_device(batch, torch.device("cpu"))
    criterion = build_criterion(tc, tiny)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            out = card(card_b["image"], card_b["height"], card_b["width"])
            qog = criterion.matcher(
                out["pred_logits"], out["pred_boxes"],
                card_b["class_idx"][:, None].expand(2, 2, 8),
                card_b["boxes_normalized"][:, None].expand(2, 2, 8, 4),
                card_b["gt_valid"][:, None].expand(2, 2, 8))
        results = {}
        for side, m, b in (("card", card, card_b), ("cpu", model, cpu_b)):
            fixed = dataclasses.replace(criterion, matcher=lambda *_a, q=qog.to(b["image"].device): q)
            opt, _ = build_optimizer(m, tc)
            counts = (ma.launches, ma.launches_bwd_dkv, ma.launches_bwd_dq)
            _, metrics = make_train_step(m, fixed)(
                TrainState(m, opt, torch.Generator().manual_seed(3)), b)
            results[side] = {k: float(v) for k, v in metrics.items()}
            launched = [a - c for a, c in zip((ma.launches, ma.launches_bwd_dkv,
                                                ma.launches_bwd_dq), counts)]
            if launched != ([5, 5, 5] if side == "card" else [0, 0, 0]):
                raise AssertionError(f"tiny step on the {side}: attention launches {launched}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    flips = {"cardinality_error": 0.5, "class_error": 100.0 / max(1, int(batch["gt_valid"].sum())),
             "diag_nonbg_frac": 1.0 / (2 * tiny.num_object_queries)}
    worst = _hold_to_cpu("tiny train step", results["card"], results["cpu"], flips)

    steps = []
    make = trainer.make_train_step

    def counted(model, crit, canvas_map=None, grid=None):
        step = make(model, crit, canvas_map, grid)

        def run(state, b):
            state, metrics = step(state, b)
            steps.append(torch.stack([v.float() for v in metrics.values()]))
            return state, metrics

        return run

    trainer.make_train_step = counted
    out = _scratch_dir("chip_smoke_tiny_")
    try:
        au.launches = ma.launches = 0
        trainer.main(["--tiny", "--synthetic", "--limit-train-iters", "2", "--epochs", "1",
                      "--train-batch-size", "2", "--limit-val-iters", "1",
                      "--output-dir", out])
    finally:
        trainer.make_train_step = make
        shutil.rmtree(out, ignore_errors=True)
    if len(steps) != 2 or not bool(torch.isfinite(torch.stack(steps)).all()):
        raise AssertionError(f"--tiny on the card: {len(steps)} micro-steps, or non-finite metrics")
    report = dict(loss_card=results["card"]["loss"], loss_cpu=results["cpu"]["loss"],
                  grad_norm_card=results["card"]["grad_norm"],
                  grad_norm_cpu=results["cpu"]["grad_norm"],
                  worst_key_diff_over_tolerance=worst, head_size=tiny.head_size,
                  cli_micro_steps=len(steps), cli_attention_launches=ma.launches,
                  cli_auction_launches=au.launches)
    log(f"tiny train step card vs cpu (fp32, TF32 off, dropout 0.1, D=8, B=2 64x64), "
        f"then --tiny --synthetic on the card: {json.dumps(report)}")
    # 5 attention launches per forward, one auction per matching: two
    # micro-steps, then one validation batch
    if ma.launches != 3 * 5 or au.launches != 3:
        raise AssertionError("the --tiny CLI run on the card did not go through the kernels")
    return report


def _counts() -> tuple[int, int, int, int]:
    from detr_tpu_torch.matcher import auction as au
    from detr_tpu_torch.ops import masked_attention as ma

    return ma.launches, ma.launches_bwd_dkv, ma.launches_bwd_dq, au.launches


def _reset_counts() -> None:
    from detr_tpu_torch.matcher import auction as au
    from detr_tpu_torch.ops import masked_attention as ma

    ma.launches = ma.launches_bwd_dkv = ma.launches_bwd_dq = au.launches = 0


def _host_normalize_check(batch: dict) -> dict:
    """The card's normalisation of a uint8 batch against the host's
    ``transforms.normalize`` of the same pixels: within 1e-6, and exactly 0
    outside each image."""
    from detr_tpu_torch.data.transforms import normalize
    from detr_tpu_torch.ops.image_norm import prepare_image

    got = prepare_image(batch["image"], batch["height"], batch["width"]).cpu().numpy()
    image = batch["image"].cpu().numpy()
    hs, ws = batch["height"].cpu().numpy(), batch["width"].cpu().numpy()
    err, pad_nonzero = 0.0, 0
    for b in range(len(image)):
        h, w = int(hs[b]), int(ws[b])
        want = normalize(image[b, :h, :w])
        err = max(err, float(np.abs(got[b, :h, :w] - want).max()))
        inside = np.zeros(got.shape[1:3], bool)
        inside[:h, :w] = True
        pad_nonzero += int(np.count_nonzero(got[b][~inside]))
    row = dict(max_abs_err=err, tolerance=1e-6, padding_nonzero=pad_nonzero,
               shape=list(image.shape), heights=hs.tolist(), widths=ws.tolist())
    if not (err <= 1e-6 and pad_nonzero == 0):
        raise AssertionError(f"card normalisation differs from the host's: {row}")
    return row


AP_KEYS = ("AP", "AP50", "AP75", "AP-small", "AP-medium", "AP-large")


def _watch_validation(validate, eval_step, *args, **kwargs) -> dict:
    """One ``run_validation`` with its launches, batches and wall time
    counted (synchronised at both ends); every validation batch must make
    18 forward launches, one auction (its loss's matching) and no backward,
    and the AP keys must be finite and in [0, 1], or -1 where the evaluator
    found no ground truth of a size."""
    sizes = []

    def counted(batch):
        sizes.append(int(batch["image"].shape[0]))
        return eval_step(batch)

    torch.cuda.synchronize()
    before = _counts()
    t0 = time.perf_counter()
    metrics = validate(counted, *args, **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = [a - b for a, b in zip(_counts(), before)]
    n = len(sizes)
    if launches != [18 * n, 0, 0, n] or n == 0:
        raise AssertionError(f"validation of {n} batches made launches {launches}, "
                             f"want [{18 * n}, 0, 0, {n}]")
    for key in AP_KEYS:
        v = metrics[key]
        if not (np.isfinite(v) and (0.0 <= v <= 1.0 or v == -1.0)):
            raise AssertionError(f"validation {key} = {v}")
    return dict(batch_sizes=sizes, launches=launches, seconds=seconds,
                metrics={k: metrics[k] for k in AP_KEYS}, metrics_all=metrics)


@contextlib.contextmanager
def _timed_grids(record: dict):
    """The validation image grids timed apart for the block, appended to
    ``record``: ``draw_s`` per grid drawn (``viz.plot_grid`` as the trainer
    calls it) and ``log_s`` per grid logged (``MetricLogger.log_image``:
    tensorboard's PNG encode, the event queued for its writer thread)."""
    from detr_tpu_torch.train import trainer
    from detr_tpu_torch.utils.logging import MetricLogger

    draw, log_image = trainer.plot_grid, MetricLogger.log_image
    record.setdefault("draw_s", [])
    record.setdefault("log_s", [])

    def timed(fn, key):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                record[key].append(time.perf_counter() - t0)

        return run

    trainer.plot_grid, MetricLogger.log_image = timed(draw, "draw_s"), timed(log_image, "log_s")
    try:
        yield record
    finally:
        trainer.plot_grid, MetricLogger.log_image = draw, log_image


def _source_prepare_check(batch: dict, canvas_map: dict) -> dict:
    """A device-resize batch prepared on the card against the same batch
    prepared on the CPU: within 1e-4 on the normalised image, exactly 0
    outside each image.  The process's fp32 matmul precision is set to
    "high" (TF32 on) around the card's call: the resample must not follow
    it, and must give the setting back."""
    from detr_tpu_torch.ops.image_norm import prepare_batch_image

    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = prepare_batch_image(batch, canvas_map)
        torch.cuda.synchronize()
        restored = torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(previous)
    want = prepare_batch_image({k: v.cpu() for k, v in batch.items()}, canvas_map)
    got = got.cpu()
    err = float((got - want).abs().max())
    hs, ws = batch["height"].cpu().tolist(), batch["width"].cpu().tolist()
    pad_nonzero = sum(int(torch.count_nonzero(got[b, h:])) + int(torch.count_nonzero(got[b, :, w:]))
                      for b, (h, w) in enumerate(zip(hs, ws)))
    row = dict(max_abs_err=err, tolerance=1e-4, padding_nonzero=pad_nonzero,
               matmul_precision_restored=restored, tf32_on_during_check=True,
               source_shape=list(batch["image"].shape), canvas=list(got.shape[1:3]),
               src_heights=batch["src_height"].cpu().tolist(),
               src_widths=batch["src_width"].cpu().tolist(), heights=hs, widths=ws)
    if not (err <= 1e-4 and pad_nonzero == 0 and restored):
        raise AssertionError(f"the card's device resize differs from the CPU's: {row}")
    return row


def _watched_train(config, synthetic: bool, smi: str, label: str,
                   keep: dict | None = None, detr_config=None, attention: list | None = None,
                   per_step: tuple = (18, 18, 18, 1), on_step=None) -> dict:
    """``train_DETR`` at full width (DETR-R50, bf16, dropout 0.1, or
    ``detr_config``) with every
    micro-step watched: launches (``per_step``), finite metrics, parameters
    changing at updates only, the batch's shape and its bytes; and the window of
    micro-steps 2-24 split into waiting for the next batch (the prefetch
    iterator's next()), the step (synchronised), the smoke's own checks, and
    the rest.  ``keep`` receives the first batch and the step's canvas map;
    ``attention``, when given, the (B, S, H) of every forward launch;
    ``on_step(i)`` runs after micro-step i's checks."""
    from detr_tpu_torch.config import DETRConfig
    from detr_tpu_torch.ops import masked_attention as ma
    from detr_tpu_torch.train import trainer

    k = config.gradient_accumulation_steps
    records, waits, first = [], [], {}
    make_step, prefetch = trainer.make_train_step, trainer.prefetch_to_device
    validate, validations = trainer.run_validation, []

    def watched_make_train_step(model, criterion, canvas_map=None, **kw):
        step = make_step(model, criterion, canvas_map, **kw)
        params = [p for p in model.parameters() if p.requires_grad]
        snap = [p.detach().clone() for p in params]

        def watched(state, batch):
            ta = time.perf_counter()
            torch.cuda.synchronize()  # the copies in flight are not the step's
            before = _counts()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            after = _counts()
            # One device-side reduction over every parameter and one read of
            # it together with the metrics.
            changed = torch.stack([torch.ne(a, p).any() for a, p in zip(snap, params)]).any()
            keys = list(metrics)
            host = torch.cat([torch.stack([metrics[key].float() for key in keys]),
                              changed.float()[None]]).cpu().numpy()
            if host[-1]:
                torch._foreach_copy_(snap, [p.detach() for p in params])
            if not records and "src_height" in batch:
                first["prepare_check"] = _source_prepare_check(batch, canvas_map)
                if keep is not None:
                    keep.update(batch={k: v.clone() for k, v in batch.items()},
                                canvas_map=canvas_map)
            elif not records and batch["image"].dtype == torch.uint8:
                first["normalize_check"] = _host_normalize_check(batch)
            values = dict(zip(keys, host[:-1].tolist()))
            t2 = time.perf_counter()
            records.append(dict(ms=(t1 - t0) * 1e3, start=t0, end=t1, pre_check_s=t0 - ta,
                                post_check_s=t2 - t1, shape=list(batch["image"].shape[1:3]),
                                dtype=str(batch["image"].dtype).replace("torch.", ""),
                                launches=[a - b for a, b in zip(after, before)],
                                h2d_bytes=sum(t.nbytes for t in batch.values()),
                                source_on_card=("src_height" in batch
                                                and batch["src_height"].is_cuda
                                                and batch["src_width"].is_cuda),
                                changed=bool(host[-1]), loss=values["loss"],
                                grad_norm=values["grad_norm"],
                                finite=bool(np.isfinite(host[:-1]).all())))
            if on_step is not None:
                on_step(len(records) - 1)
            return state, metrics

        return watched

    def timed_prefetch(*args, **kwargs):
        inner = prefetch(*args, **kwargs)

        def batches():
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        b = next(inner)
                    except StopIteration:
                        return
                    waits.append((t0, time.perf_counter()))
                    yield b
            finally:
                inner.close()

        return batches()

    def watched_validation(eval_step, *args, **kwargs):
        record = _watch_validation(validate, eval_step, *args, **kwargs)
        validations.append(record)
        return record.pop("metrics_all")

    forward = ma.forward_cuda

    def seen_forward(q, k, *args, **kwargs):
        attention.append((int(q.shape[0]), int(k.shape[1]), int(q.shape[2])))
        return forward(q, k, *args, **kwargs)

    trainer.make_train_step, trainer.prefetch_to_device = watched_make_train_step, timed_prefetch
    trainer.run_validation = watched_validation
    if attention is not None:
        ma.forward_cuda = seen_forward
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()  # the path starts
        t0 = time.perf_counter()
        trainer.train_DETR(config, detr_config or DETRConfig(), synthetic=synthetic)
        wall = time.perf_counter() - t0
        launches = _counts()  # and ends
    finally:
        trainer.make_train_step, trainer.prefetch_to_device = make_step, prefetch
        trainer.run_validation = validate
        ma.forward_cuda = forward

    n = config.limit_train_iters
    if len(records) != n:
        raise AssertionError(f"{label}: {len(records)} micro-steps instead of {n}")
    for i, r in enumerate(records):
        if r["launches"] != list(per_step):
            raise AssertionError(f"{label} micro-step {i}: launches {r['launches']}, "
                                 f"want {list(per_step)}")
        if not r["finite"]:
            raise AssertionError(f"{label} micro-step {i}: non-finite metrics")
        if r["changed"] != ((i + 1) % k == 0):
            raise AssertionError(f"{label} micro-step {i}: parameters changed={r['changed']}, "
                                 f"updates come every {k} micro-steps")
    if len(waits) < n:
        raise AssertionError(f"{label}: {len(waits)} batches through prefetch for {n} steps")
    if len(validations) != 1 or len(validations[0]["batch_sizes"]) != config.limit_val_iters:
        raise AssertionError(f"{label}: validations {validations}, want one of "
                             f"{config.limit_val_iters} batch")
    ms = np.array([r["ms"] for r in records[1:]])
    # End to end: every image of micro-steps 2-24 over the wall time from the
    # start of the second to the end of the last, the batches made between
    # them included.  The median step is the train step's own time.
    start, end = records[1]["start"], records[-1]["end"]
    window = end - start
    split = dict(
        waiting_for_batch_s=sum(b - a for a, b in waits if start <= a and b <= end),
        step_s=float(ms.sum()) / 1e3,
        smoke_checks_s=(sum(r["post_check_s"] for r in records[1:-1])
                        + sum(r["pre_check_s"] for r in records[2:])),
    )
    split["rest_s"] = window - sum(split.values())
    report = dict(card=smi, micro_steps=len(records), updates=len(records) // k,
                  micro_batch=config.train_batch_size,
                  shapes=sorted({tuple(r["shape"]) for r in records}),
                  shape_counts={f"{h}x{w}": sum(r["shape"] == [h, w] for r in records)
                                for h, w in sorted({tuple(r["shape"]) for r in records})},
                  image_dtype=records[0]["dtype"],
                  source_on_card=all(r["source_on_card"] for r in records),
                  h2d_bytes_per_micro_step=float(np.mean([r["h2d_bytes"] for r in records])),
                  prefetch_depth=config.prefetch_depth,
                  ms_per_micro_step_median=float(np.median(ms)),
                  ms_per_micro_step_first=records[0]["ms"],
                  ms_per_micro_step=[r["ms"] for r in records],
                  images_per_s=config.train_batch_size * (len(records) - 1) / window,
                  window_wall_s=window, window_split=split,
                  images_per_s_of_median_step=config.train_batch_size / (float(np.median(ms)) / 1e3),
                  max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                  train_DETR_wall_s=wall,
                  steps_wall_s=sum(r["ms"] for r in records) / 1e3,
                  launches=dict(zip(("fwd", "bwd_dkv", "bwd_dq", "auction"), launches)),
                  losses=[r["loss"] for r in records],
                  grad_norms=[r["grad_norm"] for r in records], validation=validations[0],
                  **first)
    log(f"{label}: {json.dumps(report)}")
    return report


def phase_train(smi: str) -> dict:
    """train_DETR at full width for 24 micro-steps (2 AdamW updates) on
    synthetic fp32 batches (832x1344), through the prefetch thread."""
    from detr_tpu_torch.config import TrainingConfig

    out = _scratch_dir("chip_smoke_train_")
    try:
        config = TrainingConfig(limit_train_iters=24, limit_val_iters=1, epochs=1, output_dir=out,
                                val_batch_size=VAL_BATCH)
        return _watched_train(config, True, smi, "train")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _loader_alone(config, workers: int, n_batches: int = 8) -> dict:
    """The training loader without a model: 2 * n_batches batches, the
    first n_batches (worker start-up, and the items the workers make ahead)
    timed apart from the last n_batches."""
    from detr_tpu_torch.train import trainer

    loader, val_loader, _, _ = trainer._make_loaders(config.replace(num_workers=workers),
                                                     synthetic=False)
    val_loader.close()
    try:
        t0 = time.perf_counter()
        it = iter(loader)
        next(it)
        t_first = time.perf_counter() - t0
        for _ in range(n_batches - 1):
            next(it)
        t1 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
        t2 = time.perf_counter()
        mode = "sync" if workers == 0 else ("process" if loader._pool is not None else "thread")
    finally:
        loader.close()
    return dict(num_workers=workers, mode=mode, first_batch_s=t_first,
                warmup_batches_s=t1 - t0, timed_batches=n_batches,
                images_per_s=config.train_batch_size * n_batches / (t2 - t1))


def _epoch_shapes(config) -> dict[str, int]:
    """Batches of each shape in one whole epoch of the training loader with
    no worker: seeded and in order, so the same on every run."""
    from detr_tpu_torch.train import trainer

    loader, val_loader, _, _ = trainer._make_loaders(config.replace(num_workers=0),
                                                     synthetic=False)
    val_loader.close()
    try:
        shapes = [tuple(b["image"].shape[1:3]) for b in loader]
    finally:
        loader.close()
    return {f"{h}x{w}": shapes.count((h, w)) for h, w in sorted(set(shapes))}


# Device-time groups of the trace: the port's attention kernels and its
# auction by kernel name, cuDNN's convolutions (forward, data and weight
# gradients: the backbone and the 1x1 projection) by the aten op that
# launched them, and the rest (cuBLAS GEMMs of the transformer, the
# criterion, the optimizer, elementwise work).
KERNEL_GROUPS = (
    ("attention", re.compile(r"fwd_(bf16|fp32)_kernel|bwd_dkv_|bwd_dq_")),
    ("auction", re.compile(r"auction")),
)
CONV_OPS = re.compile(r"conv")
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
# Profiler ranges of the trace: the traced window, each micro-step, and the
# parts of a micro-step that run on the main thread (_annotated_step; the
# backbone and the 42 hash dropouts lie inside the forward).  The backward
# runs on autograd's own thread: inside "micro_step", outside the parts.
PARTS = ("detr_forward", "backbone", "hash_dropout", "criterion", "optimizer")
RANGES = ("window", "micro_step") + PARTS


def _annotated_step(model, criterion, optimizer):
    """``make_train_step`` with a profiler range around each micro-step and
    around its forward, backbone, hash dropouts, criterion and optimizer
    update: hooks on this model's modules, wrappers of this criterion, of
    this optimizer's ``apply_gradients`` and of the step."""
    from detr_tpu_torch.models.transformer import HashDropout
    from detr_tpu_torch.train import make_train_step

    def ranged(name, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return run

    dropouts = [("hash_dropout", m) for m in model.modules() if isinstance(m, HashDropout)]
    for name, module in [("detr_forward", model), ("backbone", model.backbone)] + dropouts:
        open_ranges = []

        def enter(_m, _i, name=name, open_ranges=open_ranges):
            open_ranges.append(torch.profiler.record_function(name).__enter__())

        def leave(_m, _i, _o, open_ranges=open_ranges):
            open_ranges.pop().__exit__(None, None, None)

        module.register_forward_pre_hook(enter)
        module.register_forward_hook(leave)
    optimizer.apply_gradients = ranged("optimizer", optimizer.apply_gradients)
    return ranged("micro_step", make_train_step(model, ranged("criterion", criterion)))


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def analyse_profile(prof, micro_steps: int) -> dict:
    """What ``prof.events()`` holds of the "window" range: the card's busy
    time (the union of its kernels, copies and fills) over the window's host
    time; host waits and host-to-card copies per micro-step, and the waits
    that fall inside a micro-step, on any thread; device time by group, by
    part of the step (the kernels each op launched, for the ranges that hold
    the op's start) and by op; the top 10 kernels.  The kernels on the card
    in the window and those its ops launched differ by a little at its
    edges (``kernel_ms_device_minus_linked``)."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e.time_range for e in events
              if e.device_type == DeviceType.CPU and e.name == "window"]
    if len(window) != 1:
        raise AssertionError(f"the trace holds {len(window)} window ranges")
    w0, w1 = window[0].start, window[0].end
    events = [e for e in events if w0 <= e.time_range.start < w1]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise AssertionError("the trace holds no kernel: the profiler did not see the card")
    ranges = {name: [(e.time_range.start, e.time_range.end) for e in host if e.name == name]
              for name in RANGES[1:]}
    n = micro_steps
    if len(ranges["micro_step"]) != n or len(ranges["detr_forward"]) != n:
        raise AssertionError(f"{len(ranges['micro_step'])} step and "
                             f"{len(ranges['detr_forward'])} forward ranges for {n} micro-steps")

    def inside(t, name):
        return any(a <= t < b for a, b in ranges[name])

    parts = dict.fromkeys(PARTS + ("backward and the rest of the step", "outside the steps"), 0.0)
    part_kernels = dict.fromkeys(parts, 0)
    by_op: dict[str, float] = {}
    conv_us = 0.0
    for e in host:  # the kernels each host event launched
        launched = [k.duration for k in e.kernels
                    if k.name not in RANGES and not k.name.startswith(("Memcpy", "Memset"))]
        if not launched:
            continue
        us = sum(launched)
        by_op[e.name] = by_op.get(e.name, 0.0) + us
        conv_us += us if CONV_OPS.search(e.name) else 0.0
        t = e.time_range.start
        held = [p for p in PARTS if inside(t, p)] if inside(t, "micro_step") else []
        for p in held or ["backward and the rest of the step" if inside(t, "micro_step")
                          else "outside the steps"]:
            parts[p] += us
            part_kernels[p] += len(launched)
    total_us = sum(e.time_range.elapsed_us() for e in kernels)
    groups = {name: sum(e.time_range.elapsed_us() for e in kernels if rx.search(e.name))
              for name, rx in KERNEL_GROUPS}
    groups["convolution"] = conv_us
    groups["rest"] = total_us - sum(groups.values())
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    waits = [e for e in host if e.name in HOST_WAITS]
    wait_ops: dict[str, int] = {}
    for e in waits:
        op = e.cpu_parent.name if e.cpu_parent is not None else None
        wait_ops[str(op)] = wait_ops.get(str(op), 0) + 1
    htod = [e for e in device if e.name.startswith("Memcpy HtoD")]
    pageable = [e for e in htod if "Pageable" in e.name]
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in device)
    return dict(
        micro_steps=n,
        window_ms=(w1 - w0) / 1e3,
        device_busy_ms=busy_us / 1e3,
        idle_share=1.0 - busy_us / (w1 - w0),
        kernel_ms_per_micro_step=total_us / 1e3 / n,
        kernels_per_micro_step=len(kernels) / n,
        kernel_ms_device_minus_linked=(total_us - sum(by_op.values())) / 1e3,
        host_waits_per_micro_step={w: sum(e.name == w for e in waits) / n for w in HOST_WAITS},
        host_waits_by_op=wait_ops,
        host_waits_in_step=sum(inside(e.time_range.start, "micro_step") for e in waits),
        htod_copies_per_micro_step=len(htod) / n,
        htod_copies_pageable=len(pageable),
        host_ms_per_micro_step_by_part={
            name: sum(b - a for a, b in ranges[name]) / 1e3 / n for name in RANGES[1:]},
        device_ms_per_micro_step_by_group={g: t / 1e3 / n for g, t in groups.items()},
        device_ms_per_micro_step_by_part={p: t / 1e3 / n for p, t in parts.items()},
        kernels_per_micro_step_by_part={p: k / n for p, k in part_kernels.items()},
        top10_ops=[dict(op=o, ms_per_micro_step=t / 1e3 / n)
                   for o, t in sorted(by_op.items(), key=lambda kv: -kv[1])[:10]],
        top10_kernels=[dict(name=k[:120], calls=len(d), ms_per_micro_step=sum(d) / 1e3 / n)
                       for k, d in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]],
    )


def phase_trace(smi: str) -> dict:
    """A ``torch.profiler`` trace of 4 micro-steps of phase 9's
    configuration (R50, bf16, dropout 0.1, B=5 at 832x1344, synthetic
    batches made ahead of time and copied by the prefetch thread), after 2
    of warm-up and the same 4 unprofiled, with the trainer loop's one read
    of the previous loss per step.  No host wait may fall inside a
    micro-step (the hash dropout and the position encoding run in its
    forward), and no host-to-card copy may be from pageable memory."""
    from detr_tpu_torch.config import DETRConfig, TrainingConfig
    from detr_tpu_torch.data.prefetch import DevicePlacement, prefetch_to_device
    from detr_tpu_torch.data.synthetic import SyntheticCocoDataset
    from detr_tpu_torch.models import DETR, calibrate_frozen_bn
    from detr_tpu_torch.ops.image_norm import prepare_image
    from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer
    from detr_tpu_torch.train.trainer import BATCH_KEYS
    from detr_tpu_torch.utils.profiling import TRACE_FILE, trace

    config, detr_config = TrainingConfig(), DETRConfig()
    h, w = config.shape_buckets[0]
    host = list(SyntheticCocoDataset(config.train_batch_size, h, w, max_gt=config.max_gt_boxes,
                                     num_batches=6, seed=0, learnable=True))
    model = DETR(detr_config)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.cuda()
    placement = DevicePlacement("cuda", BATCH_KEYS)
    sample = placement(host[0])
    calibrate_frozen_bn(model.backbone.backbone,
                        prepare_image(sample["image"], sample["height"], sample["width"]))
    optimizer, _ = build_optimizer(model, config)
    state = TrainState(model, optimizer, torch.Generator().manual_seed(0))
    step = _annotated_step(model, build_criterion(config, detr_config), optimizer)

    def run(batches):
        nonlocal state
        pending = None
        for batch in prefetch_to_device(batches, placement.place, config.prefetch_depth,
                                        placement.take):
            state, metrics = step(state, batch)
            if pending is not None:  # the trainer loop's one read per step
                float(pending)
            pending = metrics["loss"]
        float(pending)
        torch.cuda.synchronize()

    logdir = _scratch_dir("chip_smoke_trace_")
    try:
        run(host[:2])
        t0 = time.perf_counter()
        run(host[2:])
        unprofiled = time.perf_counter() - t0
        t0 = time.perf_counter()
        with trace(logdir) as prof:
            with torch.profiler.record_function("window"):
                run(host[2:])
        wall = time.perf_counter() - t0
        report = analyse_profile(prof, 4)
        trace_bytes = os.path.getsize(os.path.join(logdir, TRACE_FILE))
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    # An estimate: the profiled window's device busy time over the wall time
    # of the same 4 micro-steps run just before without the profiler.
    report.update(card=smi, profiled_wall_s=wall, unprofiled_wall_s=unprofiled,
                  idle_share_unprofiled_estimate=1.0 - report["device_busy_ms"] / 1e3 / unprofiled,
                  trace_bytes=trace_bytes)
    log(f"trace (R50 bf16 dropout 0.1, B=5 832x1344, 4 micro-steps): {json.dumps(report)}")
    if report["host_waits_in_step"] or report["htod_copies_pageable"]:
        raise AssertionError("the step waits for the card, or the window copies from pageable "
                             f"host memory: {report['host_waits_in_step']} waits in the step, "
                             f"{report['htod_copies_pageable']} pageable copies")
    return report


def phase_checkpoint_serve(smi: str, root: str) -> dict:
    """Validate, checkpoint, restore and serve from the checkpoint, at full
    width on ``make_coco_data``'s JPEGs (the phase's main path: its kernel
    launches are counted from its start to its end)."""
    from PIL import Image

    from detr_tpu_torch.config import DETRConfig, TrainingConfig
    from detr_tpu_torch.data.coco import CocoDataset
    from detr_tpu_torch.eval.postprocess import postprocess_predictions
    from detr_tpu_torch.models import DETR
    from detr_tpu_torch.models.convert import load_reference_checkpoint, save_reference_checkpoint
    from detr_tpu_torch.serve import InferenceEngine
    from detr_tpu_torch.train import TrainState, build_optimizer, trainer
    from detr_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager, load_model_payload
    from detr_tpu_torch.utils.trees import assert_same_bits, tree_map

    def clone(t):
        return t.detach().clone()

    out = _scratch_dir("chip_smoke_ckpt_")
    val_ds = CocoDataset(root, "validation")
    num_classes = val_ds.num_classes
    config = TrainingConfig(coco_dataset_root=root, output_dir=out, epochs=1, eval_epochs=1,
                            checkpoint_epochs=1, checkpoint_total_limit=1,
                            limit_train_iters=TrainingConfig().gradient_accumulation_steps)
    saved, saves, validations, steps, grid_times = [], [], [], [], {}

    class RecordingManager(CheckpointManager):
        """Keeps a copy on the card of what each save is given."""

        def save(self, step, state, extra=None):
            torch.cuda.synchronize()
            saved.append(dict(model=tree_map(clone, state.model.state_dict()),
                              opt=tree_map(clone, state.optimizer.state_dict()),
                              rng=state.generator.get_state(), step=state.step))
            t0 = time.perf_counter()
            super().save(step, state, extra)
            saves.append(time.perf_counter() - t0)

    class TimedMetrics(trainer.DetectionMetrics):
        compute_s = []

        def compute(self):
            t0 = time.perf_counter()
            try:
                return super().compute()
            finally:
                TimedMetrics.compute_s.append(time.perf_counter() - t0)

    validate, make_step = trainer.run_validation, trainer.make_train_step

    def watched_validation(eval_step, *args, **kwargs):
        record = _watch_validation(validate, eval_step, *args, **kwargs)
        validations.append(record)
        return record.pop("metrics_all")

    def counted_make_train_step(model, criterion, canvas_map=None, grid=None):
        step = make_step(model, criterion, canvas_map, grid)

        def run(state, batch):
            state, metrics = step(state, batch)
            steps.append(metrics["loss"].detach())
            return state, metrics

        return run

    logs = []

    class Capture(logging.Handler):
        def emit(self, record):
            logs.append(record.getMessage())

    capture = Capture(logging.INFO)
    trainer_logger = logging.getLogger(trainer.__name__)
    old_level = trainer_logger.level
    trainer_logger.addHandler(capture)
    trainer_logger.setLevel(logging.INFO)
    patched = dict(CheckpointManager=RecordingManager, DetectionMetrics=TimedMetrics,
                   run_validation=watched_validation, make_train_step=counted_make_train_step)
    originals = {k: getattr(trainer, k) for k in patched}
    for k, v in patched.items():
        setattr(trainer, k, v)
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()  # the path starts
        t0 = time.perf_counter()
        with _timed_grids(grid_times):
            metrics = trainer.train_DETR(config, DETRConfig())
        first_wall = time.perf_counter() - t0
        mgr = CheckpointManager(out)
        if mgr.steps() != [0] or len(validations) != 1 or len(steps) != config.limit_train_iters:
            raise AssertionError(f"first run: checkpoints {mgr.steps()}, {len(validations)} "
                                 f"validations, {len(steps)} micro-steps")
        sizes = validations[0]["batch_sizes"]  # every batch full, the last of a bucket padded
        if sum(sizes) < len(val_ds) or any(b != config.val_batch_size for b in sizes):
            raise AssertionError(f"validation batches {sizes} for {len(val_ds)} images")
        if set(AP_KEYS) - set(metrics):
            raise AssertionError(f"train_DETR returned {sorted(metrics)}")
        ckpt_bytes = os.path.getsize(os.path.join(mgr.directory, "0", STATE_FILE))

        # restore into a fresh state on the card: the saved one, bit for bit
        model = DETR(DETRConfig(num_classes=num_classes)).cuda()
        optimizer, _ = build_optimizer(model, config)
        fresh = TrainState(model, optimizer, torch.Generator())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, extra = mgr.restore(fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want = saved[0]
        assert_same_bits(restored.model.state_dict(), want["model"], "model")
        assert_same_bits(restored.optimizer.state_dict(), want["opt"], "optimizer")
        assert_same_bits(restored.generator.get_state(), want["rng"], "generator")
        if restored.step != want["step"] or extra != {"epoch": 0}:
            raise AssertionError(f"restored step {restored.step}, extra {extra}")
        if want["opt"]["updates"] != 1:
            raise AssertionError(f"{want['opt']['updates']} AdamW updates in the first epoch")
        del fresh, restored, model, optimizer, saved[:]

        # a second run on the same output dir: auto-restore, epoch 1
        n_logs = len(logs)
        t0 = time.perf_counter()
        with _timed_grids(grid_times):
            trainer.train_DETR(config.replace(epochs=2), DETRConfig())
        second_wall = time.perf_counter() - t0
        said = logs[n_logs:]
        if not any("auto-restored checkpoint at epoch 0; resuming from epoch 1" in m
                   for m in said) or any(m.startswith("epoch 0 ") for m in said):
            raise AssertionError(f"second run did not resume at epoch 1: {said}")
        if len(steps) != 2 * config.limit_train_iters or not bool(
                torch.isfinite(torch.stack(steps)).all()):
            raise AssertionError(f"{len(steps)} micro-steps in all, or non-finite losses")
        if mgr.steps() != [1]:
            raise AssertionError(f"checkpoints kept {mgr.steps()}, limit 1")

        # serve from the checkpoint; hold it against the restored model
        engine = InferenceEngine(DETRConfig(num_classes=num_classes), checkpoint_dir=out)
        calls, model_inputs = [], []
        predict = engine._predict
        engine.model.register_forward_pre_hook(lambda _m, args: model_inputs.append(args))

        def recorded(*args):
            got = predict(*args)
            # the model's input (the source wire resamples in _predict) and
            # the original sizes
            calls.append((model_inputs[-1], args[3:5], got))
            return got

        engine._predict = recorded
        files = sorted(os.listdir(os.path.join(root, "validation", "data")))[:8]
        images = [np.asarray(Image.open(os.path.join(root, "validation", "data", f))
                             .convert("RGB")) for f in files]
        results = engine.predict(images)
        launches = _counts()  # the path ends
        steps_run, val_batches = len(steps), sum(len(v["batch_sizes"]) for v in validations)
        want_launches = [18 * (steps_run + val_batches + len(calls)), 18 * steps_run,
                         18 * steps_run, steps_run + val_batches]
        if list(launches) != want_launches:
            raise AssertionError(f"phase 11 launches {launches}, want {want_launches} "
                                 "(forward, dK/dV, dQ, auction)")
        reference = DETR(DETRConfig(num_classes=num_classes))
        load_model_payload(reference, mgr.restore_payload())
        reference.cuda().eval()
        for inputs, origs, got in calls:
            with torch.inference_mode():
                o = reference(*inputs)
                ref = postprocess_predictions(o["pred_logits"][:, -1], o["pred_boxes"][:, -1],
                                              *(torch.from_numpy(a).cuda() for a in origs))
            for k in ("scores", "labels", "boxes"):
                if not np.array_equal(got[k], ref[k].cpu().numpy()):
                    raise AssertionError(f"served {k} differs from the restored model's")
        if len(results) != 8 or not all(np.isfinite(r["boxes"]).all() for r in results):
            raise AssertionError("serving from the checkpoint gave bad results")

        # the reference model.safetensors round trip
        st = os.path.join(out, "model.safetensors")
        t0 = time.perf_counter()
        save_reference_checkpoint(st, reference)
        loaded = load_reference_checkpoint(st, DETRConfig(num_classes=num_classes))
        st_s = time.perf_counter() - t0
        assert_same_bits(loaded, {k: v.cpu() for k, v in reference.state_dict().items()},
                   "model.safetensors")
        st_bytes = os.path.getsize(st)
    finally:
        for k, v in originals.items():
            setattr(trainer, k, v)
        trainer_logger.removeHandler(capture)
        trainer_logger.setLevel(old_level)
        shutil.rmtree(out, ignore_errors=True)
    report = dict(
        card=smi, micro_steps_per_run=config.limit_train_iters, runs=2,
        first_run_wall_s=first_wall, second_run_wall_s=second_wall,
        checkpoint_save_s=saves, checkpoint_restore_s=restore_s, checkpoint_bytes=ckpt_bytes,
        validations=validations,
        validation_images=len(val_ds), validation_padding=sum(sizes) - len(val_ds),
        validation_images_per_s=[len(val_ds) / r["seconds"] for r in validations],
        # two grids drawn and logged per validation
        validation_grids_s=[sum(grid_times["draw_s"][2 * i:2 * i + 2])
                            + sum(grid_times["log_s"][2 * i:2 * i + 2])
                            for i in range(len(validations))],
        grids=grid_times,
        evaluator_host_s=TimedMetrics.compute_s,
        served_images=len(results), served_forwards=len(calls),
        reference_safetensors_bytes=st_bytes, reference_safetensors_roundtrip_s=st_s,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        launches=dict(zip(("fwd", "bwd_dkv", "bwd_dq", "auction"), launches)),
    )
    log(f"checkpoint, validate, restore, serve (R50 bf16, B=5, COCO-format): "
        f"{json.dumps(report)}")
    return report


def make_coco_data() -> tuple[str, float]:
    """Phases 10-11's data: 200 training and 60 validation JPEGs written by
    the port's ``make_synthetic_coco`` (seeds 0 and 1) under ``build/``;
    returns the root and the seconds it took.  The caller removes it."""
    from detr_tpu_torch.data.make_synthetic_coco import generate_split

    root = _scratch_dir("chip_smoke_coco_")
    t0 = time.perf_counter()
    generate_split(root, "train", 200, seed=0)
    generate_split(root, "validation", 60, seed=1)
    return root, time.perf_counter() - t0


def phase_train_coco(smi: str, root: str, t_gen: float) -> dict:
    """train_DETR at full width for 24 micro-steps on COCO-format JPEGs
    (``make_coco_data``): the training augmentation with photometric distort
    in 2 worker processes, the three default buckets, uint8 through the
    prefetch thread, normalised on the card, then one validation batch;
    then the loader alone at 0 and 2 workers."""
    from detr_tpu_torch.config import TrainingConfig

    out = _scratch_dir("chip_smoke_train_coco_")
    try:
        config = TrainingConfig(coco_dataset_root=root, limit_train_iters=24, limit_val_iters=1,
                                epochs=1, output_dir=out, val_batch_size=VAL_BATCH)
        if not (config.num_workers == 2 and config.prefetch_depth == 2 and
                config.device_normalize and config.photometric_distort):
            raise AssertionError(f"unexpected COCO path defaults: {config}")
        report = _watched_train(config, False, smi, "train_coco")
        # Which buckets the 24 batches fill depends on which worker takes
        # which image (each draws its own augmentation): every batch must be
        # one of the buckets, and one epoch of the seeded loader must fill
        # at least two.
        if not set(report["shapes"]) <= set(config.shape_buckets) or \
                report["image_dtype"] != "uint8":
            raise AssertionError(f"train_coco: shapes {report['shapes']} outside the buckets "
                                 f"{config.shape_buckets}, or image dtype {report['image_dtype']}")
        epoch_shapes = _epoch_shapes(config)
        if len(epoch_shapes) < 2 or \
                not {tuple(map(int, k.split("x"))) for k in epoch_shapes} <= set(config.shape_buckets):
            raise AssertionError(f"one epoch of the sync loader filled {epoch_shapes}, "
                                 f"want at least two of the buckets {config.shape_buckets}")
        loader_alone = [_loader_alone(config, w) for w in (0, 2)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    extra = dict(card=smi, generate_260_jpegs_s=t_gen, cpu_count=os.cpu_count(),
                 loader_alone=loader_alone, sync_epoch_shapes=epoch_shapes)
    log(f"train_coco loader: {json.dumps(extra)}")
    report.update(extra)
    return report


def _resize_bound(b: int, sh: int, sw: int, ch: int, cw: int) -> dict:
    """The least time of ``resize_on_device`` from a (b, sh, sw, 3) uint8
    source canvas onto (ch, cw): its two fp32 products (rows, then columns)
    at the fp32 peak, or its bytes (the uint8 in, the fp32 out, the four
    extents) at the memory rate, whichever is larger."""
    ops = 2 * b * ch * sh * sw * 3 + 2 * b * ch * cw * sw * 3
    nbytes = b * sh * sw * 3 + b * ch * cw * 3 * 4 + 4 * b * 4
    t_ops, t_bytes = ops / PEAK_OPS[torch.float32] * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(gflop=ops / 1e9, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _resize_times(keep: dict, shape_counts: dict) -> dict:
    """``resize_on_device``'s device time (CUDA events, back to back) on the
    first training batch, and on each source canvas at B=5 with random
    pixels over the full extents (the products do not depend on the
    pixels or the extents), each beside its bound; per micro-step, the
    canvases weighted by how many of the run's batches each filled.  And
    the step's first stage on the host clock for both wires."""
    from detr_tpu_torch.ops.device_resize import resize_on_device
    from detr_tpu_torch.ops.image_norm import prepare_batch_image

    batch, canvas_map = keep["batch"], keep["canvas_map"]
    b, sh, sw, _ = batch["image"].shape
    ch, cw = canvas_map[(sh, sw)]
    args = (batch["image"], batch["src_height"], batch["src_width"], batch["height"],
            batch["width"], (ch, cw))
    first = dict(source=[sh, sw], canvas=[ch, cw], ms=device_time_ms(
        lambda: resize_on_device(*args), 20), **_resize_bound(b, sh, sw, ch, cw))
    gen = torch.Generator(device="cuda").manual_seed(12)
    by_canvas = {}
    for (sh, sw), (ch, cw) in canvas_map.items():
        image = torch.randint(0, 256, (b, sh, sw, 3), dtype=torch.uint8, device="cuda",
                              generator=gen)
        ext = [torch.full((b,), v, dtype=torch.int32, device="cuda") for v in (sh, sw, ch, cw)]
        by_canvas[f"{sh}x{sw}"] = dict(canvas=[ch, cw], ms=device_time_ms(
            lambda: resize_on_device(image, *ext, (ch, cw)), 20), **_resize_bound(b, sh, sw, ch, cw))
    n = sum(shape_counts.values())
    per_step = {key: sum(by_canvas[s][key] * c for s, c in shape_counts.items()) / n
                for key in ("ms", "bound_ms", "gflop")}
    # The step's first stage on the host clock, synchronised: the source
    # batch resampled and normalised, against a uint8 batch of the target
    # canvas normalised (the target wire's stage).
    target = dict(image=torch.zeros((b, *canvas_map[(first["source"][0], first["source"][1])], 3),
                                    dtype=torch.uint8, device="cuda"),
                  height=batch["height"], width=batch["width"])

    def wall_ms(fn) -> float:
        times = []
        for _ in range(11):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))

    prepare = dict(source_wire_ms=wall_ms(lambda: prepare_batch_image(batch, canvas_map)),
                   target_wire_ms=wall_ms(lambda: prepare_batch_image(target)))
    return dict(first_batch=first, by_source_canvas=by_canvas, per_micro_step=per_step,
                fp32_peak_tflops=PEAK_OPS[torch.float32] / 1e12, prepare_wall=prepare)


def phase_train_source(smi: str, root: str, coco: dict) -> dict:
    """12a: ``train_DETR`` at full width for 24 micro-steps on the device-
    resize wire (phase 10's data, the default buckets and their source
    canvases, 2 workers, one validation batch), reported beside phase 10."""
    from detr_tpu_torch.config import TrainingConfig
    from detr_tpu_torch.data.bucketing import DEFAULT_SOURCE_BUCKETS

    out = _scratch_dir("chip_smoke_train_source_")
    keep: dict = {}
    try:
        config = TrainingConfig(coco_dataset_root=root, limit_train_iters=24, limit_val_iters=1,
                                epochs=1, output_dir=out, device_resize=True,
                                val_batch_size=VAL_BATCH)
        report = _watched_train(config, False, smi, "train_coco_source", keep)
        loader_alone = [_loader_alone(config, w) for w in (0, 2)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if not (set(report["shapes"]) <= set(DEFAULT_SOURCE_BUCKETS)
            and report["image_dtype"] == "uint8" and report["source_on_card"]
            and "prepare_check" in report):
        raise AssertionError(f"train_coco_source: shapes {report['shapes']} outside the source "
                             f"canvases {DEFAULT_SOURCE_BUCKETS}, or dtype "
                             f"{report['image_dtype']}, or no source extents on the card")
    ratio = coco["h2d_bytes_per_micro_step"] / report["h2d_bytes_per_micro_step"]
    if not ratio > 2.0:
        raise AssertionError(f"the source wire ships {report['h2d_bytes_per_micro_step']} bytes "
                             f"per micro-step, phase 10 {coco['h2d_bytes_per_micro_step']}")
    resize = _resize_times(keep, report["shape_counts"])
    beside = dict(card=smi, h2d_bytes_per_micro_step=report["h2d_bytes_per_micro_step"],
                  phase10_h2d_bytes_per_micro_step=coco["h2d_bytes_per_micro_step"],
                  h2d_ratio_phase10_over_source=ratio, loader_alone=loader_alone,
                  phase10_loader_alone=coco["loader_alone"],
                  images_per_s=report["images_per_s"],
                  phase10_images_per_s=coco["images_per_s"],
                  ms_per_micro_step_median=report["ms_per_micro_step_median"],
                  phase10_ms_per_micro_step_median=coco["ms_per_micro_step_median"],
                  resize_on_device=resize)
    log(f"train_coco_source beside phase 10: {json.dumps(beside)}")
    report.update(beside)
    return report


R101_FLAGS = ["--backbone", "resnet101", "--device-resize", "--bn-recalibrate-epochs", "1",
              "--shape-buckets", "640x1088,1088x640", "--val-min-size", "640", "--lr", "1e-4",
              "--lr-backbone", "1e-5", "--set-cost-class", "2", "--eos-coef", "0.2",
              "--gradient-max-norm", "0.5", "--dropout", "0.0", "--epochs", "2",
              "--eval-epochs", "1", "--limit-train-iters", "4", "--limit-val-iters", "1",
              "--train-batch-size", "4", "--cumulative-train-batch-size", "8",
              "--val-batch-size", "5"]


def phase_cli_r101(smi: str, root: str) -> dict:
    """12b: the trainer's CLI in this process, ``main(R101_FLAGS)`` on
    phase 10's data: DETR-R101 at full width, the device-resize wire at
    640x1088 / 1088x640 (source canvases 640x672, 672x640), the frozen-BN
    statistics recalibrated every epoch, 2 epochs of 4 micro-steps, each
    with a checkpoint and a validation batch at 640x1088."""
    from detr_tpu_torch.train import trainer
    from detr_tpu_torch.train.checkpoint import CheckpointManager
    from detr_tpu_torch.train.schedule import make_epoch_lr_schedule

    out = _scratch_dir("chip_smoke_r101_")
    argv = [*R101_FLAGS, "--coco-dataset-root", root, "--output-dir", out]
    config, _ = trainer.configs_from_args(trainer.get_args(argv))
    records, starts, evals, validations, logs = [], [], [], [], []
    make_train, make_eval, validate = (trainer.make_train_step, trainer.make_eval_step,
                                       trainer.run_validation)

    def watched_train(model, criterion, canvas_map=None, grid=None):
        step = make_train(model, criterion, canvas_map, grid)
        stats = [b for n, b in model.backbone.backbone.named_buffers()
                 if n.endswith(("running_mean", "running_var"))]

        def run(state, batch):
            if state.step % config.limit_train_iters == 0:  # an epoch's first micro-step
                starts.append(dict(stats=torch.cat([t.flatten() for t in stats]).clone(),
                                   lrs=state.optimizer.get_learning_rates()))
            torch.cuda.synchronize()
            before = _counts()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            records.append(dict(
                shape=tuple(batch["image"].shape[1:3]), canvas_map=canvas_map,
                launches=[a - b for a, b in zip(_counts(), before)],
                loss=float(metrics["loss"]), cost_class=criterion.matcher.cost_class,
                eos_coef=criterion.eos_coef, max_norm=state.optimizer.max_norm,
                dropout=(model.config.hidden_dropout_prob,
                         model.config.attention_probs_dropout_prob),
                backbone=model.config.backbone))
            return state, metrics

        return run

    def watched_eval(model, criterion, canvas_map=None, grid=None):
        step = make_eval(model, criterion, canvas_map, grid)

        def run(batch):
            evals.append((tuple(batch["image"].shape[1:3]), canvas_map))
            return step(batch)

        return run

    def watched_validation(eval_step, *args, **kwargs):
        record = _watch_validation(validate, eval_step, *args, **kwargs)
        validations.append(record)
        return record.pop("metrics_all")

    class Capture(logging.Handler):
        def emit(self, record):
            logs.append(record.getMessage())

    capture = Capture(logging.INFO)
    trainer_logger = logging.getLogger(trainer.__name__)
    trainer_logger.addHandler(capture)
    trainer.make_train_step, trainer.make_eval_step = watched_train, watched_eval
    trainer.run_validation = watched_validation
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()  # the path starts
        t0 = time.perf_counter()
        if trainer.main(argv) != 0:
            raise AssertionError("main() did not return 0")
        wall = time.perf_counter() - t0
        launches = _counts()  # and ends
        checkpoints = CheckpointManager(out).steps()
    finally:
        trainer.make_train_step, trainer.make_eval_step = make_train, make_eval
        trainer.run_validation = validate
        trainer_logger.removeHandler(capture)
        shutil.rmtree(out, ignore_errors=True)

    sources = {(640, 672): (640, 1088), (672, 640): (1088, 640)}
    n, k = len(records), config.limit_train_iters
    problems = []
    if n != 2 * k or any(r["launches"] != [18, 18, 18, 1] for r in records):
        problems.append(f"{n} micro-steps, launches {[r['launches'] for r in records]}")
    if not all(np.isfinite(r["loss"]) for r in records):
        problems.append("non-finite losses")
    if any(r["shape"] not in sources or r["canvas_map"] != sources for r in records):
        problems.append(f"train batches {sorted({r['shape'] for r in records})}")
    if len(evals) != 2 or any(s not in sources or m != sources for s, m in evals):
        problems.append(f"validation batches {evals}")
    if len(validations) != 2:
        problems.append(f"{len(validations)} validations")
    if checkpoints != [0, 1]:
        problems.append(f"checkpoints {checkpoints}")
    recal = [m for m in logs if m.startswith("recalibrated frozen-BN statistics")]
    if len(starts) != 2 or torch.equal(starts[0]["stats"], starts[1]["stats"]) or len(recal) != 2:
        problems.append(f"recalibrations {recal}, {len(starts)} epoch starts")
    schedules = {g: make_epoch_lr_schedule(base, epochs=config.epochs,
                                           warmup_epochs=config.lr_warmup_epochs,
                                           warmup_decay=config.lr_warmup_decay,
                                           hold_epochs=config.lr_hold_max_epochs,
                                           lr_min=config.lr_min)
                 for g, base in (("backbone", 1e-5), ("rest", 1e-4))}
    want_lrs = [{g: s(e) for g, s in schedules.items()} for e in range(2)]
    if [s["lrs"] for s in starts] != want_lrs:
        problems.append(f"learning rates {[s['lrs'] for s in starts]}, want {want_lrs}")
    if any((r["cost_class"], r["eos_coef"], r["max_norm"], r["dropout"], r["backbone"])
           != (2.0, 0.2, 0.5, (0.0, 0.0), "resnet101") for r in records):
        problems.append("coefficients, clip, dropout or backbone not the flags'")
    steps_run, val_batches = n, sum(len(v["batch_sizes"]) for v in validations)
    want_launches = [18 * (steps_run + val_batches), 18 * steps_run, 18 * steps_run,
                     steps_run + val_batches]
    if list(launches) != want_launches:
        problems.append(f"launches {launches}, want {want_launches}")
    if problems:
        raise AssertionError(f"12b (the CLI on R101): {problems}")
    report = dict(card=smi, argv=R101_FLAGS, wall_s=wall, micro_steps=n,
                  train_shapes=sorted({r["shape"] for r in records}),
                  eval_canvas=[640, 1088], validations=[v["metrics"] for v in validations],
                  recalibrations=recal, learning_rates=want_lrs,
                  losses=[r["loss"] for r in records], checkpoints=checkpoints,
                  max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                  launches=dict(zip(("fwd", "bwd_dkv", "bwd_dq", "auction"), launches)))
    log(f"cli_r101 (DETR-R101, device resize, recalibration, 640 validation): "
        f"{json.dumps(report)}")
    return report


# ---------------------------------------------------------------------------
# Phase 13: DC5 trained, two ranks sharing the card, NCCL at world size 1,
# entry(), and serving DC5 and R101.

DC5_SHAPE = (800, 1344)  # B=2: the encoder's S = 50 x 84 = 4200 at stride 16
RANKS_SHAPE = (640, 640)  # 13b's parity batch


def phase_dc5_train(smi: str) -> dict:
    """13a. ``train_DETR`` with ``DETRConfig(dilation=True)`` at full width
    (R50, bf16, dropout 0.1), B=2 at 800x1344 on synthetic data: 8
    micro-steps (an AdamW update every 4), the epoch's checkpoint and one
    validation batch of 2, every check of phase 9, and every attention launch
    of the path recorded: 12 of each forward's 18 at S=4200 (the encoder's
    self-attention and the decoder's cross-attention), B=2, 8 heads."""
    from detr_tpu_torch.config import DETRConfig, TrainingConfig
    from detr_tpu_torch.train.checkpoint import CheckpointManager

    out = _scratch_dir("chip_smoke_dc5_")
    seen: list = []
    try:
        config = TrainingConfig(limit_train_iters=8, limit_val_iters=1, epochs=1, output_dir=out,
                                train_batch_size=2, cumulative_train_batch_size=8,
                                val_batch_size=2, shape_buckets=(DC5_SHAPE,),
                                eval_shape=DC5_SHAPE)
        report = _watched_train(config, True, smi, "dc5_train",
                                detr_config=DETRConfig(dilation=True), attention=seen)
        checkpoints = CheckpointManager(out).steps()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    forwards = config.limit_train_iters + config.limit_val_iters
    at_4200 = sum(1 for b, s, h in seen if (b, s, h) == (2, DC5_TOKENS, H))
    if at_4200 != 12 * forwards or len(seen) != 18 * forwards:
        raise AssertionError(f"dc5: {at_4200} of {len(seen)} attention launches at S={DC5_TOKENS}, "
                             f"want {12 * forwards} of {18 * forwards}")
    if checkpoints != [0]:
        raise AssertionError(f"dc5: checkpoints {checkpoints}, want [0]")
    summary = dict(card=smi, images_per_s=report["images_per_s"],
                   ms_per_micro_step_median=report["ms_per_micro_step_median"],
                   max_memory_allocated_bytes=report["max_memory_allocated_bytes"],
                   attention_launches_at_S4200=at_4200,
                   attention_S=sorted({s for _, s, _ in seen}), checkpoints=checkpoints,
                   activation_checkpointing="none: B=2 at 800x1344 fits",
                   losses=report["losses"], launches=report["launches"])
    log(f"dc5_train summary: {json.dumps(summary)}")
    return report


def _replicas_sha(model) -> str:
    """A digest of a model's replicated parameters (every parameter that
    ``parallel.tp.param_specs`` does not split), equal on every rank that
    holds the same replicas."""
    import hashlib

    from detr_tpu_torch.parallel import param_specs

    named = list(model.named_parameters())
    specs = param_specs(n for n, _ in named)
    flat = torch.cat([p.detach().reshape(-1) for n, p in named if specs[n] is None])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def _rank_parity_and_train(rank: int, spec: dict) -> dict:
    """One of two ranks sharing the card (gloo): for tp=2, then dp=2, one
    fp32 train step (TF32 off, dropout 0) from the spec's weights on the
    rank's block of the spec's batch with its assignment injected; then the
    same two layouts through ``train_DETR`` in bf16 with dropout 0.1 for 4
    synthetic micro-steps, a checkpoint and one validation batch, every
    micro-step's launches and every forward launch's (B, S, heads) recorded."""
    import torch.distributed as dist

    from detr_tpu_torch.config import DETRConfig, TrainingConfig
    from detr_tpu_torch.models import DETR
    from detr_tpu_torch.ops import masked_attention as ma
    from detr_tpu_torch.parallel import (make_mesh, make_mesh_2d, shard_batch, shard_state_tp,
                                         tensor_parallel)
    from detr_tpu_torch.parallel.distributed import local_device
    from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, trainer
    from detr_tpu_torch.train.checkpoint import model_params

    device = local_device()
    out = dict(backend=dist.get_backend(), device=str(device))
    weights = torch.load(spec["weights"], map_location="cpu", weights_only=True)
    config = DETRConfig(dtype="float32", hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    tc = TrainingConfig(train_batch_size=2, cumulative_train_batch_size=2)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for layout, tp in (("tp2", 2), ("dp2", 1)):
            grid = make_mesh_2d(0, tp) if tp > 1 else make_mesh(0)
            model = DETR(config, tensor_parallel(grid))
            model.load_state_dict(shard_state_tp(weights, tensor_parallel(grid)))
            model.to(device)
            opt, _ = build_optimizer(model, tc)
            state = TrainState(model, opt, torch.Generator().manual_seed(0))
            block, lo = shard_batch(spec["batch"], grid)
            qog = torch.from_numpy(spec["qog"][lo:lo + len(block["image"])]).to(device)
            crit = dataclasses.replace(build_criterion(tc, config), matcher=lambda *_a: qog)
            step = trainer.make_train_step(model, crit, grid=grid)
            _reset_counts()
            _, metrics = step(state, trainer.to_device(block, device))
            torch.cuda.synchronize()
            row = dict(metrics={k: float(v) for k, v in metrics.items()}, launches=list(_counts()),
                       query_proj=list(model.encoder.layers[0].self_attention.query_proj
                                       .weight.shape), lrs=opt.get_learning_rates(),
                       replicas=_replicas_sha(model))
            params = model_params(model)  # a collective: every rank gathers
            if rank == 0:
                row["params"] = {k: v.detach().cpu() for k, v in params.items()}
            out[f"parity_{layout}"] = row
            del model, opt, state, params
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    make, forward = trainer.make_train_step, ma.forward_cuda
    for layout, tp in (("tp2", 2), ("dp2", 1)):
        steps, heads, models = [], [], []

        def counted(model, criterion, canvas_map=None, **kw):
            inner = make(model, criterion, canvas_map, **kw)
            models.append(model)

            def run(state, batch):
                torch.cuda.synchronize()
                before = _counts()
                state, metrics = inner(state, batch)
                torch.cuda.synchronize()
                steps.append(dict(launches=[a - b for a, b in zip(_counts(), before)],
                                  loss=float(metrics["loss"]),
                                  finite=bool(torch.isfinite(torch.stack(
                                      [v.float() for v in metrics.values()])).all())))
                return state, metrics

            return run

        def seen(q, k, *args, **kwargs):
            heads.append(int(q.shape[2]))
            return forward(q, k, *args, **kwargs)

        trainer.make_train_step, ma.forward_cuda = counted, seen
        try:
            _reset_counts()
            t0 = time.perf_counter()
            metrics = trainer.train_DETR(
                TrainingConfig(output_dir=os.path.join(spec["out"], layout), limit_train_iters=4,
                               epochs=1, limit_val_iters=1, train_batch_size=2,
                               cumulative_train_batch_size=4, val_batch_size=2,
                               model_parallel=tp),
                DETRConfig(), synthetic=True)
            wall = time.perf_counter() - t0
        finally:
            trainer.make_train_step, ma.forward_cuda = make, forward
        out[f"train_{layout}"] = dict(steps=steps, heads=sorted(set(heads)),
                                      launches=list(_counts()), wall_s=wall,
                                      replicas=_replicas_sha(models[0]),
                                      returned_metrics=bool(metrics),
                                      max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    return out


def _rank_nccl_probe(rank: int, spec: dict) -> dict:
    """One all-reduce over NCCL between two ranks on one card."""
    import torch.distributed as dist

    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return dict(sum=float(x[0]))


def phase_two_ranks(smi: str) -> dict:
    """13b. Two processes on the one card over gloo (NCCL refuses two ranks
    on one device, "invalid usage": checked here, the error logged).  fp32 parity: the
    one-process step on the card against tp=2 and dp=2 on the same global
    batch (B=2 at 640x640, the card's assignment injected on every side);
    the loss dict and grad_norm within 1e-3 of each value (one argmax flip
    allowed), every parameter after the AdamW update within 2 lr + 1e-6 of
    the one-process one and at most 0.1 % of them moved apart (phase 8's
    rule), the same metrics on both ranks.  Then bf16 ``train_DETR`` with
    dropout 0.1, 4 micro-steps per layout: finite losses, and per rank and
    micro-step 18 forward, 18 + 18 backward and 1 auction launch, at 4 heads
    under tp=2 and 8 under dp=2.  After each run the replicated parameters
    are the same bits on both ranks."""
    from detr_tpu_torch.config import DETRConfig, TrainingConfig
    from detr_tpu_torch.data.synthetic import synthetic_batch
    from detr_tpu_torch.models import DETR, calibrate_frozen_bn
    from detr_tpu_torch.parallel.launch import spawn
    from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, make_train_step
    from detr_tpu_torch.train.trainer import to_device

    out_dir = _scratch_dir("chip_smoke_ranks_")
    try:
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            config = DETRConfig(dtype="float32", hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0)
            tc = TrainingConfig(train_batch_size=2, cumulative_train_batch_size=2)
            batch = synthetic_batch(np.random.default_rng(5), 2, *RANKS_SHAPE,
                                    max_gt=tc.max_gt_boxes, learnable=True)
            card_b = to_device(batch, torch.device("cuda"))
            model = DETR(config)
            model.reset_parameters(torch.Generator().manual_seed(0))
            model.cuda()
            calibrate_frozen_bn(model.backbone.backbone, card_b["image"])
            weights = os.path.join(out_dir, "weights.pt")
            torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, weights)
            criterion = build_criterion(tc, config)
            with torch.no_grad():
                o = model(card_b["image"], card_b["height"], card_b["width"])
                L, G = config.num_decoder_layers, tc.max_gt_boxes
                qog = criterion.matcher(
                    o["pred_logits"], o["pred_boxes"],
                    card_b["class_idx"][:, None].expand(2, L, G),
                    card_b["boxes_normalized"][:, None].expand(2, L, G, 4),
                    card_b["gt_valid"][:, None].expand(2, L, G))
            fixed = dataclasses.replace(criterion, matcher=lambda *_a: qog)
            opt, _ = build_optimizer(model, tc)
            _, metrics = make_train_step(model, fixed)(
                TrainState(model, opt, torch.Generator().manual_seed(0)), card_b)
            one = {k: float(v) for k, v in metrics.items()}
            one_params = {k: v.detach().cpu() for k, v in model.named_parameters()}
            lrs = opt.get_learning_rates()
            del model, opt
            torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

        # NCCL refuses two ranks on one device, which is why these ranks run
        # over gloo: the refusal is expected, as an error and not a hang.
        try:
            probe = spawn(_rank_nccl_probe, 2, args=({},), backend="nccl", timeout=90.0)
        except RuntimeError as e:
            lines = [ln for ln in str(e).splitlines() if "rror" in ln]
            nccl = dict(outcome="refused", error=lines[-3:])
        else:
            raise AssertionError(f"NCCL took two ranks on one card: {probe}")
        if not any("invalid usage" in ln for ln in nccl["error"]):
            raise AssertionError(f"NCCL refused two ranks on one card otherwise: {nccl}")
        log(f"two ranks on one card over NCCL: {json.dumps(nccl)}")

        t0 = time.perf_counter()
        spec = dict(weights=weights, batch=batch, qog=qog.cpu().numpy(), out=out_dir)
        ranks = spawn(_rank_parity_and_train, 2, args=(spec,), backend="gloo", timeout=300.0,
                      threads=None)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    flips = {"cardinality_error": 0.5, "class_error": 100.0 / max(1, int(batch["gt_valid"].sum())),
             "diag_nonbg_frac": 1.0 / (2 * config.num_object_queries)}
    report = dict(card=smi, backend=[r["backend"] for r in ranks],
                  devices=[r["device"] for r in ranks], nccl_two_ranks_one_card=nccl,
                  spawn_wall_s=wall, layouts={})
    for layout in ("tp2", "dp2"):
        rows = [r[f"parity_{layout}"] for r in ranks]
        trains = [r[f"train_{layout}"] for r in ranks]
        if rows[0]["metrics"] != rows[1]["metrics"]:
            raise AssertionError(f"{layout}: the two ranks report different global metrics: "
                                 f"{rows[0]['metrics']} {rows[1]['metrics']}")
        # the replicated parameters stay one value on both ranks, bit for bit
        if rows[0]["replicas"] != rows[1]["replicas"] or trains[0]["replicas"] != trains[1]["replicas"]:
            raise AssertionError(f"{layout}: the ranks' replicated parameters differ")
        worst = _hold_to_cpu(f"{layout} (ranks against one process)", rows[0]["metrics"], one,
                             flips)
        n_all = n_flip = 0
        for name, want in one_params.items():
            got = torch.from_numpy(rows[0]["params"][name])
            lr = lrs["backbone" if name.startswith("backbone.") else "rest"]
            diff = (got - want).abs()
            if not bool((diff <= 2.002 * lr + 1e-6).all()):
                raise AssertionError(f"{layout}: parameter {name} differs by {float(diff.max())}")
            n_all += diff.numel()
            n_flip += int((diff > 1e-6).sum())
        if n_flip > 1e-3 * n_all:
            raise AssertionError(f"{layout}: {n_flip} of {n_all} parameters moved apart")
        want_q = [256 // 2, 256] if layout == "tp2" else [256, 256]
        for r in rows:  # the assignment is injected: no auction
            if r["launches"] != [18, 18, 18, 0] or r["query_proj"] != want_q:
                raise AssertionError(f"{layout} parity step: launches {r['launches']}, "
                                     f"query_proj {r['query_proj']}")
        heads = 4 if layout == "tp2" else 8
        for rank, tr in enumerate(trains):
            if len(tr["steps"]) != 4 or tr["heads"] != [heads]:
                raise AssertionError(f"{layout} rank {rank}: {len(tr['steps'])} micro-steps, "
                                     f"heads {tr['heads']}, want 4 at {heads}")
            for s in tr["steps"]:
                if s["launches"] != [18, 18, 18, 1] or not s["finite"]:
                    raise AssertionError(f"{layout} rank {rank} micro-step: {s}")
        if not trains[0]["returned_metrics"] or trains[1]["returned_metrics"]:
            raise AssertionError(f"{layout}: rank 0 must return the metrics, rank 1 {{}}")
        report["layouts"][layout] = dict(
            loss_one=one["loss"], loss_ranks=rows[0]["metrics"]["loss"],
            grad_norm_one=one["grad_norm"], grad_norm_ranks=rows[0]["metrics"]["grad_norm"],
            worst_key_diff_over_tolerance=worst, params_moved_apart=n_flip, params=n_all,
            bf16_losses=[s["loss"] for s in trains[0]["steps"]], heads=heads,
            launches_per_rank=[tr["launches"] for tr in trains],
            train_DETR_wall_s=[tr["wall_s"] for tr in trains],
            max_memory_allocated_bytes=[tr["max_memory_allocated_bytes"] for tr in trains])
    total = [sum(r[f"parity_{lay}"]["launches"][i] + r[f"train_{lay}"]["launches"][i]
                 for r in ranks for lay in ("tp2", "dp2")) for i in range(4)]
    report["launches"] = dict(zip(("fwd", "bwd_dkv", "bwd_dq", "auction"), total))
    log(f"two ranks on one card: {json.dumps(report)}")
    return report


def _rank_cli(rank: int, spec: dict) -> dict:
    """``trainer.main(spec["argv"])`` in this rank, its micro-steps' launches
    counted, under the process group it was started in."""
    import torch.distributed as dist

    from detr_tpu_torch.train import trainer

    backend, world = dist.get_backend(), dist.get_world_size()
    steps, make = [], trainer.make_train_step

    def counted(model, criterion, canvas_map=None, **kw):
        inner = make(model, criterion, canvas_map, **kw)

        def run(state, batch):
            torch.cuda.synchronize()
            before = _counts()
            state, metrics = inner(state, batch)
            torch.cuda.synchronize()
            steps.append(dict(launches=[a - b for a, b in zip(_counts(), before)],
                              loss=float(metrics["loss"]), grid="grid" in kw))
            return state, metrics

        return run

    trainer.make_train_step = counted
    try:
        _reset_counts()
        code = trainer.main(spec["argv"])
    finally:
        trainer.make_train_step = make
    return dict(backend=backend, world=world, code=code, steps=steps, launches=list(_counts()))


def phase_cli_nccl(smi: str) -> dict:
    """13c. The CLI, ``main([... "--num-devices", "1", "--model-parallel",
    "1"])``, in a process of its own under an NCCL process group of one
    rank (torchrun's variables): DETR-R50 at full width, 2 synthetic
    micro-steps through the grid's collectives, a checkpoint and one
    validation batch; then ``entry()`` on the card."""
    from detr_tpu_torch.entry import entry
    from detr_tpu_torch.parallel.launch import spawn

    out = _scratch_dir("chip_smoke_nccl_")
    try:
        argv = ["--synthetic", "--limit-train-iters", "2", "--epochs", "1",
                "--train-batch-size", "2", "--cumulative-train-batch-size", "2",
                "--limit-val-iters", "1", "--val-batch-size", "2", "--output-dir", out,
                "--num-devices", "1", "--model-parallel", "1"]
        t0 = time.perf_counter()
        (cli,) = spawn(_rank_cli, 1, args=(dict(argv=argv),), backend="nccl", timeout=240.0,
                       threads=None)
        cli["wall_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if (cli["backend"], cli["world"], cli["code"]) != ("nccl", 1, 0) or len(cli["steps"]) != 2:
        raise AssertionError(f"the CLI under NCCL: {cli}")
    for s in cli["steps"]:
        if s["launches"] != [18, 18, 18, 1] or not np.isfinite(s["loss"]) or not s["grid"]:
            raise AssertionError(f"the CLI under NCCL, micro-step {s}")
    if cli["launches"] != [2 * 18 + 18, 2 * 18, 2 * 18, 2 + 1]:
        raise AssertionError(f"the CLI under NCCL made launches {cli['launches']}")

    _reset_counts()
    fn, args = entry()
    t0 = time.perf_counter()
    outputs = fn(*args)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    entry_launches = list(_counts())

    shapes = {k: list(v.shape) for k, v in outputs.items()}
    if (shapes != {"pred_logits": [1, 6, 100, 81], "pred_boxes": [1, 6, 100, 4]}
            or not all(bool(torch.isfinite(v).all()) for v in outputs.values())
            or entry_launches != [18, 0, 0, 0]):
        raise AssertionError(f"entry(): shapes {shapes}, launches {entry_launches}")
    report = dict(card=smi, cli=cli, entry=dict(shapes=shapes, launches=entry_launches,
                                                seconds=entry_s))
    log(f"cli under nccl and entry(): {json.dumps(report)}")
    report["launches"] = dict(zip(("fwd", "bwd_dkv", "bwd_dq", "auction"),
                                  [a + b for a, b in zip(cli["launches"], entry_launches)]))
    return report


def phase_serve_variants(smi: str) -> dict:
    """13d. ``InferenceEngine`` with DETR-DC5 and with DETR-R101 (bf16,
    batch 8, 800x1344 and 1344x800): warmup, 4 batch-1 requests and one
    request of 8 mixed sizes (a forward per bucket it fills), every box of every query finite and inside its image
    (threshold 0), 18 forward launches per forward."""
    from detr_tpu_torch.config import DETRConfig
    from detr_tpu_torch.serve import InferenceEngine

    rng = np.random.default_rng(7)
    out = {}
    for name, config in (("dc5", DETRConfig(dilation=True)),
                         ("r101", DETRConfig(backbone="resnet101"))):
        engine = InferenceEngine(config, batch_size=8, score_threshold=0.0)
        engine.warmup()
        forwards = [0]
        engine.model.register_forward_hook(lambda *_a: forwards.__setitem__(0, forwards[0] + 1))
        imgs = [rng.integers(0, 256, SERVE_SIZES[i % len(SERVE_SIZES)] + (3,), dtype=np.uint8)
                for i in range(12)]
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        lat, dets = [], []
        for img in imgs[:4]:
            t0 = time.perf_counter()
            dets.extend(engine.predict([img]))
            lat.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        dets.extend(engine.predict(imgs[4:]))
        batch8_s = time.perf_counter() - t0
        launches = list(_counts())
        # 4 batch-1 forwards, and one per bucket that the batch of 8 fills
        if launches != [18 * forwards[0], 0, 0, 0] or not 5 <= forwards[0] <= 6:
            raise AssertionError(f"serve {name}: launches {launches} for {forwards[0]} forwards")
        for img, det in zip(imgs, dets):
            oh, ow = img.shape[:2]
            b = det["boxes"]
            if not (len(b) == config.num_object_queries and np.isfinite(b).all()
                    and np.isfinite(det["scores"]).all() and (b >= -1e-3).all()
                    and (b[:, [0, 2]] <= ow + 1e-3).all() and (b[:, [1, 3]] <= oh + 1e-3).all()):
                raise AssertionError(f"serve {name}: bad boxes for a {oh}x{ow} image")
        out[name] = dict(card=smi, batch1_ms=lat, batch8_images_per_s=8 / batch8_s,
                         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                         forwards=forwards[0], launches=launches)
        del engine
        torch.cuda.empty_cache()
    log(f"serve dc5 and r101: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 14: the host C++ layer, the evaluator at COCO-val scale, the
# transformer under remat with the image grids and a chip pause, and the
# weights export.

OMP_PROBE_SHAPE = (480, 640, 3)  # a source image of the generator's size


def phase_native_build() -> dict:
    """14a, first part, run right after phase 2 and before any loader worker
    spawns: both host C++ libraries built (g++, first use) in this process,
    so the workers load them instead of compiling at the same time.  The
    phase fails when either does not build: the card's host must not run
    the numpy paths unnoticed."""
    from detr_tpu_torch.data import _native as image_native
    from detr_tpu_torch.eval import _native as eval_native

    out = {}
    for name, mod in (("image_ops", image_native), ("cocoeval", eval_native)):
        t0 = time.perf_counter()
        lib = mod.load()
        if lib is None:
            raise AssertionError(f"the host C++ library {name} did not build on this machine")
        out[name] = dict(flags=mod.built_flags(), seconds=time.perf_counter() - t0,
                         library=Path(lib._name).name)
    log(f"native build: {json.dumps(out)}")
    return out


class NumpyImageOps:
    """``inner`` (a transform) on the numpy/PIL image ops, in whatever
    process calls it: a spawned loader worker does not see a switch made in
    this process, so the transform makes it itself."""

    def __init__(self, inner):
        self.inner = inner

    @property
    def rng(self):
        return self.inner.rng

    @rng.setter
    def rng(self, value):  # CocoDataset.set_worker_seed
        self.inner.rng = value

    def __call__(self, img, target):
        from detr_tpu_torch.data import _native

        _native._tried, _native._lib = True, None
        return self.inner(img, target)


def _omp_probe(_: int) -> dict:
    """In one of the loader's spawned workers: one native hue rotation,
    then OpenMP's thread count and the process's threads."""
    import ctypes

    from detr_tpu_torch.data import _native

    _native.hue_rotate(np.zeros(OMP_PROBE_SHAPE, np.float32), 0.1)
    time.sleep(1.0)  # hold this worker so that the pool's other one takes the next probe
    threads = None
    if "-fopenmp" in (_native.built_flags() or ""):
        threads = ctypes.CDLL("libgomp.so.1").omp_get_max_threads()
    return dict(pid=os.getpid(), omp_max_threads=threads,
                process_threads=len(os.listdir("/proc/self/task")),
                cpu_count=os.cpu_count(), affinity=len(os.sched_getaffinity(0)),
                OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS"))


@contextlib.contextmanager
def _numpy_ops():
    """This process's image ops on numpy/PIL for the block."""
    from detr_tpu_torch.data import _native

    saved = _native._tried, _native._lib
    _native._tried, _native._lib = True, None
    try:
        yield
    finally:
        _native._tried, _native._lib = saved


def _best_ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(min(times))


def _loader_rate(root: str, transform, workers: int, warm: int = 2, timed: int = 6) -> dict:
    """The training loader alone (the trainer's arguments: B=5, the default
    buckets, uint8, shuffled), ``warm`` batches for the workers' start-up,
    then ``timed`` batches: images/s."""
    from detr_tpu_torch.config import TrainingConfig
    from detr_tpu_torch.data import BucketedLoader, CocoDataset

    tc = TrainingConfig()
    loader = BucketedLoader(CocoDataset(root, "train", transform), tc.train_batch_size,
                            buckets=tc.shape_buckets, max_gt=tc.max_gt_boxes, shuffle=True,
                            drop_last=True, num_workers=workers, seed=0, image_dtype="uint8")
    try:
        t0 = time.perf_counter()
        it = iter(loader)
        for _ in range(warm):
            next(it)
        t1 = time.perf_counter()
        for _ in range(timed):
            next(it)
        t2 = time.perf_counter()
        mode = "process" if loader._pool is not None else "thread"
    finally:
        loader.close()
    return dict(num_workers=workers, mode=mode, warmup_s=t1 - t0, timed_batches=timed,
                images_per_s=tc.train_batch_size * timed / (t2 - t1))


def phase_native_host(smi: str, root: str) -> dict:
    """14a. The host C++ layer on phase 10's JPEGs: ``TrainTransform``
    (photometric on, uint8 out) per image on 40 decoded images, native
    against numpy/PIL with the same seed, in this process; each operation
    alone on a 480x640 source; the outputs' agreement (resize within one
    uint8 level of PIL, the float operations within 5e-3, ``normalize``
    within 1e-5); OpenMP's thread count in two spawned processes, as
    loader workers start (the loader gives each one thread); and
    ``BucketedLoader`` alone at 2 workers on each path (``chip_coco_ab.py``
    compares OpenMP settings end to end)."""
    from PIL import Image

    from detr_tpu_torch.data import CocoDataset, _native
    from detr_tpu_torch.data import transforms as T

    ds = CocoDataset(root, "train")
    items = [(np.asarray(ds.load_image(i)), ds.raw_target(i)) for i in range(40)]

    def transform_pass():
        tf = T.TrainTransform(seed=3, normalize=False)
        t0 = time.perf_counter()
        outs = [tf(img, dict(t))[0] for img, t in items]
        return (time.perf_counter() - t0) * 1e3 / len(items), outs

    transform_pass()  # warm: page cache, the library's threads
    native_ms, native_out = transform_pass()
    with _numpy_ops():
        numpy_ms, numpy_out = transform_pass()
    shapes_equal = all(a.shape == b.shape for a, b in zip(native_out, numpy_out))
    # The uint8 outputs of the whole chain differ where a float op's last bit
    # or the resize's rounding moves a pixel across a level.
    chain_max_diff = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
                         for a, b in zip(native_out, numpy_out))

    rng = np.random.default_rng(0)
    src = (rng.random(OMP_PROBE_SHAPE) * 255).astype(np.float32)
    u8 = src.astype(np.uint8)
    big = np.asarray(Image.fromarray(u8).resize((1067, 800), Image.BILINEAR))
    ops = {
        "hue": lambda: T.adjust_hue(src, 0.04),
        "brightness": lambda: T.adjust_brightness(src, 1.1),
        "contrast": lambda: T.adjust_contrast(src, 0.8),
        "saturation": lambda: T.adjust_saturation(src, 1.15),
        "resize_480x640_to_800x1067": lambda: T.resize(u8, {"boxes": np.zeros((0, 4))},
                                                       800, 1067)[0],
        "normalize_800x1067": lambda: T.normalize(big),
    }
    per_op, agreement = {}, {}
    for name, fn in ops.items():
        nat = fn()
        nat_ms = _best_ms(fn)
        with _numpy_ops():
            ref = fn()
            ref_ms = _best_ms(fn)
        diff = float(np.abs(nat.astype(np.float64) - ref.astype(np.float64)).max())
        tol = 1.0 if name.startswith("resize") else (1e-5 if name.startswith("normalize")
                                                      else 5e-3)
        per_op[name] = dict(native_ms=nat_ms, numpy_ms=ref_ms, speedup=ref_ms / nat_ms)
        agreement[name] = dict(max_abs_diff=diff, tolerance=tol)
        if not diff <= tol:
            raise AssertionError(f"native {name} differs from numpy/PIL by {diff} > {tol}")

    from detr_tpu_torch.data import BucketedLoader

    probe = BucketedLoader(ds, 5, num_workers=2, worker_mode="process")
    try:
        if not probe._start_pool():
            raise AssertionError("the loader's worker processes did not start")
        # as its workers start; a worker that dies would leave map() waiting
        omp = probe._pool.map_async(_omp_probe, range(2), chunksize=1).get(timeout=120)
    finally:
        probe.close()

    def train_transform():
        return T.get_train_transforms(seed=0, normalize=False)

    loaders = {"native": _loader_rate(root, train_transform(), 2),
               "numpy": _loader_rate(root, NumpyImageOps(train_transform()), 2)}
    if any(p["omp_max_threads"] not in (None, 1) for p in omp):
        raise AssertionError(f"loader workers' OpenMP threads {omp}, want 1 each")
    if any(v["mode"] != "process" for v in loaders.values()):
        raise AssertionError(f"loader workers are not processes: {loaders}")
    report = dict(card=smi, flags=_native.built_flags(), images=len(items),
                  train_transform_ms_per_image=dict(native=native_ms, numpy=numpy_ms,
                                                    speedup=numpy_ms / native_ms),
                  chain_shapes_equal=shapes_equal, chain_max_uint8_diff=chain_max_diff,
                  per_op=per_op, agreement=agreement, omp_per_worker=omp,
                  loader_alone_2_workers=loaders, cpu_count=os.cpu_count())
    if not shapes_equal:
        raise AssertionError("the native and numpy transform chains gave other shapes")
    log(f"native host layer: {json.dumps(report)}")
    return report


def coco_val_scale(seed: int = 0, n_images: int = 5000, num_classes: int = 80,
                   dets_per_image: int = 100) -> list[tuple]:
    """Detections and ground truth at COCO val2017's scale, from numpy:
    5000 images of 480x640, GT per image Poisson with mean 7.4 (36,781
    boxes over 5,000 images), 1 % crowd, box sides log-uniform from 8 to
    400 px (all three area ranges); 100 detections per image: each GT found
    with probability 0.7 (jittered, its class, a high score), the rest
    random boxes of random classes with lower scores.  Rows for
    ``CocoEvaluator.add_image``."""
    rng = np.random.default_rng(seed)
    h, w = 480, 640

    def boxes(n):
        side = np.exp(rng.uniform(np.log(8), np.log(400), n))
        aspect = np.exp(rng.uniform(-0.5, 0.5, n))
        bw, bh = np.minimum(side * aspect, w - 1), np.minimum(side / aspect, h - 1)
        x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        return np.stack([x0, y0, x0 + bw, y0 + bh], 1)

    rows = []
    for i in range(n_images):
        ng = int(rng.poisson(7.4))
        gt, gl = boxes(ng), rng.integers(0, num_classes, ng)
        crowd = rng.random(ng) < 0.01
        found = rng.random(ng) < 0.7
        hit = gt[found] + rng.normal(0, 3, (int(found.sum()), 4))
        nr = dets_per_image - len(hit)
        det = np.concatenate([hit, boxes(nr)])
        dl = np.concatenate([gl[found], rng.integers(0, num_classes, nr)])
        ds = np.concatenate([rng.uniform(0.5, 1.0, len(hit)), rng.uniform(0.0, 0.6, nr)])
        rows.append((i, det, ds, dl, gt, gl, crowd))
    return rows


def _evaluate_rows(rows, num_classes: int = 80) -> tuple[dict, float]:
    from detr_tpu_torch.eval.coco_eval import CocoEvaluator

    ev = CocoEvaluator(num_classes)
    for row in rows:
        ev.add_image(*row)
    t0 = time.perf_counter()
    out = ev.compute()
    return out, time.perf_counter() - t0


def phase_evaluator_scale(smi: str) -> dict:
    """14b. ``CocoEvaluator.compute()`` at COCO-val scale (``coco_val_scale``,
    seed 0): the batched native path on all 5000 images and on the first
    1000, the numpy path on the first 1000, which must give the native
    dict exactly."""
    from detr_tpu_torch.eval import _native as eval_native

    t0 = time.perf_counter()
    rows = coco_val_scale()
    t_gen = time.perf_counter() - t0
    full, full_s = _evaluate_rows(rows)
    part, part_s = _evaluate_rows(rows[:1000])
    saved = eval_native._tried, eval_native._lib
    eval_native._tried, eval_native._lib = True, None
    try:
        ref, ref_s = _evaluate_rows(rows[:1000])
    finally:
        eval_native._tried, eval_native._lib = saved
    same = sorted(part) == sorted(ref) and all(
        np.array_equal(np.asarray(part[k]), np.asarray(ref[k])) for k in ref)
    n_gt = sum(len(r[4]) for r in rows)
    area = np.concatenate([(r[4][:, 2] - r[4][:, 0]) * (r[4][:, 3] - r[4][:, 1]) for r in rows])
    report = dict(card=smi, images=len(rows), gt_boxes=n_gt, gt_per_image=n_gt / len(rows),
                  crowd=int(sum(r[6].sum() for r in rows)),
                  gt_small_medium_large=[int((area < 32**2).sum()),
                                         int(((area >= 32**2) & (area <= 96**2)).sum()),
                                         int((area > 96**2).sum())],
                  detections=sum(len(r[1]) for r in rows), generate_s=t_gen,
                  native_5000_s=full_s, native_1000_s=part_s, numpy_1000_s=ref_s,
                  numpy_over_native_1000=ref_s / part_s, same_dict_1000=same,
                  ap_5000={k: full[k] for k in AP_KEYS}, ap_1000={k: part[k] for k in AP_KEYS})
    log(f"evaluator at COCO-val scale: {json.dumps(report)}")
    if not same:
        raise AssertionError("the native and numpy evaluators differ on 1000 images: "
                             f"{ {k: (part[k], ref[k]) for k in AP_KEYS} }")
    return report


TRANSFORMER = ("encoder.", "decoder.", "class_embedding.", "bbox_embedding.",
               "object_query_embedding.")


def _step_pair(detr_config, batch: dict, micro_batch: int, steps: int, label: str) -> dict:
    """One random init (seed 0), its frozen-BN statistics calibrated on
    ``batch``, trained ``steps`` micro-steps without and with ``remat`` from
    the same dropout seeds (an AdamW update every 2): per micro-step the
    loss dict, launches, synchronised ms and the peak device memory above
    what was allocated before it; after the first micro-step the
    accumulated gradient.  Equality: the loss dicts and the transformer's
    gradients bit for bit, else phase 8's rule (loss keys within 1e-3 of
    max(1, |v|), the parameters after the update within 2 lr, at most 0.1 %
    of them apart by more than 1e-6); the trunk's and the input
    projection's cuDNN weight gradients add in a run-dependent order, so
    phase 8's rule alone holds there."""
    from detr_tpu_torch.config import TrainingConfig
    from detr_tpu_torch.models import DETR, calibrate_frozen_bn
    from detr_tpu_torch.ops.image_norm import prepare_batch_image
    from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, make_train_step

    tc = TrainingConfig(train_batch_size=micro_batch, cumulative_train_batch_size=2 * micro_batch)
    base = DETR(detr_config)
    base.reset_parameters(torch.Generator().manual_seed(0))
    base.cuda()
    calibrate_frozen_bn(base.backbone.backbone, prepare_batch_image(batch, None))
    runs = {}
    for remat in (False, True):
        cfg = detr_config.replace(remat=remat)
        model = DETR(cfg).cuda()
        model.load_state_dict(base.state_dict())
        opt, _ = build_optimizer(model, tc)
        state = TrainState(model, opt, torch.Generator().manual_seed(0))
        step = make_train_step(model, build_criterion(tc, cfg))
        rec = dict(metrics=[], launches=[], ms=[], peak_bytes=[])
        for i in range(steps):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before_bytes = torch.cuda.memory_allocated()
            before = _counts()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["launches"].append([a - b for a, b in zip(_counts(), before)])
            rec["peak_bytes"].append(torch.cuda.max_memory_allocated() - before_bytes)
            rec["metrics"].append({k: float(v) for k, v in m.items()})
            if i == 0:
                rec["acc"] = {n: a.cpu() for n, a in zip(opt.names, opt._acc)}
        rec["params"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
        rec["lrs"] = opt.get_learning_rates()
        runs[remat] = rec
        del model, opt, state, step
        torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    plain, remat = runs[False], runs[True]
    loss_exact = plain["metrics"] == remat["metrics"]
    worst = 0.0
    for got, want in zip(remat["metrics"], plain["metrics"]):
        for key, v in want.items():
            worst = max(worst, abs(got[key] - v) / (1e-3 * max(1.0, abs(v))))
    transformer = [n for n in plain["acc"] if n.startswith(TRANSFORMER)]
    grads_exact = all(torch.equal(plain["acc"][n], remat["acc"][n]) for n in transformer)
    trunk_max_rel = max(float((plain["acc"][n] - remat["acc"][n]).abs().max())
                        / max(float(plain["acc"][n].abs().max()), 1e-30)
                        for n in plain["acc"] if not n.startswith(TRANSFORMER))
    n_all = n_apart = 0
    for name, want in plain["params"].items():
        lr = plain["lrs"]["backbone" if name.startswith("backbone.") else "rest"]
        diff = (remat["params"][name] - want).abs()
        if not bool((diff <= 2.002 * lr + 1e-6).all()):
            raise AssertionError(f"{label}: parameter {name} apart by {float(diff.max())}")
        n_all += diff.numel()
        n_apart += int((diff > 1e-6).sum())
    report = dict(loss_dicts_equal=loss_exact, worst_key_diff_over_phase8_tolerance=worst,
                  transformer_grads_equal=grads_exact, transformer_tensors=len(transformer),
                  trunk_grads_max_rel_diff=trunk_max_rel, params_apart_after_update=n_apart,
                  params=n_all,
                  launches_plain=plain["launches"], launches_remat=remat["launches"],
                  ms_plain=plain["ms"], ms_remat=remat["ms"],
                  ms_median_plain=float(np.median(plain["ms"][1:])),
                  ms_median_remat=float(np.median(remat["ms"][1:])),
                  peak_step_bytes_plain=max(plain["peak_bytes"]),
                  peak_step_bytes_remat=max(remat["peak_bytes"]),
                  losses=[m["loss"] for m in plain["metrics"]])
    if not ((loss_exact or worst <= 1.0) and n_apart <= 1e-3 * n_all):
        raise AssertionError(f"{label}: remat differs from the plain step: {report}")
    if not grads_exact and worst > 1.0:
        raise AssertionError(f"{label}: transformer gradients differ: {report}")
    for i, (p, r) in enumerate(zip(plain["launches"], remat["launches"])):
        # the recomputation runs each attention forward again
        if p != [18, 18, 18, 1] or r != [36, 18, 18, 1]:
            raise AssertionError(f"{label} micro-step {i}: launches {p} plain, {r} remat")
    return report


def _grids_in_events(log_dir: str, shape: tuple) -> dict:
    """The two validation grids in the tensorboard event file: present,
    one image each, of the same size, a whole number of ``shape`` cells
    (or its transpose) at most 5 x 5."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    events = EventAccumulator(log_dir, size_guidance={"images": 0})
    events.Reload()
    tags = sorted(t for t in events.Tags()["images"] if t.startswith("val-"))
    if tags != ["val-ground-truth", "val-predictions"]:
        raise AssertionError(f"image grids in the event file: {tags}")
    sizes = {t: [(e.height, e.width) for e in events.Images(t)] for t in tags}
    shapes = set(sum(sizes.values(), []))
    cells = [(h // ch, w // cw) for h, w in shapes for ch, cw in (shape, shape[::-1])
             if h % ch == 0 and w % cw == 0 and 1 <= h // ch <= 5 and 1 <= w // cw <= 5]
    if len(shapes) != 1 or not cells or any(len(v) != 1 for v in sizes.values()):
        raise AssertionError(f"image grids {sizes}, cells of {shape}")
    (h, w), = shapes
    return dict(tags=tags, height=h, width=w, rows_cols=list(cells[0]))


def phase_remat_train(smi: str, root: str) -> tuple[dict, str]:
    """14c. ``train_DETR`` on DETR-R50 with ``remat=True`` over phase 10's
    data (B=5, the default buckets, bf16, dropout 0.1, photometric on in 2
    worker processes, ``save_image_epochs=1``): 8 micro-steps (an update
    every 4), 36 + 18 + 18 + 1 launches each, a checkpoint and one
    validation batch of ``VAL_BATCH``, whose two image grids must be in the
    event file.  After micro-step 2 a benchmark's pause file is held for 3 s: the
    next micro-step starts only after it is gone, the loop logs the wait,
    and the watchdog's beats go on through it (no gap of 3.5 s).  Then the
    same micro-steps without and with ``remat`` from the same weights and
    seeds (``_step_pair``) on the loader's first batch, and on DC5 (B=2,
    800x1344, S=4200), each side's peak memory and median micro-step.
    Returns the report and the run's output dir (for 14d)."""
    from detr_tpu_torch.config import DETRConfig, TrainingConfig
    from detr_tpu_torch.data.synthetic import synthetic_batch
    from detr_tpu_torch.train import trainer
    from detr_tpu_torch.train.trainer import to_device
    from detr_tpu_torch.utils import chip_pause
    from detr_tpu_torch.utils.watchdog import Watchdog

    out = _scratch_dir("chip_smoke_remat_")
    pause_path = os.path.join(out, "pause")
    config = TrainingConfig(coco_dataset_root=root, limit_train_iters=8, limit_val_iters=1,
                            epochs=1, output_dir=out, cumulative_train_batch_size=20,
                            save_image_epochs=1, val_batch_size=VAL_BATCH)
    hooks, beats, pause, grid_times = [], [], {}, {}

    class RecordingWatchdog(Watchdog):
        def beat(self):
            beats.append(time.perf_counter())
            super().beat()

    def release():
        time.sleep(3.0)
        os.unlink(pause_path)
        pause["released"] = time.perf_counter()

    def on_step(i):
        hooks.append(time.perf_counter())
        if i == 2:
            with open(pause_path, "w") as f:
                f.write("chip_smoke")  # another holder than this process
            pause["held"] = time.perf_counter()
            pause["thread"] = threading.Thread(target=release)
            pause["thread"].start()

    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    trainer_log = logging.getLogger("detr_tpu_torch.train.trainer")
    level = trainer_log.level
    trainer_log.addHandler(handler)
    trainer_log.setLevel(logging.INFO)
    saved_path, saved_dog = chip_pause.PAUSE_FILE, trainer.Watchdog
    chip_pause.PAUSE_FILE, trainer.Watchdog = pause_path, RecordingWatchdog
    try:
        with _timed_grids(grid_times):
            run = _watched_train(config, False, smi, "remat_train",
                                 detr_config=DETRConfig(remat=True), per_step=(36, 18, 18, 1),
                                 on_step=on_step)
    finally:
        chip_pause.PAUSE_FILE, trainer.Watchdog = saved_path, saved_dog
        trainer_log.removeHandler(handler)
        trainer_log.setLevel(level)
        if "thread" in pause:
            pause["thread"].join(timeout=30)
    step3_start = hooks[3] - run["ms_per_micro_step"][3] / 1e3
    during = [b for b in beats if pause["held"] <= b <= pause["released"] + 2.5]
    gaps = np.diff([pause["held"], *during, step3_start])
    honoured = [m for m in messages if "chip pause honoured" in m]
    pause_report = dict(held_s=pause["released"] - pause["held"],
                        step3_started_after_release_s=step3_start - pause["released"],
                        beats_during=len(during), max_beat_gap_s=float(gaps.max()),
                        log=honoured)
    # Beaten at every poll of the wait (2 s, and slack for a busy host): a
    # watchdog of any timeout above 3.5 s outlasts a pause of any length.
    if not (step3_start >= pause["released"] and honoured and len(during) >= 2
            and gaps.max() < 3.5):
        raise AssertionError(f"chip pause: {pause_report}")
    grids = _grids_in_events(os.path.join(out, "logs"), config.eval_shape)

    # the same micro-steps without and with remat, on the loader's first batch
    loader, val_loader, _, _ = trainer._make_loaders(config.replace(num_workers=0), False)
    val_loader.close()
    batch = to_device(next(iter(loader)), torch.device("cuda"))
    loader.close()
    r50 = _step_pair(DETRConfig(), batch, config.train_batch_size, 6, "remat r50")
    del batch
    dc5_batch = to_device(synthetic_batch(np.random.default_rng(0), 2, *DC5_SHAPE,
                                          max_gt=config.max_gt_boxes, learnable=True),
                          torch.device("cuda"))
    dc5 = _step_pair(DETRConfig(dilation=True), dc5_batch, 2, 6, "remat dc5")
    del dc5_batch
    torch.cuda.empty_cache()
    report = dict(card=smi, train=dict(
        micro_steps=run["micro_steps"], ms_per_micro_step_median=run["ms_per_micro_step_median"],
        max_memory_allocated_bytes=run["max_memory_allocated_bytes"],
        launches=run["launches"], losses=run["losses"], shapes=run["shapes"],
        validation=run["validation"]["launches"],
        validation_s=run["validation"]["seconds"]), pause=pause_report,
        grids=dict(grids, **grid_times),
        r50_b5=r50, dc5_b2=dc5)
    log(f"remat, grids, pause: {json.dumps(report)}")
    return report, out


def phase_export_resume(smi: str, root: str, run_dir: str) -> dict:
    """14d. ``python -m detr_tpu_torch.train.export`` of 14c's run, then a
    weights-only resume from the artifact (``--start-epoch`` read from its
    ``EPOCH``; no loader worker) for 1 micro-step and a validation batch:
    the parameters and frozen statistics before that step equal the
    exported ones bit for bit."""
    from detr_tpu_torch.config import DETRConfig, TrainingConfig
    from detr_tpu_torch.train import trainer
    from detr_tpu_torch.train.checkpoint import CheckpointManager
    from detr_tpu_torch.train.export import EPOCH_FILE
    from detr_tpu_torch.train.export import main as export_main

    art, out = _scratch_dir("chip_smoke_export_"), _scratch_dir("chip_smoke_resume_")
    try:
        t0 = time.perf_counter()
        export_main([run_dir, art])
        export_s = time.perf_counter() - t0
        epoch = int(Path(art, EPOCH_FILE).read_text())
        payload = CheckpointManager(art).restore_payload()
        full_bytes = sum(p.stat().st_size for p in Path(run_dir, "checkpoints").rglob("*.pt"))
        art_bytes = sum(p.stat().st_size for p in Path(art, "checkpoints").rglob("*.pt"))
        seen = {}
        make_step = trainer.make_train_step

        def checked_make_train_step(model, criterion, canvas_map=None, **kw):
            step = make_step(model, criterion, canvas_map, **kw)

            def first_look(state, batch):
                if not seen:
                    seen["params"] = all(torch.equal(p.detach().cpu(), payload["params"][n])
                                         for n, p in model.named_parameters())
                    seen["frozen"] = all(torch.equal(b.cpu(), payload["frozen"][n])
                                         for n, b in model.named_buffers())
                    seen["tensors"] = len(payload["params"]) + len(payload["frozen"])
                return step(state, batch)

            return first_look

        config = TrainingConfig(coco_dataset_root=root, output_dir=out,
                                resume_from_checkpoint=art, start_epoch=epoch,
                                epochs=epoch + 1, limit_train_iters=1, limit_val_iters=1,
                                num_workers=0, checkpoint_epochs=1000,
                                val_batch_size=VAL_BATCH)
        trainer.make_train_step = checked_make_train_step
        _reset_counts()
        try:
            t0 = time.perf_counter()
            metrics = trainer.train_DETR(config, DETRConfig())
            resume_s = time.perf_counter() - t0
            launches = list(_counts())
        finally:
            trainer.make_train_step = make_step
    finally:
        shutil.rmtree(art, ignore_errors=True)
        shutil.rmtree(out, ignore_errors=True)
    report = dict(card=smi, epoch_file=epoch, export_s=export_s, full_checkpoint_bytes=full_bytes,
                  artifact_bytes=art_bytes, resume_wall_s=resume_s, launches=launches,
                  params_equal=seen.get("params"), frozen_equal=seen.get("frozen"),
                  tensors=seen.get("tensors"), ap=metrics.get("AP"))
    log(f"export and resume: {json.dumps(report)}")
    if not (seen.get("params") and seen.get("frozen") and epoch == 1
            and launches == [18 + 18, 18, 18, 1 + 1]):
        raise AssertionError(f"export and resume: {report}")
    return report


# ---------------------------------------------------------------------------
# Phase 15: the learning run (detr_tpu_torch.examples.convergence_synthetic)

# The small demo's shapes: B=16 at 256x256 (an 8x8 map, S=64), hidden 64 in
# 4 heads (D=16, zero-padded to the kernels' 32), 16 queries, 2+2 layers,
# dropout 0.1; the mid preset's: hidden 128 (D=32), 50 queries, 6+6 layers,
# dropout 0.0.  GT padded to 8 (--max-gt).
LEARN_B, LEARN_SIDE, LEARN_HEADS, LEARN_G = 16, 256, 4, 8
LEARN_PRESETS = {  # name: (D, queries, encoder layers, decoder layers, dropout)
    "small": (16, 16, 2, 2, 0.1),
    "mid": (32, 50, 6, 6, 0.0),
}
LEARN_STEPS, LEARN_EVAL_EVERY = 600, 200  # phase 15c: the small demo, cut to this
# The loss at phase 15c's last evaluation must be below the first's by this.
LEARN_LOSS_DROP = 1.0


def _learning_masks(seed: int = 0) -> torch.Tensor:
    """Key padding masks (B, 64) of a generator batch of the learning run:
    each image's valid extent, at stride 32, in the 256x256 canvas."""
    from detr_tpu_torch.data.synthetic import synthetic_batch
    from detr_tpu_torch.models.detr import make_image_padding_mask

    b = synthetic_batch(np.random.default_rng(seed), LEARN_B, LEARN_SIDE, LEARN_SIDE,
                        max_gt=LEARN_G, num_classes=5, mean_boxes=3.0, learnable=True)
    side = LEARN_SIDE // 32
    mask = make_image_padding_mask(side, side, torch.from_numpy(b["height"]).cuda(),
                                   torch.from_numpy(b["width"]).cuda(), 32, "full")
    return mask.reshape(LEARN_B, side * side).contiguous()


def _learning_auction_case(preset: str, seed: int) -> tuple[str, torch.Tensor, torch.Tensor]:
    """The learning run's matching on the card: B=16 images times the
    preset's decoder layers problems, its queries against G=8 GT slots of a
    generator batch, random logits and boxes."""
    from detr_tpu_torch.data.synthetic import synthetic_batch
    from detr_tpu_torch.matcher.hungarian import compute_cost_matrix

    _, Q, _, L, _ = LEARN_PRESETS[preset]
    classes = 5 if preset == "small" else 81
    rng = np.random.default_rng(seed)
    b = synthetic_batch(rng, LEARN_B, LEARN_SIDE, LEARN_SIDE, max_gt=LEARN_G,
                        num_classes=classes, mean_boxes=3.0, learnable=True)
    valid = torch.from_numpy(b["gt_valid"]).cuda()[:, None].expand(LEARN_B, L, LEARN_G)
    logits = torch.from_numpy(rng.normal(size=(LEARN_B, L, Q, classes + 1)).astype(np.float32))
    boxes = torch.sigmoid(torch.from_numpy(rng.normal(size=(LEARN_B, L, Q, 4)).astype(np.float32)))
    cost = compute_cost_matrix(
        logits.cuda(), boxes.cuda(),
        torch.from_numpy(b["class_idx"]).cuda()[:, None].expand(LEARN_B, L, LEARN_G),
        torch.from_numpy(b["boxes_normalized"]).cuda()[:, None].expand(LEARN_B, L, LEARN_G, 4),
        valid).reshape(-1, Q, LEARN_G).contiguous()
    return f"learning_{preset}", cost, valid.reshape(-1, LEARN_G).contiguous()


def _learning_kernels(smi: str) -> tuple[list[dict], list[dict]]:
    """15a. The attention kernels and the auction at the learning run's
    shapes against their plain versions (phase 7's rules), timed."""
    mask = _learning_masks()
    S = (LEARN_SIDE // 32) ** 2
    gen = torch.Generator(device="cuda").manual_seed(15)
    attn = []
    for preset, (d, q, enc, dec, rate) in LEARN_PRESETS.items():
        shapes = [  # (name, batch, heads, Lq, S, mask, hash base, launches per step, timed)
            (f"{preset}_encoder_self", LEARN_B, LEARN_HEADS, S, S, mask, None, enc, True),
            (f"{preset}_decoder_self", LEARN_B, LEARN_HEADS, q, q, None, None, dec, True),
            (f"{preset}_decoder_cross", LEARN_B, LEARN_HEADS, q, S, mask, None, dec, True),
        ]
        attn += _check_attention_shapes(gen, shapes, rate=rate, d=d,
                                        label="learning run kernel check")
    auction = [_check_auction(*_learning_auction_case(p, 15 + i), smi)
               for i, p in enumerate(LEARN_PRESETS)]
    return attn, auction


def _learning_card_vs_cpu() -> dict:
    """15b. The first 3 steps of the small demo's loop (``build`` and
    ``train_chunk``) on the card and on the CPU, fp32 with TF32 off and
    dropout 0, from the same weights and frozen-BN statistics (the CPU's
    calibration on both), the card's assignment injected on the CPU side
    each step: phase 8's rule on every step's loss dict and on the
    parameters after them."""
    from detr_tpu_torch.examples import convergence_synthetic as cs
    from detr_tpu_torch.train import make_train_step

    args = cs.parse_args(["--dropout", "0.0"])
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = cs.build(args, torch.device("cpu"), dtype="float32")
        card = cs.build(args, torch.device("cuda"), dtype="float32")
        card["model"].load_state_dict(cpu["model"].state_dict())
        assigned = []
        matcher = card["criterion"].matcher

        def recording(*a):
            assigned.append(matcher(*a))
            return assigned[-1]

        steps = {
            "card": make_train_step(card["model"],
                                    dataclasses.replace(card["criterion"], matcher=recording)),
            "cpu": make_train_step(cpu["model"], dataclasses.replace(
                cpu["criterion"], matcher=lambda *_a: assigned[-1].cpu())),
        }
        runs = {"card": card, "cpu": cpu}
        per_step, worst = [], 0.0
        for i in range(3):
            metrics = {}
            for side in ("card", "cpu"):
                run = runs[side]
                t0 = time.perf_counter()
                m = cs.train_chunk(steps[side], run["state"], args.lr,
                                   [b for b, _ in run["train"]], i, 1)
                metrics[side] = {k: float(v) for k, v in m.items()}
                metrics[f"{side}_s"] = time.perf_counter() - t0
            gt = int(cpu["train"][i % len(cpu["train"])][1]["gt_valid"].sum())
            flips = {"cardinality_error": 0.5, "class_error": 100.0 / max(1, gt),
                     "diag_nonbg_frac": 1.0 / (LEARN_B * args.queries)}
            worst = max(worst, _hold_to_cpu(f"learning run step {i}", metrics["card"],
                                            metrics["cpu"], flips))
            per_step.append(dict(loss_card=metrics["card"]["loss"],
                                 loss_cpu=metrics["cpu"]["loss"], card_s=metrics["card_s"],
                                 cpu_s=metrics["cpu_s"]))
        # Updates 1 and 2 moved each element by about its rate times sign(g):
        # an element whose gradient sits at the noise floor may move the
        # other way on the other device, at most twice the rates apart.
        moved = cs.warmup_lr(1, args.lr) + cs.warmup_lr(2, args.lr)
        n_all = n_flip = 0
        for (name, pc), pg in zip(cpu["model"].named_parameters(), card["model"].parameters()):
            diff = (pg.detach().cpu() - pc.detach()).abs()
            if not bool((diff <= 2.002 * moved + 1e-6).all()):
                raise AssertionError(f"learning run parameter {name} differs by {float(diff.max())}")
            n_all += diff.numel()
            n_flip += int((diff > 1e-6).sum())
        if n_flip > 1e-3 * n_all:
            raise AssertionError(f"learning run: {n_flip} of {n_all} parameters moved apart")
        if card["state"].optimizer.updates != 3 or cpu["state"].optimizer.updates != 3:
            raise AssertionError("learning run: 3 steps must make 3 updates")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    report = dict(steps=per_step, worst_key_diff_over_tolerance=worst,
                  params_moved_apart=n_flip, params=n_all, assignment_from="card")
    log(f"learning run card vs cpu (fp32, TF32 off, dropout 0, B=16 256x256, 3 steps): "
        f"{json.dumps(report)}")
    return report


def phase_learning_run(smi: str) -> dict:
    """15. The learning run: (a) its kernels at its shapes, (b) its first
    steps on the card against the CPU, (c) the small demo's ``main()`` on
    the card for LEARN_STEPS steps: 6 + 6 + 6 attention launches and 1
    auction per step (and 6 forward launches per evaluation batch, 4
    validation and 4 training batches per evaluation and 4 at the end), every
    evaluation's AP dict finite, the loss at the last evaluation below the
    first's by LEARN_LOSS_DROP; steps per second and the loss curve."""
    from detr_tpu_torch.examples import convergence_synthetic as cs

    t0 = time.perf_counter()
    attn_rows, auction_rows = _learning_kernels(smi)
    t_a = time.perf_counter()
    card_vs_cpu = _learning_card_vs_cpu()
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    history = []
    _reset_counts()
    rc = cs.main(["--steps", str(LEARN_STEPS), "--eval-every", str(LEARN_EVAL_EVERY),
                  "--ap50-bar", "0"], history)
    torch.cuda.synchronize()
    fwd, dkv, dq, auction = _counts()
    t_c = time.perf_counter()
    steps = history[-1]["step"] if history else 0
    _, _, enc, dec, _ = LEARN_PRESETS["small"]
    per_forward = enc + 2 * dec
    eval_batches = 2 * cs.N_VAL_BATCHES * len(history) + cs.N_VAL_BATCHES
    want = (per_forward * (steps + eval_batches), per_forward * steps, per_forward * steps,
            steps)
    launches = dict(fwd=fwd, bwd_dkv=dkv, bwd_dq=dq, auction=auction)
    curve = [dict(step=h["step"], loss=h["loss"], val_AP50=h["val"]["AP50"],
                  train_AP50=h["train"]["AP50"], train_AP=h["train"]["AP"],
                  seconds=h["seconds"]) for h in history]
    report = dict(
        kernels_s=t_a - t0, card_vs_cpu_s=t_b - t_a, run_s=t_c - t_b, exit_code=rc,
        steps=steps, eval_every=LEARN_EVAL_EVERY, launches=launches,
        launches_want=dict(zip(launches, want)),
        steps_per_s=steps / history[-1]["train_seconds"] if history else 0.0,
        loss_drop=history[0]["loss"] - history[-1]["loss"] if history else 0.0,
        loss_drop_bar=LEARN_LOSS_DROP, curve=curve, card=smi)
    log(f"learning run (small demo, {steps} steps on the card): {json.dumps(report)}")
    if rc != 0 or steps != LEARN_STEPS:
        raise AssertionError(f"the learning run ended with {rc} after {steps} steps")
    if (fwd, dkv, dq, auction) != want:
        raise AssertionError(f"learning run launches {launches}, want {want} "
                             f"({per_forward}/{per_forward}/{per_forward}/1 per step)")
    for h in history:
        for key, value in (*h["val"].items(), *h["train"].items()):
            if not np.isfinite(value):
                raise AssertionError(f"learning run step {h['step']}: {key} = {value}")
    if not report["loss_drop"] > LEARN_LOSS_DROP:
        raise AssertionError(f"learning run: the loss fell {report['loss_drop']:.3f}, "
                             f"want more than {LEARN_LOSS_DROP}")
    report["attention_rows"], report["auction_rows"] = attn_rows, auction_rows
    report["card_vs_cpu"] = card_vs_cpu
    return report


def main() -> None:
    t_start = time.perf_counter()
    faulthandler.dump_traceback_later(HANG_DUMP_S - (t_start - _T_START), exit=False)
    progress("phase_device")
    kind, smi = phase_device()
    progress("phase_build")
    phase_build()
    progress("phase_native_build")
    native_build = phase_native_build()  # 14a's build, before any loader worker spawns
    progress("phase_kernels")
    serve_rows = phase_kernels()
    progress("phase_card_vs_cpu")
    phase_card_vs_cpu()
    progress("phase_serve")
    serve_launches, engine = phase_serve(smi)
    progress("phase_breakdown")
    phase_breakdown(engine, smi)
    del engine
    torch.cuda.empty_cache()
    progress("phase_train_kernels")
    attn_rows = phase_train_kernels()
    progress("phase_auction_kernel")
    auction_rows = phase_auction_kernel(smi)
    progress("phase_msda")
    msda_rows = phase_msda(smi)
    progress("phase_tiny_train_card_vs_cpu")
    phase_tiny_train_card_vs_cpu()
    progress("phase_train_step_card_vs_cpu")
    phase_train_step_card_vs_cpu()
    progress("phase_train")
    train = phase_train(smi)
    torch.cuda.empty_cache()
    progress("phase_trace")
    phase_trace(smi)
    torch.cuda.empty_cache()
    t_coco = time.perf_counter()
    progress("make_coco_data")
    root, t_gen = make_coco_data()
    remat_dir = None
    try:
        progress("phase_train_coco")
        coco = phase_train_coco(smi, root, t_gen)
        t_ckpt = time.perf_counter()
        progress("phase_checkpoint_serve")
        ckpt = phase_checkpoint_serve(smi, root)
        torch.cuda.empty_cache()
        t_source = time.perf_counter()
        progress("phase_train_source")
        source = phase_train_source(smi, root, coco)
        torch.cuda.empty_cache()
        progress("phase_cli_r101")
        r101 = phase_cli_r101(smi, root)
        torch.cuda.empty_cache()
        t_13 = time.perf_counter()
        progress("phase_dc5_train")
        dc5 = phase_dc5_train(smi)
        torch.cuda.empty_cache()
        progress("phase_two_ranks")
        ranks = phase_two_ranks(smi)
        progress("phase_cli_nccl")
        cli_nccl = phase_cli_nccl(smi)
        torch.cuda.empty_cache()
        progress("phase_serve_variants")
        serve_variants = phase_serve_variants(smi)
        t_14 = time.perf_counter()
        progress("phase_native_host")
        host = phase_native_host(smi, root)
        host["build"] = native_build
        progress("phase_evaluator_scale")
        evaluator = phase_evaluator_scale(smi)
        progress("phase_remat_train")
        remat, remat_dir = phase_remat_train(smi, root)
        torch.cuda.empty_cache()
        progress("phase_export_resume")
        export = phase_export_resume(smi, root, remat_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if remat_dir is not None:
            shutil.rmtree(remat_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    t_15 = time.perf_counter()
    progress("phase_learning_run")
    learn = phase_learning_run(smi)
    t_end = time.perf_counter()
    log(f"wall: {t_end - t_start:.1f} s, of which phase 10 (COCO) {t_ckpt - t_coco:.1f} s, "
        f"phase 11 (checkpoint, validate, serve) {t_source - t_ckpt:.1f} s, "
        f"phase 12 (device resize, the R101 CLI) {t_13 - t_source:.1f} s, "
        f"phase 13 (DC5, two ranks, NCCL, serving DC5 and R101) {t_14 - t_13:.1f} s, "
        f"phase 14 (host C++ layer, evaluator, remat, grids, pause, export) "
        f"{t_15 - t_14:.1f} s, phase 15 (the learning run) {t_end - t_15:.1f} s")
    summary = dict(
        train_transform_ms_per_image=host["train_transform_ms_per_image"],
        evaluator_s={k: evaluator[f"{k}_s"] for k in ("native_5000", "native_1000",
                                                       "numpy_1000")},
        peak_step_bytes_plain_remat={k: [remat[k]["peak_step_bytes_plain"],
                                         remat[k]["peak_step_bytes_remat"]]
                                     for k in ("r50_b5", "dc5_b2")})
    log(f"phase 14 summary: {json.dumps(summary)}")

    kernels = []
    main_rows = [r for r in attn_rows if r["dtype"] == "bfloat16" and r["launches_per_step"]]
    serve_main = [r for r in serve_rows if r["dtype"] == "bfloat16" and "kernel_ms" in r]

    def per_step(key):  # per training micro-step: 6 launches of each shape
        return sum(r[key] * r["launches_per_step"] for r in main_rows)

    def bound_by(name):
        ops = sum(r[f"{name}_bound_ms"] * r["launches_per_step"] for r in main_rows
                  if r[f"{name}_bound_by"] == "operations")
        return "operations" if ops >= per_step(f"{name}_bound_ms") / 2 else "bytes"

    tl, cl, kl = train["launches"], coco["launches"], ckpt["launches"]
    sl, rl = source["launches"], r101["launches"]
    serving = {f"serve_{name}": dict(zip(("fwd", "bwd_dkv", "bwd_dq", "auction"), v["launches"]))
               for name, v in serve_variants.items()}
    names = ("fwd", "bwd_dkv", "bwd_dq", "auction")

    def total(steps):  # per-micro-step launch lists -> one count per kernel
        return dict(zip(names, np.sum(steps, axis=0).tolist()))

    pairs = [remat[k][f"launches_{side}"] for k in ("r50_b5", "dc5_b2") for side in ("plain", "remat")]
    paths = (("train", tl), ("train_coco", cl), ("checkpoint_validate_serve", kl),
             ("train_coco_source", sl), ("cli_r101", rl), ("dc5_train", dc5["launches"]),
             ("two_ranks_gloo", ranks["launches"]), ("cli_nccl_and_entry", cli_nccl["launches"]),
             *serving.items(), ("remat_train", remat["train"]["launches"]),
             ("remat_step_pairs", total(sum(pairs, []))),
             ("export_resume", dict(zip(names, export["launches"]))),
             ("convergence_synthetic", learn["launches"]))
    common = dict(route="cuda", card=smi)
    learn_rows = learn["attention_rows"]

    def learning_run(keys):  # per step of each preset of the learning run, bf16
        per_step = {p: {k: sum(r[k] * r["launches_per_step"] for r in learn_rows
                               if r["dtype"] == "bfloat16" and r["shape"].startswith(f"{p}_"))
                        for k in keys} for p in LEARN_PRESETS}
        return dict(per_step=per_step, launches_per_step={
            p: enc + 2 * dec for p, (_, _, enc, dec, _) in LEARN_PRESETS.items()},
            per="training step of the learning run (B=16, 256x256, bf16; small: D=16 "
                "zero-padded to 32, dropout 0.1; mid: D=32, dropout 0.0)")

    bf16_rows = [r for r in attn_rows if r["dtype"] == "bfloat16"]
    fp32_rows = [r for r in attn_rows if r["dtype"] == "float32"]
    fwd_rows = attn_rows + serve_rows

    def serve_sum(key):  # per serving forward: 6 launches of each shape
        return sum(r[key] * r["launches_per_forward"] for r in serve_main)

    kernels.append(dict(
        name="masked_attention_fwd", source="detr_tpu_torch/csrc/masked_attention_fwd.cu",
        replaces="detr_tpu/ops/pallas_attention.py:121",
        launches=serve_launches + sum(c["fwd"] for _, c in paths),
        launches_by_path={"serve": serve_launches, **{p: c["fwd"] for p, c in paths}},
        validation_launches={"train": train["validation"]["launches"][0],
                             "train_coco": coco["validation"]["launches"][0],
                             "checkpoint_validate_serve": [
                                 v["launches"][0] for v in ckpt["validations"]],
                             "train_coco_source": source["validation"]["launches"][0]},
        max_abs_err=max(r["out_err"] for r in main_rows),
        tolerance=f"out: {BF16_RULE}; fp32: {TOL_OUT_FP32}; lse: {TOL_LSE}, exactly "
                  "finfo(float32).min on fully masked rows",
        max_ulps=max(r["out_max_ulps"] for r in fwd_rows if r["dtype"] == "bfloat16"),
        max_share_differing=max(r["out_share_differing"] for r in fwd_rows
                                if r["dtype"] == "bfloat16"),
        fp32_worst_err_over_tolerance=max(r["out_err"] / TOL_OUT_FP32 for r in fwd_rows
                                          if r["dtype"] == "float32"),
        lse_worst_err=max(r["lse_err"] for r in fwd_rows),
        same_bits_twice=all(r["fwd_same_bits_twice"] for r in fwd_rows),
        ms=per_step("fwd_ms"), plain_ms=per_step("fwd_plain_ms"),
        bound_ms=per_step("fwd_bound_ms"), bound_by=bound_by("fwd"),
        library_ms=per_step("fwd_library_ms"),
        own_bound_ms=per_step("fwd_own_bound_ms"), own_bound_by=bound_by("fwd_own"),
        per="training micro-step (B=5, 832x1344, bf16, dropout 0.1, 18 launches); bound_ms is "
            "the function's (two products), own_bound_ms the two-pass design's (three)",
        shapes=attn_rows, serve_shapes=serve_rows, learning_run_shapes=learn_rows,
        learning_run=learning_run(("fwd_ms", "fwd_plain_ms", "fwd_library_ms", "fwd_bound_ms")),
        serve_forward=dict(  # per serving forward (B=8, 800x1344, bf16)
            ms=serve_sum("kernel_ms"), plain_ms=serve_sum("plain_ms"),
            library_ms=serve_sum("library_ms"), bound_ms=serve_sum("bound_ms"),
            own_bound_ms=serve_sum("own_bound_ms")),
        **common))
    for name, key, grads in (("masked_attention_bwd_dkv", "dkv", ("dk", "dv")),
                             ("masked_attention_bwd_dq", "dq", ("dq",))):
        kernels.append(dict(
            name=name, source="detr_tpu_torch/csrc/masked_attention_bwd.cu",
            replaces=("detr_tpu/ops/pallas_attention.py:163 (_bwd_kernel), :272 "
                      "(_bwd_dkv_kernel)" if key == "dkv" else
                      "detr_tpu/ops/pallas_attention.py:163 (_bwd_kernel), :310 "
                      "(_bwd_dq_kernel)"),
            launches=sum(c[f"bwd_{key}"] for _, c in paths),
            launches_by_path={p: c[f"bwd_{key}"] for p, c in paths},
            max_abs_err=max(r[f"{x}_err"] for r in main_rows for x in grads),
            tolerance=f"{BF16_RULE}; fp32: 1e-4 of each gradient's max|plain|",
            max_ulps=max(r[f"{x}_max_ulps"] for r in bf16_rows for x in grads),
            max_share_differing=max(r[f"{x}_share_differing"] for r in bf16_rows for x in grads),
            fp32_worst_err_over_tolerance=max(
                r[f"{x}_err"] / max(r[f"{x}_tolerance"], 1e-30) for r in fp32_rows for x in grads),
            same_bits_twice=all(r["same_bits_twice"] for r in attn_rows),
            ms=per_step(f"{key}_ms"),
            # the plain and library backward compute dq, dk and dv together
            plain_ms=per_step("bwd_plain_ms"), bound_ms=per_step(f"{key}_bound_ms"),
            bound_by=bound_by(key), library_ms=per_step("bwd_library_ms"),
            # the whole backward: both kernels against the function's bound
            backward_ms=per_step("dkv_ms") + per_step("dq_ms"),
            backward_bound_ms=per_step("bwd_bound_ms"), backward_bound_by=bound_by("bwd"),
            learning_run=learning_run((f"{key}_ms", "bwd_plain_ms", "bwd_library_ms",
                                       f"{key}_bound_ms")),
            per="training micro-step (B=5, 832x1344, bf16, dropout 0.1, 18 launches); "
                "bound_ms is this kernel's own (it recomputes s and dP); plain_ms, "
                "library_ms and backward_* are whole backwards (dq, dk, dv)",
            **common))
    a = auction_rows[0]
    kernels.append(dict(
        name="auction_lap", source="detr_tpu_torch/csrc/auction_lap.cu",
        replaces="detr_tpu/matcher/pallas_auction.py:84",
        launches=sum(c["auction"] for _, c in paths),
        launches_by_path={p: c["auction"] for p, c in paths},
        max_abs_err=max(r["kernel_vs_plain_max_abs_err"] for r in auction_rows),
        tolerance=f"query_of_gt and rounds equal to the plain version's; total cost within "
                  f"2*n_valid*{EPS_MIN} of scipy's optimum, per problem",
        gap_to_scipy_over_bound=max(r["gap_over_bound"] for r in auction_rows),
        ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"], bound_by="bytes",
        library_ms=a["library_ms"], library="scipy.optimize.linear_sum_assignment (host)",
        rounds_per_phase_max=a["rounds_per_phase_max"], rounds_total_max=a["rounds_total_max"],
        us_per_round=a["us_per_round"], learning_run_cases=learn["auction_rows"],
        per="training micro-step (N=30 problems, Q=G=100, 1 launch); us_per_round is ms over "
            "the most rounds one problem ran", cases=auction_rows,
        **common))
    kernels += msda_kernels(msda_rows, common)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
