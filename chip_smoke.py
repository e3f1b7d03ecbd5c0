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
     S=4200 (B=2), at a fully masked image and at a ragged L=37 (bf16: at
     most 1 ulp per element and 1 % of elements differing; fp32: 1e-4), each
     kernel launched twice for the same bits; the autograd path on
     the card; the auction kernel against its plain version (the same
     assignments and rounds, the same bits twice) and scipy at N=30,
     Q=G=100 (the training step's matching, near-identical rows, and a dense
     batch with up to 100 valid GT) and at Q=2048, G=20 (the chunked build);
     times against the library yardsticks and the bounds, and the auction's
     microseconds per round.  Then ``--tiny``'s model (head size 8, padded
     to the kernels' 32): one fp32 train step with dropout on the card
     against the CPU, and the ``--tiny --synthetic`` CLI on the card (two
     micro-steps and one validation batch).
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
     epoch's checkpoint and one validation batch of 25 (outside the window):
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
     host seconds and peak device memory.
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
The line before the last is the JSON ``kernels`` report; the last line is
``{"ok": true, "device": {...}}``.  Weights are random, from seed 0.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import re
import shutil
import subprocess
import tempfile
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


def log(*args) -> None:
    print(*args, flush=True)


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
    """Where one batch-8 request's time goes, on the 800x1344 bucket: host
    transform of one 800x1067 image, batch assembly, host-to-device copy,
    and the forward's wall time (synchronised) against its device time
    (queued behind a device-side sleep, so host launch gaps do not count)."""
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


def _attention_bounds(dtype, b, lq, s, masked) -> dict:
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
    rows = b * H * D * elt
    stats = 4 * b * H * lq  # one fp32 per query row: lse, delta
    mask = b * s if masked else 0
    work = {  # name: (operations, bytes)
        "fwd": (4 * b * H * lq * s * D, rows * (2 * lq + 2 * s) + stats + mask),
        # s = q.k in each pass, O = P_d v
        "fwd_own": (6 * b * H * lq * s * D, rows * (2 * lq + 2 * s) + stats + mask),
        # s = q.k, dP = g.v, dV = P g, dQ = dS k, dK = dS q; q, g, dq, k, v,
        # dk, dv, lse, delta and the mask once each
        "bwd": (10 * b * H * lq * s * D, rows * (3 * lq + 4 * s) + 2 * stats + mask),
        # s = q.k, dP = g.v, dV += P g, dK += dS q
        "dkv": (8 * b * H * lq * s * D, rows * (2 * lq + 4 * s) + 2 * stats + mask),
        # s = q.k, dP = g.v, dQ += dS k
        "dq": (6 * b * H * lq * s * D, rows * (3 * lq + 2 * s) + 2 * stats + mask),
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


def phase_train_kernels() -> list[dict]:
    """The attention forward with dropout and the backward kernels against
    their plain versions on the card, at the training shapes."""
    from detr_tpu_torch.ops import masked_attention as ma

    mask = _mask_from_extent(TRAIN_B, 700, 1100, 26, 42)  # a 700x1100 image in 832x1344
    dc5_mask = _mask_from_extent(2, 800, 1067, 50, 84, stride=16)  # 800x1344 at stride 16
    edge_mask = _mask_from_extent(2, 700, 1100, 26, 42)
    edge_mask[1] = True  # one image with every key padded
    shapes = [  # (name, batch, Lq, S, mask, launches per micro-step, timed)
        ("encoder_self", TRAIN_B, TRAIN_TOKENS, TRAIN_TOKENS, mask, 6, True),
        ("decoder_cross", TRAIN_B, QUERIES, TRAIN_TOKENS, mask, 6, True),
        ("decoder_self", TRAIN_B, QUERIES, QUERIES, None, 6, True),
        ("dc5_encoder_self", 2, DC5_TOKENS, DC5_TOKENS, dc5_mask, 0, True),
        ("edge_fully_masked_ragged_L", 2, 37, TRAIN_TOKENS, edge_mask, 0, False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, b, lq, s, m, per_step, timed in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            q, g = (_rand(gen, (b, lq, H, D), dtype) for _ in range(2))
            k, v = (_rand(gen, (b, s, H, D), dtype) for _ in range(2))
            seed = 1234 + len(rows)
            out, lse = ma.forward_cuda(q, k, v, m, seed, RATE)
            fwd_again = ma.forward_cuda(q, k, v, m, seed, RATE)
            ref_out, ref_lse = ma.masked_attention_reference(q, k, v, m, seed, RATE)
            qc, kc, vc, gc, delta = ma.backward_inputs(q, k, v, g, out)
            dk, dv = ma.bwd_dkv_cuda(qc, kc, vc, m, gc, lse, delta, seed, RATE)
            dq = ma.bwd_dq_cuda(qc, kc, vc, m, gc, lse, delta, seed, RATE)
            again = (ma.bwd_dq_cuda(qc, kc, vc, m, gc, lse, delta, seed, RATE),
                     *ma.bwd_dkv_cuda(qc, kc, vc, m, gc, lse, delta, seed, RATE))
            ref = ma.masked_attention_backward_reference(q, k, v, m, g, out, lse, seed, RATE)
            torch.cuda.synchronize()
            row = dict(shape=name, dtype=str(dtype).replace("torch.", ""), B=b, H=H, L=lq, S=s,
                       D=D, masked=m is not None, dropout=RATE, launches_per_step=per_step,
                       lse_err=float((lse - ref_lse).abs().max()), lse_tolerance=TOL_LSE)
            ok = _out_check(row, out, ref_out) and row["lse_err"] <= TOL_LSE
            for key, got, want in (("dq", dq, ref[0]), ("dk", dk, ref[1]), ("dv", dv, ref[2])):
                ok = _grad_check(row, key, got, want) and ok
            # no atomics: a second launch gives the same bits
            row["fwd_same_bits_twice"] = torch.equal(fwd_again[0], out) and torch.equal(fwd_again[1], lse)
            row["same_bits_twice"] = all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))
            ok = ok and row["same_bits_twice"] and row["fwd_same_bits_twice"]
            if not ok:
                raise AssertionError(f"a kernel disagrees with its plain version: {row}")
            if name.startswith("edge") and not bool((lse[1] == torch.finfo(torch.float32).min).all()):
                raise AssertionError("fully masked rows must give lse == finfo(f32).min")
            if timed:
                seed_t = seed
                row["fwd_ms"] = device_time_ms(lambda: ma.forward_cuda(q, k, v, m, seed_t, RATE), 20)
                row["dkv_ms"] = device_time_ms(
                    lambda: ma.bwd_dkv_cuda(qc, kc, vc, m, gc, lse, delta, seed_t, RATE), 20)
                row["dq_ms"] = device_time_ms(
                    lambda: ma.bwd_dq_cuda(qc, kc, vc, m, gc, lse, delta, seed_t, RATE), 20)
                row["fwd_plain_ms"] = device_time_ms(
                    lambda: ma.masked_attention_reference(q, k, v, m, seed_t, RATE), 3)
                row["bwd_plain_ms"] = device_time_ms(
                    lambda: ma.masked_attention_backward_reference(
                        q, k, v, m, g, out, lse, seed_t, RATE), 3)
                # Yardstick: the library's fused attention with the boolean
                # mask and dropout; its backward alone (all of dq, dk, dv).
                qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
                gt = g.transpose(1, 2)
                am = None if m is None else ~m[:, None, None, :]
                row["fwd_library_ms"] = device_time_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                                           dropout_p=RATE), 20)
                lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am, dropout_p=RATE)
                row["bwd_library_ms"] = device_time_ms(
                    lambda: torch.autograd.grad(lib_out, (qt, kt, vt), gt, retain_graph=True), 20)
                del lib_out
                for kname, (t, by) in _attention_bounds(dtype, b, lq, s, m is not None).items():
                    row[f"{kname}_bound_ms"], row[f"{kname}_bound_by"] = t, by
            log(f"train kernel check: {json.dumps(row)}")
            rows.append(row)
            del q, k, v, g, out, lse, fwd_again, ref_out, ref_lse, qc, kc, vc, gc, delta, dk, dv, dq
            del ref, again
        torch.cuda.empty_cache()

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
    from scipy.optimize import linear_sum_assignment

    from detr_tpu_torch.matcher import auction as au

    rows = []
    for name, c, valid in auction_cases():
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
        rows.append(row)
    return rows


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
        worst = 0.0
        for key, want in cpu_m.items():
            base = re.sub(r"_\d+$", "", key)
            tol = 1e-3 * max(1.0, abs(want)) + flips.get(base, 0.0)
            diff = abs(card_m[key] - want)
            worst = max(worst, diff / tol)
            if not diff <= tol:
                raise AssertionError(f"train step {key}: card {card_m[key]} cpu {want}")
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
    worst = 0.0
    for key, want in results["cpu"].items():
        tol = 1e-3 * max(1.0, abs(want)) + flips.get(re.sub(r"_\d+$", "", key), 0.0)
        worst = max(worst, abs(results["card"][key] - want) / tol)
        if not abs(results["card"][key] - want) <= tol:
            raise AssertionError(f"tiny train step {key}: card {results['card'][key]} cpu {want}")

    steps = []
    make = trainer.make_train_step

    def counted(model, crit, canvas_map=None):
        step = make(model, crit, canvas_map)

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
                   keep: dict | None = None) -> dict:
    """``train_DETR`` at full width (DETR-R50, bf16, dropout 0.1) with every
    micro-step watched: launches, finite metrics, parameters changing at
    updates only, the batch's shape and its bytes; and the window of
    micro-steps 2-24 split into waiting for the next batch (the prefetch
    iterator's next()), the step (synchronised), the smoke's own checks, and
    the rest.  ``keep`` receives the first batch and the step's canvas map."""
    from detr_tpu_torch.config import DETRConfig
    from detr_tpu_torch.train import trainer

    k = config.gradient_accumulation_steps
    records, waits, first = [], [], {}
    make_step, prefetch = trainer.make_train_step, trainer.prefetch_to_device
    validate, validations = trainer.run_validation, []

    def watched_make_train_step(model, criterion, canvas_map=None):
        step = make_step(model, criterion, canvas_map)
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

    trainer.make_train_step, trainer.prefetch_to_device = watched_make_train_step, timed_prefetch
    trainer.run_validation = watched_validation
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()  # the path starts
        t0 = time.perf_counter()
        trainer.train_DETR(config, DETRConfig(), synthetic=synthetic)
        wall = time.perf_counter() - t0
        launches = _counts()  # and ends
    finally:
        trainer.make_train_step, trainer.prefetch_to_device = make_step, prefetch
        trainer.run_validation = validate

    n = config.limit_train_iters
    if len(records) != n:
        raise AssertionError(f"{label}: {len(records)} micro-steps instead of {n}")
    for i, r in enumerate(records):
        if r["launches"] != [18, 18, 18, 1]:
            raise AssertionError(f"{label} micro-step {i}: launches {r['launches']}, "
                                 "want [18, 18, 18, 1]")
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
        config = TrainingConfig(limit_train_iters=24, limit_val_iters=1, epochs=1, output_dir=out)
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
    saved, saves, validations, steps = [], [], [], []

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

    def counted_make_train_step(model, criterion, canvas_map=None):
        step = make_step(model, criterion, canvas_map)

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
        calls = []
        predict = engine._predict

        def recorded(*args):
            got = predict(*args)
            calls.append((args, got))
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
        for args, got in calls:
            with torch.inference_mode():
                o = reference(*(torch.from_numpy(a).cuda() for a in args[:3]))
                ref = postprocess_predictions(o["pred_logits"][:, -1], o["pred_boxes"][:, -1],
                                              *(torch.from_numpy(a).cuda() for a in args[3:]))
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
                                epochs=1, output_dir=out)
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
                                epochs=1, output_dir=out, device_resize=True)
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

    def watched_train(model, criterion, canvas_map=None):
        step = make_train(model, criterion, canvas_map)
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

    def watched_eval(model, criterion, canvas_map=None):
        step = make_eval(model, criterion, canvas_map)

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


def main() -> None:
    t_start = time.perf_counter()
    kind, smi = phase_device()
    phase_build()
    serve_rows = phase_kernels()
    phase_card_vs_cpu()
    serve_launches, engine = phase_serve(smi)
    phase_breakdown(engine, smi)
    del engine
    torch.cuda.empty_cache()
    attn_rows = phase_train_kernels()
    auction_rows = phase_auction_kernel(smi)
    phase_tiny_train_card_vs_cpu()
    phase_train_step_card_vs_cpu()
    train = phase_train(smi)
    torch.cuda.empty_cache()
    phase_trace(smi)
    torch.cuda.empty_cache()
    t_coco = time.perf_counter()
    root, t_gen = make_coco_data()
    try:
        coco = phase_train_coco(smi, root, t_gen)
        t_ckpt = time.perf_counter()
        ckpt = phase_checkpoint_serve(smi, root)
        torch.cuda.empty_cache()
        t_source = time.perf_counter()
        source = phase_train_source(smi, root, coco)
        torch.cuda.empty_cache()
        r101 = phase_cli_r101(smi, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t_end = time.perf_counter()
    log(f"wall: {t_end - t_start:.1f} s, of which phase 10 (COCO) {t_ckpt - t_coco:.1f} s, "
        f"phase 11 (checkpoint, validate, serve) {t_source - t_ckpt:.1f} s, "
        f"phase 12 (device resize, the R101 CLI) {t_end - t_source:.1f} s")

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
    paths = (("train", tl), ("train_coco", cl), ("checkpoint_validate_serve", kl),
             ("train_coco_source", sl), ("cli_r101", rl))
    common = dict(route="cuda", card=smi)
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
        shapes=attn_rows, serve_shapes=serve_rows,
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
        us_per_round=a["us_per_round"],
        per="training micro-step (N=30 problems, Q=G=100, 1 launch); us_per_round is ms over "
            "the most rounds one problem ran", cases=auction_rows,
        **common))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
