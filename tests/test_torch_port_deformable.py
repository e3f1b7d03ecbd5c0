"""Deformable DETR in the port (``models.deformable_detr``,
``ops.ms_deform_attn``, the focal criterion and matcher, the third
learning-rate group, the sigmoid top-k postprocess) against the benchmark's
plain reference (``benchmark/reference/deformable.py``, ``focal.py``) and
an independent per-sample bilinear loop, on seeded random weights at a
small size on the CPU; the benchmark's driver rehearsed at a tiny size; the
trainer's CLI on the new configuration.

Every comparison is fp32 against fp32, so the tolerances are round-off:
the port and the reference sum the same products in another order (~1e-6
of the largest value through a few layers).  Rounding the operands to
fp8 (e4m3, 3 mantissa bits) moves them by ~1e-1, rounding to bf16 by
~1e-2: each tolerance below is far under both.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import deformable as rd  # noqa: E402
from benchmark.reference import deformable_weights as dw  # noqa: E402
from benchmark.reference import focal as rf  # noqa: E402
from benchmark.reference import model as rm  # noqa: E402
from detr_tpu_torch.config import DeformableDETRConfig, DETRConfig, TrainingConfig  # noqa: E402
from detr_tpu_torch.models import DETR, DeformableDETR, build_detector  # noqa: E402
from detr_tpu_torch.ops import ms_deform_attn as msda  # noqa: E402
from test_torch_threads import few_torch_threads  # noqa: E402,F401  (autouse)

# Full depth and levels, narrow widths: d 64 (2 heads of 32), 30 queries.
CFG = dict(backbone="resnet50", dilation=False, temperature=10000, num_object_queries=30,
           num_encoder_layers=2, num_decoder_layers=2, num_attention_heads=2, hidden_size=64,
           ffn_scale_factor=4, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
           box_embedding_mlp_num_layers=3, initializer_range=0.02, layer_norm_eps=1e-5,
           num_classes=7, dtype="float32", padding_mask_mode="full", num_feature_levels=4,
           enc_n_points=4, dec_n_points=4, focal_alpha=0.25, lr_linear_proj_mult=0.1)
H, W = 128, 192
HEIGHTS = torch.tensor([128, 90])  # valid ratios below 1 on every level of image 1
WIDTHS = torch.tensor([150, 192])


def port_config(cfg=CFG) -> DeformableDETRConfig:
    keys = {f.name for f in dataclasses.fields(DeformableDETRConfig)}
    return DeformableDETRConfig(**{k: v for k, v in cfg.items() if k in keys})


def _model(seed=3, cfg=CFG):
    sd = dw.make(cfg, seed, "cpu")
    model = build_detector(port_config(cfg))
    model.load_state_dict(sd, strict=True)
    return model, sd


def _images(seed=0):
    g = torch.Generator().manual_seed(seed)
    img = torch.randn(2, H, W, 3, generator=g)
    rows = torch.arange(H)[None, :, None] < HEIGHTS[:, None, None]
    cols = torch.arange(W)[None, None, :] < WIDTHS[:, None, None]
    return torch.where((rows & cols)[..., None], img, 0.0)


# ---------------------------------------------------------------- MSDA op


def _bilinear_loop(value, shapes, loc, attn):
    """out[b, q, h] = sum_{l, p} a * bilinear sample, one sample at a time
    in float64: px = x * W - 0.5, four corners, zero outside the map."""
    B, S, Hh, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    v, lc, a = value.double(), loc.double(), attn.double()
    out = torch.zeros(B, Lq, Hh, D, dtype=torch.float64)
    starts = msda.level_starts(shapes)
    for b in range(B):
        for q in range(Lq):
            for h in range(Hh):
                acc = torch.zeros(D, dtype=torch.float64)
                for lvl, (hl, wl) in enumerate(shapes):
                    for p in range(P):
                        px = lc[b, q, h, lvl, p, 0] * wl - 0.5
                        py = lc[b, q, h, lvl, p, 1] * hl - 0.5
                        x0, y0 = math.floor(px.item()), math.floor(py.item())
                        fx, fy = px - x0, py - y0
                        sample = torch.zeros(D, dtype=torch.float64)
                        for dy, wy in ((0, 1 - fy), (1, fy)):
                            for dx, wx in ((0, 1 - fx), (1, fx)):
                                yy, xx = y0 + dy, x0 + dx
                                if 0 <= yy < hl and 0 <= xx < wl:
                                    sample = sample + wy * wx * v[b, starts[lvl] + yy * wl + xx, h]
                        acc = acc + a[b, q, h, lvl, p] * sample
                out[b, q, h] = acc
    return out


def test_msda_plain_version_matches_a_bilinear_loop():
    """The op's CPU path (grid_sample per level) against the loop above,
    forward and the gradients of the value, the locations and the weights
    (the loop's by float64 autograd).  Locations sit on cell edges (x * W -
    0.5 an integer: power-of-two sizes, so both compute the pixel exactly,
    on the same side of the edge), on the map's border (-1 < px < 0) and
    outside it.  fp32 against float64: within 1e-5 of the largest value."""
    shapes = ((4, 8), (2, 4))
    B, Lq, Hh, D, P = 2, 5, 2, 3, 3
    S = sum(h * w for h, w in shapes)
    g = torch.Generator().manual_seed(1)
    value = torch.randn(B, S, Hh, D, generator=g)
    loc = torch.rand(B, Lq, Hh, 2, P, 2, generator=g) * 1.4 - 0.2
    # cell edges: x = k / (2 W) with k odd puts px on an integer
    loc[0, 0, 0, 0, 0] = torch.tensor([3 / 16, 5 / 8])
    loc[0, 1, 1, 1, 1] = torch.tensor([1 / 8, 3 / 4])
    loc[1, 2, 0, 0, 2] = torch.tensor([-1 / 16, 1 / 8])  # px = -1: one corner inside
    loc[1, 3, 1, 0, 0] = torch.tensor([1.0, 1.0])  # px = W - 0.5
    loc[1, 4, 0, 1, 1] = torch.tensor([1.3, -0.3])  # outside
    attn = torch.softmax(torch.randn(B, Lq, Hh, 2 * P, generator=g), -1).view(B, Lq, Hh, 2, P)
    grad = torch.randn(B, Lq, Hh, D, generator=g)

    ins = [t.clone().requires_grad_(True) for t in (value, loc, attn)]
    out = msda.ms_deform_attn(ins[0], shapes, ins[1], ins[2])
    got = torch.autograd.grad(out, ins, grad)
    ref_ins = [t.double().requires_grad_(True) for t in (value, loc, attn)]
    ref = _bilinear_loop(ref_ins[0], shapes, ref_ins[1], ref_ins[2])
    want = torch.autograd.grad(ref, ref_ins, grad.double())
    for a, b in [(out, ref), *zip(got, want)]:
        a, b = a.detach(), b.detach()
        assert float((a.double() - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_msda_counts_and_validates():
    from detr_tpu_torch.utils import profiling

    shapes = ((4, 4), (2, 2))
    value = torch.randn(1, 20, 2, 8)
    loc, attn = torch.rand(1, 3, 2, 2, 2, 2), torch.rand(1, 3, 2, 2, 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        msda.ms_deform_attn(value, shapes, loc, attn)
        spans = profiling.take_spans()
        traced = profiling.counters(traced=True)
    assert [s[0] for s in spans] == ["msda"]
    assert traced["msda.calls"] == 1 and traced["msda.samples"] == 1 * 3 * 2 * 2 * 2
    with pytest.raises(ValueError):
        msda.ms_deform_attn(value, ((4, 4), (2, 3)), loc, attn)
    with pytest.raises(ValueError):
        msda.ms_deform_attn(value, shapes, loc, attn[..., :1])


# ---------------------------------------------------------------- model


def test_forward_matches_the_reference():
    """Train-mode forward (dropout 0.1 from the same seeds) against the
    reference's on the same weights, valid ratios below 1: within 1e-5 of
    the largest logit and box."""
    model, sd = _model()
    img = _images()
    out = model.train()(img, HEIGHTS, WIDTHS, torch.Generator().manual_seed(7))
    seeds = rm.Seeds.draw(torch.Generator().manual_seed(7), rd.seeds_per_forward(CFG))
    with torch.no_grad():
        ref = rd.forward(sd, CFG, img, HEIGHTS, WIDTHS, rm.FP32, seeds)
    assert out["pred_logits"].shape == (2, 2, 30, 7) and out["pred_boxes"].shape == (2, 2, 30, 4)
    for k in ("pred_logits", "pred_boxes"):
        scale = float(ref[k].abs().max())
        assert float((out[k].detach() - ref[k]).abs().max()) <= 1e-5 * scale, k
    # and in eval mode, without dropout
    with torch.no_grad():
        out = model.eval()(img, HEIGHTS, WIDTHS)
        ref = rd.forward(sd, CFG, img, HEIGHTS, WIDTHS)
    scale = float(ref["pred_logits"].abs().max())
    assert float((out["pred_logits"] - ref["pred_logits"]).abs().max()) <= 1e-5 * scale


def test_factory_and_published_shapes():
    """The factory picks the module by the configuration's type; at the
    published widths the model has ~40M parameters (Table 1: 40M), the
    third LR group holds the sampling offsets and reference points, and
    tensor parallelism raises."""
    from detr_tpu_torch.train.optimizer import AccumulatingAdamW, lr_group

    assert isinstance(build_detector(DETRConfig(num_encoder_layers=1, num_decoder_layers=1)),
                      DETR)
    full = build_detector(DeformableDETRConfig())
    assert isinstance(full, DeformableDETR)
    n = sum(p.numel() for p in full.parameters())
    assert 39.5e6 < n < 40.5e6, n
    groups = {lr_group(name, full.linear_proj_names) for name, _ in full.named_parameters()}
    assert groups == {"backbone", "rest", "linear_proj"}
    opt = AccumulatingAdamW(full, TrainingConfig(), {"backbone": 2e-5, "rest": 2e-4})
    lrs = opt.get_learning_rates()
    assert lrs == {"backbone": 2e-5, "rest": 2e-4, "linear_proj": pytest.approx(2e-5)}
    names = {id(p): name for name, p in full.named_parameters()}
    proj = [names[id(p)] for g in opt.adamw.param_groups if g["name"] == "linear_proj"
            for p in g["params"]]
    assert len(proj) == 2 * 12 + 2 and all(
        "sampling_offsets" in x or x.startswith("reference_points") for x in proj)
    with pytest.raises(ValueError, match="tensor-parallel"):
        DeformableDETR(DeformableDETRConfig(), tp=object())


def test_reset_parameters_is_the_published_init():
    model = build_detector(port_config())
    model.reset_parameters(torch.Generator().manual_seed(0))
    layer = model.encoder[0].self_attention
    assert torch.all(layer.sampling_offsets.weight == 0)
    assert torch.all(layer.attention_weights.weight == 0)
    grid = layer.sampling_offsets.bias.view(2, 4, 4, 2)
    assert torch.allclose(grid[0, 0, :, 0], torch.tensor([1.0, 2.0, 3.0, 4.0]))  # head 0: +x
    assert torch.allclose(grid, dw.offset_grid(2, 4, 4), atol=1e-6)
    assert torch.allclose(model.class_embedding.bias, torch.full((7,), -math.log(99.0)))
    assert torch.all(model.bbox_embedding.net[-1].weight == 0)


# ------------------------------------------------------------ criterion


def _targets(seed=4, B=2, G=6, C=7):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(B, G, 2, generator=g) * 0.6
    wh = 0.05 + torch.rand(B, G, 2, generator=g) * 0.3
    boxes = torch.cat([xy, xy + wh], -1)
    valid = torch.arange(G)[None, :] < torch.tensor([[4], [6]])
    cls = torch.randint(0, C, (B, G), generator=g)
    return {"class_idx": cls, "boxes_normalized": boxes, "gt_valid": valid,
            "image_valid": torch.ones(B, dtype=torch.bool)}


def test_focal_cost_and_loss_match_the_reference():
    """The matcher's focal class cost against the reference's, element by
    element; then the criterion's loss, given the reference's exact
    assignment, against the reference's focal set loss (within 1e-6 of
    it), and the port's auction at a near-zero epsilon finding an
    assignment of the same cost."""
    from detr_tpu_torch.losses.criterion import SetCriterion, total_loss
    from detr_tpu_torch.matcher.hungarian import HungarianMatcher, compute_cost_matrix

    g = torch.Generator().manual_seed(2)
    B, L, Q, C = 2, 3, 30, 7
    logits = torch.randn(B, L, Q, C, generator=g) * 2
    boxes = torch.sigmoid(torch.randn(B, L, Q, 4, generator=g))
    t = _targets()
    costs = {"class": 2.0, "bbox": 5.0, "giou": 2.0}
    cost = compute_cost_matrix(logits[0, 0], boxes[0, 0], t["class_idx"][0],
                               t["boxes_normalized"][0], t["gt_valid"][0], 2.0, 5.0, 2.0, 0.25)
    want = rf.class_cost(logits[0, 0], 0.25)[:, t["class_idx"][0]]
    from benchmark.reference.criterion import cxcywh_to_xyxy, giou_pairwise, xyxy_to_cxcywh

    gb = t["boxes_normalized"][0]
    want = (2.0 * want + 5.0 * torch.cdist(boxes[0, 0], xyxy_to_cxcywh(gb), p=1)
            - 2.0 * giou_pairwise(cxcywh_to_xyxy(boxes[0, 0]), gb))
    want = torch.where(t["gt_valid"][0][None, :], want, 0.0)
    torch.testing.assert_close(cost, want, atol=1e-5, rtol=1e-5)

    matches = rf.assign(logits, boxes, t["class_idx"], t["boxes_normalized"],
                        t["gt_valid"], costs, 0.25)
    qog = torch.full((B, L, 6), -1, dtype=torch.int32)
    for b in range(B):
        for layer in range(L):
            rows, cols = matches[b][layer]
            qog[b, layer, torch.as_tensor(cols)] = torch.as_tensor(rows, dtype=torch.int32)
    criterion = SetCriterion(num_classes=C, matcher=lambda *a: qog, weight_label_ce=2.0,
                             weight_bbox_l1=5.0, weight_bbox_giou=2.0, focal_alpha=0.25)
    got = total_loss(criterion({"pred_logits": logits, "pred_boxes": boxes}, t))
    s = rf.sums(logits, boxes, t["class_idx"], t["boxes_normalized"], t["gt_valid"], matches,
                0.25)
    want = rf.loss(s, t["gt_valid"].float().sum(), {"ce": 2.0, "bbox": 5.0, "giou": 2.0})
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)

    auction = HungarianMatcher(2.0, 5.0, 2.0, eps_min=1e-7, focal_alpha=0.25)
    found = auction(logits, boxes, t["class_idx"][:, None].expand(B, L, 6),
                    t["boxes_normalized"][:, None].expand(B, L, 6, 4),
                    t["gt_valid"][:, None].expand(B, L, 6))
    for b in range(B):
        for layer in range(L):
            full = compute_cost_matrix(logits[b, layer], boxes[b, layer], t["class_idx"][b],
                                       t["boxes_normalized"][b], t["gt_valid"][b], 2.0, 5.0,
                                       2.0, 0.25)
            cols = torch.nonzero(t["gt_valid"][b]).flatten()
            rows, want_cols = matches[b][layer]
            best = float(full[torch.as_tensor(rows), torch.as_tensor(want_cols)].sum())
            mine = float(full[found[b, layer, cols].long(), cols].sum())
            assert mine <= best + 1e-4


def test_train_step_gradients_and_third_group_match_the_reference():
    """One ``make_train_step`` micro-step (accumulation 1, so it updates)
    of the port against the reference's forward, focal set loss, exact
    assignment and AdamW with the third group, from the same weights and
    dropout seeds: every leaf's gradient within 1e-4 of the largest leaf's
    norm (the auction at epsilon 1e-7 finds the exact assignment here),
    and every leaf's change after the update within 1e-3 of its norm, the
    sampling offsets' and reference points' at a tenth of the rate."""
    from detr_tpu_torch.train.optimizer import AccumulatingAdamW
    from detr_tpu_torch.train.train_step import TrainState, build_criterion, make_train_step

    train = dict(lr=2e-4, lr_backbone=2e-5, weight_decay=1e-4, gradient_max_norm=0.1,
                 set_cost_class=2.0, set_cost_bbox=5.0, set_cost_giou=2.0,
                 label_ce_loss_coef=2.0, bbox_loss_coef=5.0, giou_loss_coef=2.0)
    tc = TrainingConfig(**train, matcher_eps_min=1e-7, train_batch_size=2,
                        cumulative_train_batch_size=2)
    model, sd = _model(seed=5)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = AccumulatingAdamW(model, tc, {"backbone": tc.lr_backbone, "rest": tc.lr})
    state = TrainState(model, opt, torch.Generator().manual_seed(11))
    step = make_train_step(model, build_criterion(tc, port_config()))
    img = _images(1)
    batch = {"image": img, "height": HEIGHTS, "width": WIDTHS, **_targets(C=7)}
    captured = {}
    inner = opt.apply_gradients

    def capture(grads):
        captured["grads"] = [g.clone() for g in grads]
        return inner(grads)

    opt.apply_gradients = capture
    state, metrics = step(state, batch)

    sdr = {n: t.clone().requires_grad_(n in before) for n, t in sd.items()}
    names = [n for n in before]
    seeds = rm.Seeds.draw(torch.Generator().manual_seed(11), rd.seeds_per_forward(CFG))
    out = rd.forward(sdr, CFG, img, HEIGHTS, WIDTHS, rm.FP32, seeds)
    t = _targets(C=7)
    costs = {"class": 2.0, "bbox": 5.0, "giou": 2.0}
    matches = rf.assign(out["pred_logits"], out["pred_boxes"], t["class_idx"],
                        t["boxes_normalized"], t["gt_valid"], costs, 0.25)
    s = rf.sums(out["pred_logits"], out["pred_boxes"], t["class_idx"], t["boxes_normalized"],
                t["gt_valid"], matches, 0.25)
    loss = rf.loss(s, t["gt_valid"].float().sum(), {"ce": 2.0, "bbox": 5.0, "giou": 2.0})
    grads = torch.autograd.grad(loss, [sdr[n] for n in names], allow_unused=True)
    assert abs(float(metrics["loss"]) - float(loss.detach())) <= 1e-5 * float(loss.detach())
    norms = [float(g.norm()) for g in grads if g is not None]
    top = max(norms)
    for n, mine, want in zip(names, captured["grads"], grads):
        want = torch.zeros_like(mine) if want is None else want
        assert float((mine - want).norm()) <= 1e-4 * top, n

    ref_opt = rd.AdamW({n: sdr[n] for n in names}, **{k: train[k] for k in (
        "lr", "lr_backbone", "weight_decay")}, max_norm=0.1, every=1, lr_linear_proj_mult=0.1)
    assert ref_opt.lr["encoder.0.self_attention.sampling_offsets.weight"] == pytest.approx(2e-5)
    assert ref_opt.lr["reference_points.bias"] == pytest.approx(2e-5)
    ref_opt.micro_step({n: (torch.zeros_like(sdr[n]) if g is None else g)
                        for n, g in zip(names, grads)})
    params = dict(model.named_parameters())
    changes = {n: (params[n].detach() - before[n], sdr[n].detach() - sd[n]) for n in names}
    # Adam's first step is ~lr * sign(g): an element whose gradient is
    # round-off flips, so each leaf's change is compared as a norm, and a
    # leaf whose gradient is round-off (a key bias, which the softmax
    # cancels) is left out, as the benchmark's ``compare`` leaves it
    still = 1e-3 * float(np.median(norms))
    for (n, (mine, want)), g in zip(changes.items(), grads):
        if g is None or float(g.norm()) < still:
            continue
        assert float((mine - want).norm()) <= 1e-3 * float(want.norm()), n
    # the third group moved at a tenth of the rate: Adam's first step is ~lr per element
    off = changes["encoder.0.self_attention.sampling_offsets.bias"][0].abs().max()
    val = changes["encoder.0.self_attention.value_proj.bias"][0].abs().max()
    assert float(off) < 0.2 * float(val)


# ------------------------------------------------------------ postprocess


def test_sigmoid_top_k_postprocess_matches_a_direct_sort():
    from detr_tpu_torch.eval.postprocess import PostProcess, postprocess_predictions

    g = torch.Generator().manual_seed(3)
    B, Q, C, K = 2, 30, 7, 20
    logits = torch.randn(B, Q, C, generator=g)
    boxes = torch.sigmoid(torch.randn(B, Q, 4, generator=g))
    h, w = torch.tensor([480, 600]), torch.tensor([640, 400])
    got = postprocess_predictions(logits, boxes, h, w, sigmoid_top_k=K)
    for b in range(B):
        pairs = sorted(((float(torch.sigmoid(logits[b, q, c])), q, c)
                        for q in range(Q) for c in range(C)), reverse=True)[:K]
        np.testing.assert_allclose(got["scores"][b].numpy(), [p[0] for p in pairs], rtol=1e-6)
        assert got["labels"][b].tolist() == [p[2] for p in pairs]
        for k, (_, q, _) in enumerate(pairs):
            cx, cy, bw, bh = boxes[b, q].tolist()
            want = [(cx - bw / 2) * w[b], (cy - bh / 2) * h[b], (cx + bw / 2) * w[b],
                    (cy + bh / 2) * h[b]]
            np.testing.assert_allclose(got["boxes"][b, k].numpy(), want, rtol=1e-5, atol=1e-4)
    per_image = PostProcess(sigmoid_top_k=K)(logits, boxes, h, w, score_threshold=0.5)
    assert all((d["scores"] >= 0.5).all() and len(d["scores"]) <= K for d in per_image)


# ------------------------------------------------------ benchmark, trainer


def test_flop_count_is_the_counters():
    """``benchmark/flops_deformable.py``'s forward count against
    ``torch.utils.flop_counter`` over the port's eval forward at the
    published widths (the gathers of MSDA count nothing in either)."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import flops_deformable

    cfg = dict(CFG, hidden_size=256, num_attention_heads=8, num_object_queries=300,
               num_encoder_layers=6, num_decoder_layers=6, num_classes=80)
    model = build_detector(port_config(cfg)).eval()
    x = torch.zeros(1, 64, 96, 3)
    with FlopCounterMode(display=False) as counter:
        model(x, torch.tensor([64]), torch.tensor([96]))
    assert flops_deformable.forward_flops(cfg, 64, 96) == counter.get_total_flops()
    fwd, bwd = flops_deformable.msda_bounds(4, 23205, 23205, 8, 32, 4, 4)
    # bytes bound both at the cell's shapes: ~238 MB forward at 3.35 TB/s
    assert fwd == pytest.approx((4 * 23205 * 8 * 32 * 2 * 2 + 4 * 23205 * 8 * 16 * 12)
                                / 3.35e12)
    assert bwd > 1.8 * fwd


def test_benchmark_driver_rehearsal_on_the_cpu():
    """The cell's driver end to end at a tiny size on the CPU: the checked
    steps, the window, the fp32 reference, and the comparison, which reads
    round-off (fp32 on both sides, a near-exact matcher)."""
    import copy
    import json
    import time

    from benchmark import harness
    from benchmark.drivers import train_deformable

    cfg = copy.deepcopy(json.loads((ROOT / "benchmark/configs/deformable_detr_r50.json")
                                   .read_text()))
    # d 64 in 32 groups: GroupNorm over 2 channels; at the 128x192 canvas the
    # fourth level is 2x3, so each group holds 12 values (over 2 values, as
    # a 1x2 level with one channel per group has, a group's variance can
    # vanish and its backward amplifies round-off ~1e3-fold)
    cfg["model"] = dict(cfg["model"], hidden_size=64, num_attention_heads=2,
                        num_object_queries=12, num_encoder_layers=1, num_decoder_layers=1,
                        dtype="float32")
    cfg["train"]["matcher_eps_min"] = 1e-7
    traffic = dict(json.loads((ROOT / "benchmark/traffic/train_deformable_resident.json")
                              .read_text()), micro_batch=2, accumulation=2, canvas=[128, 192],
                   batches=4, boxes_per_image_mean=3, max_gt=8, reference_rows=1,
                   trace_micro_steps=2)
    limits = {"loss_gap": {"limit": 1e-4}, "grad_gap": {"limit": 1e-3},
              "change_gap": {"limit": 1e-3}, "grad_gap_median": {"limit": 1e-4},
              "change_gap_median": {"limit": 1e-4}}
    run = harness.Run({"name": "tiny_deformable", "chips": 1}, cfg, traffic, 2**31 + 7, 1.0,
                      True, time.perf_counter(), limits)
    torch.set_num_threads(2)
    train_deformable.run(run, torch.device("cpu"))
    assert run.correct, run.checks
    assert set(run.checks) == set(limits)
    assert run.attempted > 0 and run.failed == 0
    assert run.record["msda_calls"] == 2 * 2  # encoder and decoder, 2 micro-steps
    assert run.record["msda_bound_s"] > 0


def test_trainer_cli_trains_deformable_detr(tmp_path):
    """The trainer's CLI on the new configuration: a few micro-steps on
    synthetic data at the tiny size, a finite loss that falls from the
    first to the last step, a checkpoint and one validation."""
    from detr_tpu_torch.train import trainer

    losses = []
    inner = trainer.make_train_step

    def recording(*args, **kw):
        step = inner(*args, **kw)

        def wrapped(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics

        return wrapped

    argv = ["--architecture", "deformable_detr", "--synthetic", "--tiny", "--cpu",
            "--limit-train-iters", "8", "--epochs", "1", "--train-batch-size", "2",
            "--limit-val-iters", "1", "--val-batch-size", "2", "--lr", "1e-3",
            "--output-dir", str(tmp_path / "run")]
    args = trainer.get_args(argv)
    config, detr_config = trainer.configs_from_args(args)
    assert isinstance(detr_config, DeformableDETRConfig)
    assert config.set_cost_class == 2.0 and config.label_ce_loss_coef == 2.0
    trainer.make_train_step = recording
    try:
        metrics = trainer.train_DETR(config.replace(lr_warmup_epochs=0), detr_config,
                                     synthetic=True, device="cpu")
    finally:
        trainer.make_train_step = inner
    assert len(losses) == 8 and all(math.isfinite(x) for x in losses)
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert "AP" in metrics
    assert (tmp_path / "run" / "checkpoints").exists()
