"""The plain reference against the port's plain path on the CPU, at a tiny
transformer over the full ResNet-50 trunk, with the same weights.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tiny
from benchmark.reference import criterion as rc
from benchmark.reference import images as ri
from benchmark.reference import model as rm
from benchmark.reference import optim as ro
from benchmark.reference import weights

torch.set_num_threads(2)
CFGS = {"r50": tiny.MODEL, "dc5": dict(tiny.MODEL, dilation=True)}


def _port(cfg, sd):
    from detr_tpu_torch.config import DETRConfig
    from detr_tpu_torch.models.detr import DETR

    model = DETR(DETRConfig(**cfg))
    model.load_state_dict(sd, strict=True)
    return model


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 64, 96, 3, generator=g)
    h, w = torch.tensor([64, 50]), torch.tensor([80, 96])
    rows = torch.arange(64)[None, :, None] < h[:, None, None]
    cols = torch.arange(96)[None, None, :] < w[:, None, None]
    return torch.where((rows & cols)[..., None], x, 0.0), h, w


@pytest.mark.parametrize("name", sorted(CFGS))
def test_layout_is_the_ports_state_dict(name):
    cfg = CFGS[name]
    sd = weights.make(cfg, 3, "cpu")
    port = _port(cfg, sd).state_dict()
    assert list(sd) == list(port)
    assert all(sd[k].shape == port[k].shape for k in sd)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_eval_and_train(name):
    cfg = CFGS[name]
    sd = weights.make(cfg, 5, "cpu")
    model = _port(cfg, sd)
    x, h, w = _inputs()
    with torch.no_grad():
        model.eval()
        a, b = model(x, h, w), rm.forward(sd, cfg, x, h, w)
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-5)
        model.train()
        a = model(x, h, w, torch.Generator().manual_seed(9))
        seeds = rm.Seeds.draw(torch.Generator().manual_seed(9), rm.seeds_per_forward(cfg))
        b = rm.forward(sd, cfg, x, h, w, seeds=seeds)
        second = rm.forward(sd, cfg, x[1:], h[1:], w[1:], seeds=seeds, row_offset=1)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(a[k][1:], second[k], rtol=1e-4, atol=1e-5)


def test_loss_gradients_and_update():
    """The set loss and its gradients against the port's criterion with the
    exact assignment, then one clipped AdamW update against the port's."""
    from detr_tpu_torch.config import TrainingConfig
    from detr_tpu_torch.losses.criterion import SetCriterion, total_loss
    from detr_tpu_torch.matcher.hungarian import scipy_match_batch
    from detr_tpu_torch.train.optimizer import AccumulatingAdamW

    cfg = tiny.MODEL
    sd = weights.make(cfg, 7, "cpu")
    model = _port(cfg, sd)
    model.train()
    x, h, w = _inputs(1)
    g = torch.Generator().manual_seed(4)
    cls = torch.randint(0, 80, (2, 5), generator=g)
    xy = torch.rand(2, 5, 2, generator=g) * 0.5
    boxes = torch.cat([xy, xy + 0.1 + 0.3 * torch.rand(2, 5, 2, generator=g)], -1)
    valid = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], dtype=torch.bool)

    def exact(*args):
        return torch.as_tensor(scipy_match_batch(*(a.detach() for a in args)))

    crit = SetCriterion(num_classes=80, matcher=exact)
    out = model(x, h, w, torch.Generator().manual_seed(2))
    loss = total_loss(crit(out, {"class_idx": cls, "boxes_normalized": boxes, "gt_valid": valid}))
    params = [p for p in model.parameters() if p.requires_grad]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, params)

    ref = {n: t.clone() for n, t in sd.items()}
    for n in names:
        ref[n].requires_grad_(True)
    seeds = rm.Seeds.draw(torch.Generator().manual_seed(2), rm.seeds_per_forward(cfg))
    o = rm.forward(ref, cfg, x, h, w, seeds=seeds)
    costs = {"class": 1.0, "bbox": 5.0, "giou": 2.0}
    m = rc.assign(o["pred_logits"], o["pred_boxes"], cls, boxes, valid, costs)
    s = rc.sums(o["pred_logits"], o["pred_boxes"], cls, boxes, valid, m, 80, 0.1)
    ref_loss = rc.loss(s, rc.denominators(valid, cfg["num_object_queries"], 0.1),
                       {"ce": 1.0, "bbox": 5.0, "giou": 2.0})
    torch.testing.assert_close(ref_loss, loss, rtol=1e-5, atol=1e-6)
    ref_grads = torch.autograd.grad(ref_loss, [ref[n] for n in names])
    for n, a, b in zip(names, grads, ref_grads):
        torch.testing.assert_close(b, a, rtol=1e-3, atol=1e-7, msg=n)

    tc = TrainingConfig(lr=1e-4, lr_backbone=1e-5, gradient_max_norm=0.1,
                        train_batch_size=1, cumulative_train_batch_size=1)
    port_opt = AccumulatingAdamW(model, tc, {"backbone": 1e-5, "rest": 1e-4})
    port_opt.apply_gradients(list(grads))
    ref_opt = ro.AdamW({n: ref[n].detach() for n in names}, 1e-4, 1e-5, 1e-4, 0.1, 1)
    ref_opt.micro_step(dict(zip(names, grads)))
    for n, p in zip(names, params):
        torch.testing.assert_close(ref_opt.params[n], p.detach(), rtol=1e-5, atol=1e-8, msg=n)


def test_normalize_is_the_ports():
    from detr_tpu_torch.ops.image_norm import device_normalize_image

    g = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, (2, 32, 48, 3), generator=g, dtype=torch.uint8)
    h, w = torch.tensor([32, 20]), torch.tensor([40, 48])
    torch.testing.assert_close(ri.normalize(img, h, w), device_normalize_image(img, h, w),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((48, 64), (64, 85)), ((64, 48), (96, 72)),
                                     ((480, 640), (800, 1067)), ((427, 640), (800, 1199))])
def test_resize_is_the_ports(src, dst):
    """The triangle filter against the port's uint8 resize (its C++ op, or
    PIL's): the same to one level of uint8 rounding on a few pixels (the
    reference sums in float64, the C++ op in float32, so a value near .5
    rounds either way: 2.3 % of the pixels at 64x48 -> 96x72)."""
    from detr_tpu_torch.data.transforms import resize

    img = np.random.default_rng(0).integers(0, 256, (*src, 3), dtype=np.uint8)
    mine = ri.resize_uint8(torch.from_numpy(img), *dst).numpy().astype(int)
    port, _ = resize(img, {"boxes": np.zeros((0, 4), np.float32)}, *dst)
    diff = np.abs(mine - port.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05


def test_served_detections_are_the_engines():
    """The engine's answers on the CPU against the reference's, the whole
    serving path redone (resize, bucket, normalise, forward, postprocess)."""
    from detr_tpu_torch.config import DETRConfig
    from detr_tpu_torch.serve.engine import InferenceEngine

    cfg = tiny.MODEL
    tr = tiny.TRAFFIC["backlog"]
    sd = weights.make(cfg, 8, "cpu")
    engine = InferenceEngine(DETRConfig(**cfg), batch_size=2, buckets=tuple(map(tuple, tr["buckets"])),
                             min_size=tr["min_size"], max_size=tr["max_size"], device="cpu")
    engine.model.load_state_dict(sd)
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in tiny.SIZES]
    got = engine.predict(imgs)
    for img, det in zip(imgs, got):
        x, th, tw = ri.serve_input(img, "cpu", tr["min_size"], tr["max_size"],
                                   tuple(map(tuple, tr["buckets"])))
        with torch.no_grad():
            o = rm.forward(sd, cfg, x, torch.tensor([th]), torch.tensor([tw]))
        ref = ri.detections(o["pred_logits"][0, -1], o["pred_boxes"][0, -1], *img.shape[:2])
        np.testing.assert_allclose(det["scores"], ref["scores"].numpy(), atol=2e-4)
        np.testing.assert_allclose(det["boxes"], ref["boxes"].numpy(), atol=2e-3)
