"""The port's validation path against the JAX package's: the COCO evaluator,
``DetectionMetrics``, ``run_validation``, the loss-dict tags, the step timer
and the tensorboard logger.

The evaluators run their numpy paths on the same detections (the JAX one
takes its native matcher where this machine builds it, which its own tests
hold equal to its numpy path) and are held to each other and to the
pycocotools-protocol oracle of ``tests/pycoco_oracle.py`` at 1e-9 on every
statistic.  ``run_validation`` runs a small DETR (ResNet-50 trunk, one
encoder and two decoder layers, hidden 16) whose weights come from a JAX init
through ``state_dict_from_jax``, on the same host batches for both packages.
"""

import dataclasses
import logging
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tpu.config import DETRConfig as JaxConfig
from detr_tpu.config import TrainingConfig as JaxTrainingConfig
from detr_tpu.eval.coco_eval import CocoEvaluator as JaxCocoEvaluator
from detr_tpu.eval.metrics import DetectionMetrics as JaxDetectionMetrics
from detr_tpu.models import DETR as JaxDETR
from detr_tpu.train.train_step import build_criterion as jax_build_criterion
from detr_tpu.train.train_step import make_eval_step as jax_make_eval_step
from detr_tpu.train.trainer import run_validation as jax_run_validation
from detr_tpu.utils import logging as jax_logging
from detr_tpu.utils import profiling as jax_profiling
from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.data import CocoDataset, get_val_transforms, make_eval_loader
from detr_tpu_torch.data.make_synthetic_coco import generate_split
from detr_tpu_torch.data.prefetch import DevicePlacement
from detr_tpu_torch.eval import CocoEvaluator, DetectionMetrics
from detr_tpu_torch.models import DETR, state_dict_from_jax
from detr_tpu_torch.ops.boxes import box_xyxy_to_cxcywh
from detr_tpu_torch.train import build_criterion, make_eval_step
from detr_tpu_torch.train.trainer import BATCH_KEYS, run_validation
from detr_tpu_torch.utils import logging as port_logging
from detr_tpu_torch.utils import profiling as port_profiling
from tests.pycoco_oracle import oracle_eval
from tests.test_coco_eval_differential import _random_scenario
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

STATS = ("AP", "AP50", "AP75", "AP-small", "AP-medium", "AP-large")
CPU = DevicePlacement("cpu", BATCH_KEYS)


def _evaluate(cls, images, num_classes):
    ev = cls(num_classes)
    for img in images:
        ev.add_image(img["image_id"], img["det_boxes"], img["det_scores"], img["det_labels"],
                     img["gt_boxes"], img["gt_labels"], img["gt_iscrowd"])
    return ev.compute()


def _check_three_ways(images, num_classes):
    """Every statistic of the port equal to JAX's and the oracle's to 1e-9,
    and the per-class APs to JAX's."""
    ours = _evaluate(CocoEvaluator, images, num_classes)
    jax_out = _evaluate(JaxCocoEvaluator, images, num_classes)
    ref = oracle_eval(images, num_classes)
    for k in STATS:
        assert ours[k] == pytest.approx(jax_out[k], abs=1e-9), (k, ours, jax_out)
        assert ours[k] == pytest.approx(ref[k], abs=1e-9), (k, ours, ref)
    np.testing.assert_allclose(ours["per_class"], jax_out["per_class"], atol=1e-9, rtol=0)
    return ours


@pytest.mark.parametrize("seed", range(12))
def test_coco_evaluator_matches_jax_and_oracle_random(seed):
    """Random scenarios biased to the protocol's edges: crowds, area-range
    boundaries, maxDets, zero-GT classes, empty images, score ties."""
    images, num_classes = _random_scenario(np.random.default_rng(seed), seed)
    _check_three_ways(images, num_classes)


def _image(i, det_boxes, det_scores, det_labels, gt_boxes, gt_labels, gt_iscrowd):
    return {"image_id": i, "det_boxes": np.asarray(det_boxes, float).reshape(-1, 4),
            "det_scores": np.asarray(det_scores, float), "det_labels": np.asarray(det_labels, int),
            "gt_boxes": np.asarray(gt_boxes, float).reshape(-1, 4),
            "gt_labels": np.asarray(gt_labels, int), "gt_iscrowd": np.asarray(gt_iscrowd, bool)}


def _maxdets_overflow():
    rng = np.random.default_rng(123)
    gt = np.array([[10.0, 10.0, 80.0, 80.0], [100.0, 100.0, 190.0, 190.0]])
    dets = np.tile(gt[0], (140, 1)) + rng.normal(0, 10, size=(140, 4))
    return [_image(0, dets, rng.random(140), np.zeros(140), gt, [0, 0], [False, False])], 1


def _all_crowd_and_zero_gt_class():
    return [_image(0, [[0.0, 0, 50, 50], [5.0, 5, 60, 60]], [0.9, 0.8], [0, 1],
                   [[0.0, 0, 50, 50]], [0], [True])], 2


def _crowd_denominator():
    return [_image(0, [[10.0, 10, 40, 40], [300.0, 300, 340, 330]], [0.9, 0.8], [0, 0],
                   [[0.0, 0, 200, 200], [300.0, 300, 340, 330]], [0, 0], [True, False])], 1


def _empty_images():
    return [_image(0, [], [], [], [[0.0, 0, 40, 40]], [0], [False]),
            _image(1, [[0.0, 0, 40, 40]], [0.5], [0], [], [], []),
            _image(2, [], [], [], [], [], [])], 1


def _area_ranges():
    # a small, a medium and a large GT, each found once; one FP per range
    gt = [[0.0, 0, 20, 20], [100.0, 100, 160, 160], [300.0, 300, 450, 450]]
    dets = gt + [[500.0, 0, 510, 10], [500.0, 100, 550, 150], [0.0, 500, 200, 700]]
    return [_image(0, dets, [0.9, 0.8, 0.7, 0.95, 0.85, 0.75], [0] * 6, gt, [0, 0, 0],
                   [False] * 3)], 1


EDGE_CASES = {
    "maxdets_overflow": _maxdets_overflow,
    "all_crowd_and_zero_gt_class": _all_crowd_and_zero_gt_class,
    "crowd_denominator": _crowd_denominator,
    "empty_images": _empty_images,
    "area_ranges": _area_ranges,
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_coco_evaluator_matches_jax_and_oracle_edge_cases(case):
    out = _check_three_ways(*EDGE_CASES[case]())
    if case == "all_crowd_and_zero_gt_class":
        assert out["AP"] == -1.0  # no countable GT anywhere
    if case == "crowd_denominator":
        assert out["AP"] == pytest.approx(1.0)  # the crowd detection is no FP


def test_detection_metrics_matches_jax_with_padding_and_auto_ids():
    """Two batches: the second padded by 2 (``pad_count``), some images
    without a dataset id (-1, which each get an id of their own), a class
    never seen (AP-per-class 0.0); every key equal to JAX's to 1e-12."""
    rng = np.random.default_rng(3)
    names = ["cat", "dog", "bird", "never"]
    ours, theirs = DetectionMetrics(names), JaxDetectionMetrics(names)
    for b, (ids, pad) in enumerate((([5, -1, 7], 0), ([-1, -1, 9, 9], 2))):
        B, G = len(ids), 4
        gt = rng.uniform(0, 200, size=(B, G, 2))
        boxes = np.concatenate([gt, gt + rng.uniform(10, 90, size=(B, G, 2))], -1)
        batch = {"image_id": np.array(ids, np.int32), "boxes": boxes.astype(np.float32),
                 "class_idx": rng.integers(0, 3, (B, G)), "iscrowd": rng.random((B, G)) < 0.2,
                 "gt_valid": rng.random((B, G)) < 0.8, "pad_count": np.int32(pad)}
        preds = [{"boxes": (boxes[i] + rng.normal(0, 5, size=(G, 4))).astype(np.float32),
                  "scores": rng.random(G).astype(np.float32),
                  "labels": rng.integers(0, 3, G)} for i in range(B)]
        ours.update(preds, batch)
        theirs.update(preds, batch)
    got, want = ours.compute(), theirs.compute()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert got["AP-per-class/never"] == 0.0
    assert sorted(ours.evaluator._image_ids) == sorted(theirs.evaluator._image_ids)
    ours.reset()
    assert ours.evaluator._image_ids == [] and ours._n_auto == 0


def test_format_loss_for_logging_matches_jax():
    rng = np.random.default_rng(0)
    loss = {}
    for base in ("loss_label_ce", "loss_l1_bbox", "loss_giou", "cardinality_error"):
        loss[base] = float(rng.random())
        for i in range(2):
            loss[f"{base}_{i}"] = float(rng.random())
    loss.update(class_error=12.5, diag_nonbg_frac=0.25, diag_max_prob=0.5)
    for split in ("train", "val"):
        assert port_logging.format_loss_for_logging(loss, split) == \
            jax_logging.format_loss_for_logging(loss, split)


def test_step_timer_matches_jax(monkeypatch):
    """The same tick times (perf_counter patched) give the same perf/*."""
    ticks = [10.0, 10.5, 10.75, 12.0, 12.1]
    outs = []
    for module in (port_profiling, jax_profiling):
        times = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(times))
        timer = module.StepTimer(5, ema=0.8)
        outs.append([timer.tick() for _ in ticks])
    assert outs[0] == outs[1]
    assert outs[0][0] == {} and outs[0][1]["perf/images_per_sec"] == pytest.approx(10.0)


def test_metric_logger_writes_events_or_is_a_noop(tmp_path, monkeypatch, caplog):
    """Event files when tensorboard imports; with the import refused, no
    writer and one INFO line, and every call a no-op."""
    tb = pytest.importorskip("torch.utils.tensorboard")
    logger = port_logging.MetricLogger(str(tmp_path / "on"))
    logger.log_scalars({"a/b": 1.0}, 0)
    logger.log_loss_dict({"loss_label_ce": 1.0, "loss_l1_bbox": 2.0, "loss_giou": 3.0,
                          "cardinality_error": 0.0}, 1)
    logger.log_image("grid", None, 1)
    logger.close()
    assert any(p.name.startswith("events") for p in (tmp_path / "on").iterdir())

    monkeypatch.delattr(tb, "SummaryWriter")
    with caplog.at_level(logging.INFO, logger="detr_tpu_torch.utils.logging"):
        off = port_logging.MetricLogger(str(tmp_path / "off"))
    assert off.writer is None
    assert [r for r in caplog.records if "not written" in r.getMessage()]
    off.log_scalars({"a": 1.0}, 0)
    off.close()
    assert not (tmp_path / "off").exists()
    assert port_logging.MetricLogger(None).writer is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with port_profiling.trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert (tmp_path / port_profiling.TRACE_FILE).stat().st_size > 0
    assert any("sum" in e.key for e in prof.key_averages())


# ---- run_validation ----

TINY = DETRConfig(num_object_queries=8, num_encoder_layers=1, num_decoder_layers=2,
                  num_attention_heads=2, hidden_size=16, ffn_scale_factor=2, num_classes=80,
                  dtype="float32")
JAX_TINY = JaxConfig(**{f.name: getattr(TINY, f.name) for f in dataclasses.fields(TINY)},
                     use_pallas_attention=False)


class _Recorder:
    """A MetricLogger stand-in that keeps what it is given."""

    def __init__(self):
        self.scalars = {}

    def log_scalars(self, scalars, step):
        self.scalars.update(scalars)

    def log_loss_dict(self, loss_dict, step, split="train"):
        self.scalars.update({f"{split}/{k}": v for k, v in loss_dict.items()})

    def log_image(self, *args):
        pass


@pytest.fixture(scope="module")
def val_batches(tmp_path_factory):
    """Seven COCO-format JPEGs through the port's val transform (64..96 px)
    and eval loader at 64x96 and 96x64, batch 3: each bucket's last batch
    padded."""
    root = str(tmp_path_factory.mktemp("coco"))
    generate_split(root, "validation", 7, seed=4)
    ds = CocoDataset(root, "validation", get_val_transforms(min_size=64, max_size=96))
    batches = list(make_eval_loader(ds, 3, max_gt=8, num_workers=0, shape=(64, 96)))
    assert sum(int(b["pad_count"]) for b in batches) == 3 * len(batches) - 7 > 0
    return batches, ds.class_names


def test_run_validation_matches_jax(val_batches):
    """Weights from a JAX init (identity frozen-BN statistics, as the train
    step's parity test keeps them); the same host batches through both
    loops.  Loss averages by image count (padding out) within 1e-4 of
    max(1, |value|); every AP key within 1e-6."""
    batches, names = val_batches
    jmodel = JaxDETR(JAX_TINY)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)),
                                     jnp.array([64]), jnp.array([96]))
    variables = jax.tree.map(np.asarray, variables)
    tc = TrainingConfig(max_gt_boxes=8)
    jtc = JaxTrainingConfig(max_gt_boxes=8)
    jstep = jax_make_eval_step(jmodel, jax_build_criterion(jtc, JAX_TINY))
    jrec, rec = _Recorder(), _Recorder()
    want = jax_run_validation((jstep, SimpleNamespace(params=variables["params"],
                                                      frozen=variables["frozen"])),
                              batches, names, tracker=jrec, log_images=False)

    model = DETR(TINY)
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["frozen"], TINY),
                          strict=True)
    got = run_validation(make_eval_step(model, build_criterion(tc, TINY)), batches, names, CPU,
                         tracker=rec)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert sorted(rec.scalars) == sorted(jrec.scalars) and "loss/total/val" in rec.scalars
    for k, v in jrec.scalars.items():
        assert rec.scalars[k] == pytest.approx(v, abs=1e-4 * max(1.0, abs(v))), k


def _perfect_eval_step(batch):
    """Each image's own GT as the model's output: one-hot logits on the GT
    class, its normalised XYXY box as cxcywh; the other queries confident
    no-object."""
    boxes, valid, cls = batch["boxes_normalized"], batch["gt_valid"], batch["class_idx"]
    B, G, _ = boxes.shape
    logits = torch.full((B, G, TINY.num_classes + 1), -10.0)
    logits[..., TINY.num_classes] = torch.where(valid, -10.0, 10.0)
    logits.scatter_(2, cls.long()[..., None], torch.where(valid, 10.0, -10.0)[..., None])
    pred = torch.where(valid[..., None], box_xyxy_to_cxcywh(boxes),
                       torch.tensor([0.5, 0.5, 0.01, 0.01]).expand(B, G, 4))
    return {"pred_logits": logits[:, None], "pred_boxes": pred[:, None]}, {}


def test_run_validation_perfect_predictor_reaches_ap1(tmp_path):
    """The chain of ``tests/test_eval_chain.py`` in the port: JPEGs ->
    ``CocoDataset`` -> val transform -> eval loader -> ``run_validation``
    -> ``PostProcess`` -> ``DetectionMetrics``.  A step that predicts each
    image's ground truth scores AP 1 (> 0.99, AP50 > 0.999), and so does
    every class present: a broken link anywhere drives it toward 0."""
    root = str(tmp_path / "coco")
    generate_split(root, "validation", 10, seed=3)
    ds = CocoDataset(root, "validation", get_val_transforms())
    loader = make_eval_loader(ds, batch_size=4, max_gt=25, num_workers=0)
    metrics = run_validation(_perfect_eval_step, loader, ds.class_names, CPU)
    assert metrics["AP50"] > 0.999, metrics["AP50"]
    assert metrics["AP"] > 0.99, metrics["AP"]
    seen = {int(c) for i in range(len(ds)) for c in np.atleast_1d(ds[i][1]["class_idx"])}
    assert seen
    for c in seen:
        assert metrics[f"AP-per-class/{ds.class_names[c]}"] > 0.99, c
