"""The port's trainer against the JAX package's, on the CPU at the tiny size:
the CLI's mapping onto the two configurations (held against what the JAX
``main()`` hands its ``train_DETR``), ``derive_val_envelope`` and
``parse_shape_buckets``, the host-RSS tripwires, and a tiny
``--device-resize --cpu`` run on COCO-format JPEGs end to end.  The frozen-BN
recalibration is held in ``test_torch_port_checkpoint.py`` (with a resume),
the source-wire train step and ``norm_weight_decay`` in
``test_torch_port_train.py``.
"""

import dataclasses
import logging
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from detr_tpu.data import bucketing as jax_bucketing
from detr_tpu.train import trainer as jax_trainer
from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.data import bucketing
from detr_tpu_torch.data.make_synthetic_coco import generate_split
from detr_tpu_torch.train import trainer
from detr_tpu_torch.train.checkpoint import CheckpointManager
from detr_tpu_torch.utils.watchdog import WEDGED_EXIT_CODE
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

R101_ARGV = ["--backbone", "resnet101", "--device-resize", "--bn-recalibrate-epochs", "1",
             "--shape-buckets", "640x1088,1088x640", "--val-min-size", "640", "--lr", "1e-4",
             "--lr-backbone", "1e-5", "--set-cost-class", "2", "--eos-coef", "0.2",
             "--gradient-max-norm", "0.5", "--dropout", "0.0", "--epochs", "2",
             "--eval-epochs", "1", "--limit-train-iters", "4", "--limit-val-iters", "1",
             "--train-batch-size", "4", "--cumulative-train-batch-size", "8",
             "--val-batch-size", "5"]
ARGVS = {
    "defaults": [],
    "lr": ["--lr", "1e-4"],
    "lr_backbone": ["--lr-backbone", "2e-5"],
    "warmup_hold": ["--lr-warmup-epochs", "2", "--lr-hold-max-epochs", "7"],
    "costs": ["--set-cost-class", "2", "--set-cost-bbox", "4", "--set-cost-giou", "3"],
    "coefficients": ["--label-ce-loss-coef", "1.5", "--bbox-loss-coef", "4",
                     "--giou-loss-coef", "2.5", "--eos-coef", "0.2"],
    "clip": ["--gradient-max-norm", "0.5"],
    "backbone": ["--backbone", "resnet101"],
    "dropout": ["--dropout", "0.0"],
    "mid": ["--mid"],
    "tiny": ["--tiny"],
    "mid_tiny": ["--mid", "--tiny", "--train-batch-size", "3"],
    "device_resize": ["--device-resize"],
    "recalibrate": ["--bn-recalibrate-epochs", "3"],
    "val_min_size": ["--val-min-size", "640"],
    "eval_shape": ["--eval-shape", "384x640"],
    "val_min_size_and_eval_shape": ["--val-min-size", "512", "--eval-shape", "384x640"],
    "shape_buckets": ["--shape-buckets", "640x1088,1088x640,864x864"],
    # the derived source canvases of these two collide: both packages raise
    "colliding_source_canvases": ["--device-resize", "--shape-buckets", "832x1344,1344x832"],
    "run_flags": ["--synthetic", "--output-dir", "x/y", "--coco-dataset-root", "c",
                  "--seed", "3", "--start-epoch", "2", "--resume-from-checkpoint", "r",
                  "--no-photometric-distort", "--limit-train-iters", "5"],
    "r101_device_resize": R101_ARGV,
}


def _shared_fields(got, want) -> dict:
    names = {f.name for f in dataclasses.fields(got)} & {f.name for f in dataclasses.fields(want)}
    return {n: (getattr(got, n), getattr(want, n)) for n in sorted(names)}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_cli_configs_equal_jax_main(name, monkeypatch):
    argv = ARGVS[name]
    seen = []
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(jax_trainer, "train_DETR", lambda c, d, synthetic=False:
                        seen.append((c, d, synthetic)))
    monkeypatch.setattr(sys, "argv", ["detr_tpu.train.trainer", *argv])
    assert jax_trainer.main() == 0
    want_config, want_detr, want_synthetic = seen[0]
    args = trainer.get_args(argv)
    config, detr_config = trainer.configs_from_args(args)
    assert args.synthetic == want_synthetic
    for pair in (_shared_fields(config, want_config), _shared_fields(detr_config, want_detr)):
        assert pair and all(a == b for a, b in pair.values()), \
            {k: v for k, v in pair.items() if v[0] != v[1]}
    # every field of the port's two configurations is compared
    assert set(_shared_fields(config, want_config)) == {
        f.name for f in dataclasses.fields(TrainingConfig)}
    assert set(_shared_fields(detr_config, want_detr)) == {
        f.name for f in dataclasses.fields(DETRConfig)}
    if name == "colliding_source_canvases":
        for derive in (bucketing.derive_source_buckets, jax_bucketing.derive_source_buckets):
            with pytest.raises(ValueError, match="collide"):
                derive(config.shape_buckets)


@pytest.mark.parametrize("size", [320, 384, 480, 512, 600, 640, 700, 800, 1000])
def test_derive_val_envelope_equals_jax(size):
    assert trainer.derive_val_envelope(size) == jax_trainer.derive_val_envelope(size)


@pytest.mark.parametrize("spec", ["832x1344", "640x1088,1088x640", "384X640,640x384,512x512"])
def test_parse_shape_buckets_equals_jax(spec):
    assert trainer.parse_shape_buckets(spec) == jax_trainer.parse_shape_buckets(spec)


TINY = DETRConfig(num_object_queries=8, num_encoder_layers=1, num_decoder_layers=2,
                  num_attention_heads=2, hidden_size=16, ffn_scale_factor=2, dtype="float32")


@pytest.fixture
def out(tmp_path):
    """A run's output dir; a tiny model's checkpoint is ~280 MB, removed."""
    yield tmp_path / "run"
    shutil.rmtree(tmp_path, ignore_errors=True)


def _tiny(out, **kw):
    defaults = dict(output_dir=str(out), cumulative_train_batch_size=2, train_batch_size=2,
                    val_batch_size=2, epochs=2, limit_train_iters=2, limit_val_iters=1,
                    eval_epochs=5, log_frequency=1, shape_buckets=((64, 64),), max_gt_boxes=8,
                    mixed_precision="no", eval_shape=(64, 64), host_rss_limit_gb=1.0)
    defaults.update(kw)
    return TrainingConfig(**defaults)


def test_rss_tripwires_exit_42_and_the_relaunch_resumes(out, monkeypatch, caplog):
    """Between 1x and 1.25x the limit: exit 42 after epoch 0's checkpoint (no
    validation), and a relaunch auto-restores and trains epoch 1.  Above
    1.25x: exit 42 at the first log step, with no checkpoint."""
    rss = {"gb": 1.1}
    monkeypatch.setattr(trainer, "host_rss_gb", lambda: rss["gb"])
    validated = []
    run_validation = trainer.run_validation
    monkeypatch.setattr(trainer, "run_validation",
                        lambda *a, **k: validated.append(1) or run_validation(*a, **k))
    config = _tiny(out)
    with pytest.raises(SystemExit) as e:
        trainer.train_DETR(config, TINY, synthetic=True, device="cpu")
    assert e.value.code == WEDGED_EXIT_CODE
    assert CheckpointManager(config.output_dir).steps() == [0] and not validated

    rss["gb"] = 0.5
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="detr_tpu_torch.train.trainer"):
        metrics = trainer.train_DETR(config, TINY, synthetic=True, device="cpu")
    assert "auto-restored checkpoint at epoch 0; resuming from epoch 1" in caplog.text
    assert "epoch 0 step" not in caplog.text and "epoch 1 step 0" in caplog.text
    assert CheckpointManager(config.output_dir).steps() == [0, 1] and "AP" in metrics

    rss["gb"] = 1.3
    fresh = _tiny(out.parent / "fresh")
    with pytest.raises(SystemExit) as e:
        trainer.train_DETR(fresh, TINY, synthetic=True, device="cpu")
    assert e.value.code == WEDGED_EXIT_CODE
    assert CheckpointManager(fresh.output_dir).latest_step() is None


def test_device_resize_cli_trains_on_coco_data(out, monkeypatch):
    """``--tiny --device-resize --cpu`` on COCO-format JPEGs: two micro-steps
    on source-wire batches (uint8 source canvases with their extents, the
    JPEGs downscaled on the host to the 64x64 canvas first), finite losses,
    one validation batch on the source wire, a checkpoint and a heartbeat
    file; the loaders' workers gone afterwards."""
    import multiprocessing

    root = out.parent / "coco"
    generate_split(str(root), "train", 6)
    generate_split(str(root), "validation", 3)
    steps, evals = [], []
    make_train, make_eval = trainer.make_train_step, trainer.make_eval_step

    def watched_train(model, criterion, canvas_map=None):
        step = make_train(model, criterion, canvas_map)

        def run(state, batch):
            steps.append((sorted(batch), tuple(batch["image"].shape), batch["image"].dtype,
                          canvas_map))
            state, metrics = step(state, batch)
            steps[-1] += ({k: float(v) for k, v in metrics.items()},)
            return state, metrics

        return run

    def watched_eval(model, criterion, canvas_map=None):
        step = make_eval(model, criterion, canvas_map)
        return lambda batch: evals.append(tuple(batch["image"].shape)) or step(batch)

    monkeypatch.setattr(trainer, "make_train_step", watched_train)
    monkeypatch.setattr(trainer, "make_eval_step", watched_eval)
    assert trainer.main(["--tiny", "--cpu", "--device-resize", "--coco-dataset-root", str(root),
                         "--limit-train-iters", "2", "--epochs", "1", "--train-batch-size", "2",
                         "--limit-val-iters", "1", "--val-batch-size", "2",
                         "--output-dir", str(out)]) == 0
    assert len(steps) == 2 and evals == [(2, 64, 64, 3)]
    for keys, shape, dtype, canvas_map, metrics in steps:
        assert {"src_height", "src_width"} <= set(keys)
        assert shape == (2, 64, 64, 3) and dtype == torch.uint8
        assert canvas_map == {(64, 64): (64, 64)}
        assert all(np.isfinite(v) for v in metrics.values())
    assert CheckpointManager(str(out)).steps() == [0]
    assert (out / ".heartbeat").exists()
    assert not multiprocessing.active_children()
