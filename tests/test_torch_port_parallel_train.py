"""The port's multi-rank trainer around the step: the criterion over a
data-parallel group, checkpoints across layouts, a resumed multi-rank run,
validation on ranks, the frozen-BN broadcast, and ``entry.py``.

Ranks are gloo processes on the CPU, spawned with a timeout each
(``torch_ranks.py``).  Tolerances:

  * the criterion with a group on 2 ranks' row blocks against the JAX
    criterion on the whole batch (a block with no GT, loader padding):
    every entry to 1e-5 relative, and each block's gradient of the total
    loss to 1e-5 of the largest JAX gradient: fp32 summation order;
  * checkpoints: bit for bit;
  * a resumed run against an uninterrupted one: bit for bit;
  * validation on 2 ranks against one process: the losses to 1e-5
    relative, the metrics to 1e-6 (the forward of a row block sums in
    another order);
  * calibration: every rank holds rank 0's statistics bit for bit, and
    they equal one process's calibration on rank 0's batch to 1e-4 of
    each tensor's largest value (the test process convolves on 2 threads,
    a rank on 1: another summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from detr_tpu.config import DETRConfig as JaxConfig
from detr_tpu.config import TrainingConfig as JaxTrainingConfig
from detr_tpu.losses.criterion import total_loss as jax_total_loss
from detr_tpu.train.train_step import build_criterion as jax_build_criterion
from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.data import synthetic_batch
from detr_tpu_torch.data.make_synthetic_coco import generate_split
from detr_tpu_torch.entry import dryrun_multichip
from detr_tpu_torch.parallel import shard_state_tp
from detr_tpu_torch.parallel.launch import spawn
from detr_tpu_torch.parallel.tp import TensorParallel
from detr_tpu_torch.train.trainer import build_model
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

TIMEOUT = 300.0
TINY = dict(num_object_queries=8, num_encoder_layers=1, num_decoder_layers=2,
            num_attention_heads=2, hidden_size=16, ffn_scale_factor=2, num_classes=7,
            dtype="float32")
SMALL_TRAIN = dict(cumulative_train_batch_size=2, train_batch_size=2, epochs=10,
                   lr_warmup_epochs=1, lr_hold_max_epochs=2)


def _tiny_state(**kw) -> dict:
    return {k: v.numpy() for k, v in build_model(DETRConfig(**TINY, **kw), 0).state_dict().items()}


def test_criterion_with_a_group_equals_the_jax_criterion_on_the_batch():
    """4 images on 2 ranks: rank 1's block holds no GT, and one of its
    images is loader padding."""
    rng = np.random.default_rng(0)
    B, L, Q, G, C = 4, 2, 8, 5, 7
    logits = rng.normal(size=(B, L, Q, C + 1)).astype(np.float32)
    boxes = rng.uniform(0.2, 0.8, size=(B, L, Q, 4)).astype(np.float32)
    xy = rng.uniform(0.0, 0.5, size=(B, G, 2))
    wh = rng.uniform(0.1, 0.5, size=(B, G, 2))
    gt_valid = np.zeros((B, G), bool)
    gt_valid[0, :3] = gt_valid[1, :5] = True
    targets = {"class_idx": rng.integers(0, C, size=(B, G)).astype(np.int32),
               "boxes_normalized": np.concatenate([xy, xy + wh], -1).astype(np.float32),
               "gt_valid": gt_valid, "image_valid": np.array([True, True, True, False])}
    qog = np.where(gt_valid[:, None, :],
                   np.stack([np.stack([rng.permutation(Q)[:G] for _ in range(L)])
                             for _ in range(B)]), -1).astype(np.int32)
    outputs = {"pred_logits": logits, "pred_boxes": boxes}
    spec = dict(config=dict(TINY), outputs=outputs, targets=targets, qog=qog)
    results = spawn(torch_ranks.criterion_rank, 2, args=(spec,), timeout=TIMEOUT)

    jcrit = dataclasses.replace(
        jax_build_criterion(JaxTrainingConfig(), JaxConfig(**TINY)),
        matcher=lambda *a: jnp.asarray(qog))
    jtargets = {k: jnp.asarray(v) for k, v in targets.items()}
    want = jcrit({k: jnp.asarray(v) for k, v in outputs.items()}, jtargets)
    jgrads = jax.grad(lambda o: jax_total_loss(jcrit(o, jtargets)))(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    for r, got in enumerate(results):
        assert set(got["losses"]) == set(want)
        for key, value in want.items():
            assert got["losses"][key] == pytest.approx(float(value), rel=1e-5, abs=1e-6), key
        for key, g in jgrads.items():
            g = np.asarray(g)
            np.testing.assert_allclose(got["grads"][key], g[2 * r:2 * r + 2], rtol=0,
                                       atol=1e-5 * float(np.abs(g).max()), err_msg=key)


def _ckpt_spec(tp: int, mode: str, directory: str) -> dict:
    return dict(config=dict(TINY), train=SMALL_TRAIN, state=_tiny_state(), tp=tp, mode=mode,
                dir=directory,
                batch=synthetic_batch(np.random.default_rng(1), 4, 64, 64, max_gt=5,
                                      num_classes=7))


def test_checkpoint_of_dp_x_tp_restores_into_one_process(tmp_path):
    """Written by 2 x 2 ranks (rank 0 alone writes), restored into one
    process: the parameters and moments the ranks gathered, bit for bit."""
    saved = spawn(torch_ranks.checkpoint_rank, 4, args=(_ckpt_spec(2, "save", str(tmp_path)),),
                  timeout=TIMEOUT)
    assert [r["written"] for r in saved] == [1, 0, 0, 0]
    one = torch_ranks.checkpoint_rank(0, _ckpt_spec(1, "restore", str(tmp_path)))
    assert one["written"] == 0 and one["step"] == 1 and one["updates"] == 1
    for kind in ("params", "moments"):
        assert set(one[kind]) == set(saved[0][kind])
        for name, want in saved[0][kind].items():
            assert np.array_equal(one[kind][name], want), (kind, name)


def test_checkpoint_of_one_process_restores_into_tp(tmp_path):
    """Written by one process, restored by 2 tensor-parallel ranks: each
    rank's slices of the parameters and moments are that rank's cut of the
    written tensors, bit for bit."""
    one = torch_ranks.checkpoint_rank(0, _ckpt_spec(1, "save", str(tmp_path)))
    assert one["written"] == 1
    ranks = spawn(torch_ranks.checkpoint_rank, 2, args=(_ckpt_spec(2, "restore", str(tmp_path)),),
                  timeout=TIMEOUT)
    for rank, got in enumerate(ranks):
        assert got["written"] == 0 and got["step"] == 1 and got["updates"] == 1
        tp = TensorParallel(None, rank, 2)
        for kind, local in (("params", "local_params"), ("moments", "local_moments")):
            want = shard_state_tp({k: torch.from_numpy(v) for k, v in one[kind].items()}, tp)
            assert set(got[local]) == set(want)
            for name, w in want.items():
                assert np.array_equal(got[local][name], w.numpy()), (kind, name)


def _run_config(out: str, epochs: int, **kw) -> dict:
    return dict(output_dir=out, epochs=epochs, limit_train_iters=2, train_batch_size=2,
                cumulative_train_batch_size=4, limit_val_iters=1, val_batch_size=2,
                eval_epochs=1, num_workers=0, prefetch_depth=0, shape_buckets=((64, 64),),
                max_gt_boxes=8, eval_shape=(64, 64), mixed_precision="no", log_frequency=1,
                watchdog_secs=0.0, host_rss_limit_gb=0.0, lr_warmup_epochs=1, **kw)


def test_resumed_tp_run_equals_an_uninterrupted_one(tmp_path):
    """Two tensor-parallel ranks, dropout 0.1, synthetic data: 2 epochs in
    one run against 1 epoch, then a relaunch that auto-restores it and
    trains the second; the last checkpoints bit for bit, and rank 1 returns
    {} from ``train_DETR``."""
    runs = [("whole", 2), ("part", 1), ("part", 2)]
    specs = [dict(config=dict(TINY), synthetic=True,
                  train=_run_config(str(tmp_path / name), epochs, model_parallel=2))
             for name, epochs in runs]
    results = spawn(torch_ranks.trainer_runs_rank, 2, args=(specs,), timeout=TIMEOUT)
    whole, _, resumed = results[0]
    assert whole["step"] == resumed["step"] == 4
    assert whole["metrics"] and set(whole["metrics"]) == set(resumed["metrics"])
    assert all(r["metrics"] == {} for r in results[1])
    for kind in ("params", "frozen"):
        for name, want in whole[kind].items():
            assert np.array_equal(resumed[kind][name], want), (kind, name)


def test_dp_calibration_broadcasts_rank_0s_statistics():
    """Two ranks calibrate on different batches, then hold rank 0's."""
    state = _tiny_state()
    batches = [synthetic_batch(np.random.default_rng(s), 2, 64, 64, max_gt=5, num_classes=7)
               for s in (3, 4)]
    spec = dict(config=dict(TINY), state=state, batches=batches)
    results = spawn(torch_ranks.calibration_rank, 2, args=(spec,), timeout=TIMEOUT)
    one = torch_ranks.calibration_rank(0, spec)  # rank 0's batch, one process
    other = torch_ranks.calibration_rank(1, spec)  # what rank 1 alone would hold
    moved = 0
    for name, want in one.items():
        assert np.array_equal(results[1][name], results[0][name]), name
        np.testing.assert_allclose(results[0][name], want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)
        moved += not np.allclose(other[name], want)
    assert moved > 0  # the two batches give different statistics


def test_validation_on_two_ranks_equals_one_process(tmp_path):
    """5 validation images, batches of 3 (the loader pads the second with
    one image), each padded to 4 rows for 2 ranks: rank 0's losses and
    metrics equal one process's, rank 1 returns {} and logs the same
    losses."""
    generate_split(str(tmp_path), "validation", 5, num_classes=7, boxes_per_image=(1, 4))
    train = dict(val_batch_size=3, num_workers=0, val_min_size=64, val_max_size=107,
                 eval_shape=(64, 128), max_gt_boxes=8)
    spec = dict(config=dict(TINY), train=train, state=_tiny_state(), tp=1, root=str(tmp_path))
    one = torch_ranks.validation_rank(0, spec)
    ranks = spawn(torch_ranks.validation_rank, 2, args=(spec,), timeout=TIMEOUT)
    assert ranks[1]["metrics"] == {}
    assert set(ranks[0]["metrics"]) == set(one["metrics"]) and one["metrics"]
    for key, want in one["metrics"].items():
        assert ranks[0]["metrics"][key] == pytest.approx(want, abs=1e-6), key
    for r in ranks:
        assert set(r["losses"]) == set(one["losses"]) and one["losses"]
        for key, want in one["losses"].items():
            assert r["losses"][key] == pytest.approx(want, rel=1e-5, abs=1e-6), key


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multichip(n):
    """``entry.dryrun_multichip``: one full-width train step on n gloo ranks
    (2: tp 2; 3: dp 3), a finite loss, one update, split parameters."""
    out = dryrun_multichip(n, timeout=TIMEOUT)
    assert np.isfinite(out["loss"])
    assert (out["dp"], out["tp"]) == ((1, 2) if n == 2 else (3, 1))


def test_single_process_config_keeps_one_rank():
    """No torchrun variables: the grid of one rank, no process group."""
    from detr_tpu_torch.train.trainer import make_grid

    grid = make_grid(TrainingConfig(), DETRConfig())
    assert (grid.world, grid.dp_size, grid.tp_size, grid.dp_group) == (1, 1, 1, None)
    with pytest.raises(ValueError, match="needs that many ranks"):
        make_grid(TrainingConfig(model_parallel=2), DETRConfig())
    with pytest.raises(ValueError, match="num_devices=2"):
        make_grid(TrainingConfig(num_devices=2), DETRConfig())
