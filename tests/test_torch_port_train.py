"""The port's training path against the JAX package's: synthetic data,
frozen-BN calibration, the optimizer, one train step, and the trainer CLI.

The train step is held against ``detr_tpu.train.make_train_step`` from the
same weights (carried by ``state_dict_from_jax``), fp32, dropout 0, with the
same injected assignment on both sides, at accumulation 1 and 2 (optax
``MultiSteps``), on a synthetic fp32 batch and on the COCO loader's first
uint8 batch (normalised by each step).  A small DETR: ResNet-50 trunk at
64x64, one encoder and two decoder layers, hidden 64, 2 heads of 32.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from detr_tpu.config import DETRConfig as JaxConfig
from detr_tpu.config import TrainingConfig as JaxTrainingConfig
from detr_tpu.data import synthetic_batch as jax_synthetic_batch
from detr_tpu.models import DETR as JaxDETR
from detr_tpu.models import calibrate_frozen_bn as jax_calibrate
from detr_tpu.train import build_optimizer as jax_build_optimizer
from detr_tpu.train import make_train_step as jax_make_train_step
from detr_tpu.train.optimizer import _is_norm_path, set_learning_rates
from detr_tpu.train.train_step import TrainState as JaxTrainState
from detr_tpu.train.train_step import build_criterion as jax_build_criterion
from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.data import BucketedLoader, CocoDataset, get_train_transforms, synthetic_batch
from detr_tpu_torch.data.make_synthetic_coco import generate_split
from detr_tpu_torch.models import DETR, calibrate_frozen_bn, state_dict_from_jax
from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, make_train_step
from detr_tpu_torch.train import trainer
from detr_tpu_torch.train.trainer import to_device
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

SMALL = DETRConfig(
    num_object_queries=8, num_encoder_layers=1, num_decoder_layers=2, num_attention_heads=2,
    hidden_size=64, ffn_scale_factor=2, num_classes=7, dtype="float32",
    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
)
JAX_SMALL = JaxConfig(**{f.name: getattr(SMALL, f.name) for f in dataclasses.fields(SMALL)})
G = 5


def _train_configs(accum):
    kw = dict(cumulative_train_batch_size=2 * accum, train_batch_size=2, epochs=10,
              lr_warmup_epochs=1, lr_hold_max_epochs=2)
    return TrainingConfig(**kw), JaxTrainingConfig(**kw)


def _batch(seed):
    return synthetic_batch(np.random.default_rng(seed), 2, 64, 64, max_gt=G, num_classes=7)


def test_synthetic_batch_is_the_jax_packages():
    for learnable in (False, True):
        ours = synthetic_batch(np.random.default_rng(3), 3, 40, 56, 6, 9, learnable=learnable)
        ref = jax_synthetic_batch(np.random.default_rng(3), 3, 40, 56, 6, 9, learnable=learnable)
        assert sorted(ours) == sorted(ref)
        for key in ref:
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


@pytest.fixture(scope="module")
def jax_start():
    """JAX DETR weights from its own init (jitted: one compile instead of
    one per op), frozen-BN stats calibrated on the first batch, and the
    identity statistics of its init; as numpy trees.  Every test of the
    module starts from these."""
    model = JaxDETR(JAX_SMALL)
    batch = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), batch["image"], batch["height"],
                                    batch["width"])
    cal = jax_calibrate(JAX_SMALL, variables, batch["image"])
    return (jax.tree.map(np.asarray, variables["params"]), jax.tree.map(np.asarray, cal["frozen"]),
            jax.tree.map(np.asarray, variables["frozen"]))


def test_calibrate_frozen_bn_matches_jax(jax_start):
    """The port's calibration from the same conv weights gives the JAX
    package's statistics: rtol 1e-3 and atol 1e-3 of each tensor's largest
    value (the trunk's summation-order drift)."""
    params, frozen, identity = jax_start
    model = DETR(SMALL)
    model.load_state_dict(state_dict_from_jax(params, identity, SMALL))
    calibrate_frozen_bn(model.backbone.backbone, torch.from_numpy(_batch(0)["image"]))
    want = state_dict_from_jax(params, frozen, SMALL)
    got = model.state_dict()
    for key in want:
        if key.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got[key], want[key], rtol=1e-3,
                                       atol=1e-3 * float(want[key].abs().max()))


def _flip_aware_close(got: dict, want: dict, lr: dict, before: dict):
    """Parameters after an AdamW update.  Its first step moves each element
    by about lr * sign(g): an element whose gradient is at the noise floor
    (the key projection's bias has a zero gradient in exact arithmetic) may
    move the other way in the other framework, at most 2 lr apart.  The
    rest agree to 1e-6, and at most 1% of the elements may be such flips."""
    n_all = n_far = moved = tensors = 0
    for key, w in want.items():
        if key.endswith(("running_mean", "running_var")) or ".bn" in key or "downsample.1" in key:
            continue
        rate = lr["backbone" if key.startswith("backbone.") else "rest"]
        diff = (got[key] - w).abs()
        assert float(diff.max()) <= 2.002 * rate + 1e-6, key
        tensors += 1
        moved += not torch.equal(got[key], before[key])
        n_all += diff.numel()
        n_far += int((diff > 1e-6).sum())
    assert n_far <= 0.01 * n_all, (n_far, n_all)
    # All but a few move.  The first decoder layer starts from zeros, so its
    # self-attention sees one value everywhere: the gradients of its q, k,
    # v and output weights and of its norm1/norm2 weights are exactly 0
    # (8 of 136 tensors here), and a decay of lr * 1e-4 is below their ulp.
    assert moved >= 0.9 * tensors, (moved, tensors)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(jax_start, accum):
    """Loss dict and grad_norm per micro-step at rtol 2e-3 (argmax-based
    entries allowed one flip); the parameters unchanged until the update,
    then as ``_flip_aware_close`` says.  The trunk keeps its identity
    frozen-BN statistics here: calibrated on this very 64x64 batch it is so
    ill-conditioned that both frameworks' fp32 trunk gradients sit 2-3% from
    an fp64 computation of them (measured), which would swamp the
    comparison."""
    _check_train_step(jax_start, _batch(0), accum)


def test_train_step_on_a_coco_loader_batch_matches_jax(jax_start, tmp_path):
    """The slice as a whole: the port's COCO loader (JPEGs, the training
    augmentation, one 64x64 bucket as ``--tiny`` has, uint8 on the wire)
    makes the first batch, and both train steps take it as it is, each
    normalising it on its device; the same tolerances as the synthetic case
    above (rtol 2e-3, one argmax flip, ``_flip_aware_close``)."""
    generate_split(str(tmp_path), "train", 4, num_classes=7, boxes_per_image=(1, G + 1))
    ds = CocoDataset(str(tmp_path), "train", get_train_transforms(seed=0, normalize=False))
    batches = BucketedLoader(ds, 2, buckets=((64, 64),), max_gt=G, num_workers=0,
                             image_dtype="uint8")
    batch = next(iter(batches))
    assert batch["image"].dtype == np.uint8 and batch["gt_valid"].any()
    _check_train_step(jax_start, batch, 1)


def test_train_step_on_a_source_wire_batch_matches_jax(jax_start, tmp_path):
    """The device-resize wire: the port's loader ships the first batch's
    source pixels in a 48x48 canvas (the generator's JPEGs are larger, so
    the host downscales them to fit first), and both steps, built with the
    same ``canvas_map``, resample them into the 64x64 bucket on their device
    and normalise; the same tolerances as above."""
    generate_split(str(tmp_path), "train", 4, num_classes=7, boxes_per_image=(1, G + 1))
    ds = CocoDataset(str(tmp_path), "train",
                     get_train_transforms(seed=0, normalize=False, emit_source=True))
    batches = BucketedLoader(ds, 2, buckets=((64, 64),), max_gt=G, num_workers=0,
                             wire="source", source_buckets=((48, 48),))
    batch = next(iter(batches))
    assert batch["image"].shape[1:3] == (48, 48) and batch["gt_valid"].any()
    assert (batch["height"] > batch["src_height"]).any()
    _check_train_step(jax_start, batch, 1, canvas_map={(48, 48): (64, 64)})


def _check_train_step(jax_start, batch, accum, canvas_map=None):
    params, _, frozen = jax_start
    tc, jtc = _train_configs(accum)
    # the same batch every micro-step, as tests/test_train_step.py accumulates
    rng = np.random.default_rng(4)
    qog = np.where(batch["gt_valid"][:, None, :],
                   np.stack([np.stack([rng.permutation(8)[:G] for _ in range(2)])
                             for _ in range(2)]), -1).astype(np.int32)

    model = JaxDETR(JAX_SMALL)
    tx, _ = jax_build_optimizer(jtc)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, params)
    # create_train_state's state, from the shared start instead of a new init
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           frozen=jax.tree.map(jnp.asarray, frozen), opt_state=tx.init(jparams),
                           rng=jax.random.PRNGKey(0), tx=tx)
    port = DETR(SMALL)
    port.load_state_dict(state_dict_from_jax(params, frozen, SMALL), strict=True)
    opt, _ = build_optimizer(port, tc)
    state = TrainState(port, opt, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in port.state_dict().items()}

    jcrit = dataclasses.replace(jax_build_criterion(jtc, JAX_SMALL),
                                matcher=lambda *a: jnp.asarray(qog))
    jstep = jax_make_train_step(model, jcrit, donate=False, canvas_map=canvas_map)
    crit = dataclasses.replace(build_criterion(tc, SMALL),
                               matcher=lambda *a: torch.from_numpy(qog))
    step = make_train_step(port, crit, canvas_map=canvas_map)
    for i in range(accum):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, to_device(batch, torch.device("cpu")))
        assert set(m) == set(jm)
        for key in jm:
            tol = 2e-3 * max(1.0, abs(float(jm[key])))
            if key.startswith(("cardinality_error", "class_error", "diag_nonbg")):
                tol += 100.0 / 8  # one argmax flip among the queries
            assert float(m[key]) == pytest.approx(float(jm[key]), abs=tol), key
        if i < accum - 1:  # MultiSteps: no update before the k-th micro-step
            for key, value in port.state_dict().items():
                assert torch.equal(value, before[key]), key
    assert state.step == accum and opt.updates == 1
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params),
                               jax.tree.map(np.asarray, jstate.frozen), SMALL)
    _flip_aware_close(port.state_dict(), want, opt.get_learning_rates(), before)


def test_optimizer_matches_optax_on_the_same_gradients(jax_start):
    """Given identical gradients, two accumulated micro-steps and the update
    (clip on the averaged gradient, two LR groups, weight decay): rtol 1e-5,
    atol 1e-6 against optax's chain on the parameters after the update."""
    params, frozen, _ = jax_start
    tc, jtc = _train_configs(2)
    jtc = jtc.replace(gradient_max_norm=0.05)  # make the clip bite
    tc = tc.replace(gradient_max_norm=0.05)
    port = DETR(SMALL)
    port.load_state_dict(state_dict_from_jax(params, frozen, SMALL))
    opt, _ = build_optimizer(port, tc)
    opt.set_learning_rates({"backbone": 1e-3, "rest": 1e-2})
    tx, _ = jax_build_optimizer(jtc)
    jparams = jax.tree.map(jnp.asarray, params)
    ostate = tx.init(jparams)
    update = jax.jit(tx.update)
    ostate = set_learning_rates(ostate, {"backbone": 1e-3, "rest": 1e-2})
    rng = np.random.default_rng(5)
    names = [n for n, p in port.named_parameters()]
    for _ in range(2):
        jgrads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * 1e-3),
                              jparams)
        updates, ostate = update(jgrads, ostate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        # the same gradients in the port's parameter order
        sd_grads = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), frozen, SMALL)
        opt.apply_gradients([sd_grads[n] for n in names])
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams), frozen, SMALL)
    for n, p in port.named_parameters():
        torch.testing.assert_close(p.detach(), want[n], rtol=1e-5, atol=1e-6)


def test_norm_weight_decay_matches_optax(jax_start):
    """``norm_weight_decay=0.0`` beside a weight decay of 0.5: the port
    decays the same tensors as the JAX package's ``_is_norm_path`` (mapped
    through ``state_dict_from_jax``), and one AdamW update from the same
    gradients equals optax's within 1e-6."""
    params, frozen, _ = jax_start
    kw = dict(cumulative_train_batch_size=2, train_batch_size=2, weight_decay=0.5,
              norm_weight_decay=0.0)
    tc, jtc = TrainingConfig(**kw), JaxTrainingConfig(**kw)
    port = DETR(SMALL)
    port.load_state_dict(state_dict_from_jax(params, frozen, SMALL))
    opt, _ = build_optimizer(port, tc)
    # the norm-decayed set: JAX's paths, carried to the port's names
    flags = state_dict_from_jax(
        jax.tree_util.tree_map_with_path(
            lambda path, p: np.full(p.shape, float(_is_norm_path(path)), np.float32), params),
        frozen, SMALL)
    want_norm = {n for n, _ in port.named_parameters() if bool(flags[n].all())}
    assert all(not flags[n].any() for n, _ in port.named_parameters() if n not in want_norm)
    decayed_at = {n: g["weight_decay"] for g in opt.adamw.param_groups for n, p in
                  port.named_parameters() if any(p is q for q in g["params"])}
    assert {n for n, wd in decayed_at.items() if wd == 0.0} == want_norm
    assert len(want_norm) == 2 * (2 * 1 + 3 * 2 + 2)  # LayerNorms of 1+2 layers, 2 final
    assert all(opt.state_dict()["adamw"]["param_groups"][i]["weight_decay"] in (0.5, 0.0)
               for i in range(3))

    opt.set_learning_rates({"backbone": 1e-3, "rest": 1e-2})
    tx, _ = jax_build_optimizer(jtc)
    jparams = jax.tree.map(jnp.asarray, params)
    ostate = set_learning_rates(tx.init(jparams), {"backbone": 1e-3, "rest": 1e-2})
    rng = np.random.default_rng(6)
    jgrads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)
                                                * 1e-3), jparams)
    updates, _ = jax.jit(tx.update)(jgrads, ostate, jparams)
    jparams = optax.apply_updates(jparams, updates)
    sd_grads = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), frozen, SMALL)
    opt.apply_gradients([sd_grads[n] for n, _ in port.named_parameters()])
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams), frozen, SMALL)
    for n, p in port.named_parameters():
        torch.testing.assert_close(p.detach(), want[n], rtol=1e-6, atol=1e-6)


def test_train_mode_dropout_runs_and_is_seeded():
    """model.train() with dropout 0.1 runs on the CPU path; the same
    generator seed gives the same output, another seed another; eval is
    deterministic."""
    cfg = SMALL.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    model = DETR(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    b = to_device(_batch(2), torch.device("cpu"))
    args = (b["image"], b["height"], b["width"])
    model.train()
    o1 = model(*args, generator=torch.Generator().manual_seed(1))["pred_logits"]
    o2 = model(*args, generator=torch.Generator().manual_seed(1))["pred_logits"]
    o3 = model(*args, generator=torch.Generator().manual_seed(2))["pred_logits"]
    assert torch.equal(o1, o2) and not torch.equal(o1, o3)
    out = model(*args, generator=torch.Generator().manual_seed(1))
    (out["pred_logits"].sum() + out["pred_boxes"].sum()).backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters() if p.requires_grad)
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(*args)["pred_logits"], model(*args)["pred_logits"])


def test_trainer_cli_runs_two_micro_steps(tmp_path, monkeypatch):
    """The CLI's synthetic path at the tiny size on the CPU: two micro-steps
    (accumulation 1: two AdamW updates), finite losses, then one validation
    batch of 2 (the plain auction on the CPU takes seconds per batch of
    this size), a checkpoint, and the COCO AP keys."""
    steps = []
    make = trainer.make_train_step

    def counting(model, criterion, canvas_map=None, grid=None):
        step = make(model, criterion, canvas_map, grid)

        def run(state, batch):
            state, metrics = step(state, batch)
            steps.append({k: float(v) for k, v in metrics.items()})
            return state, metrics

        return run

    monkeypatch.setattr(trainer, "make_train_step", counting)
    validated = _count_validations(monkeypatch)
    try:
        assert trainer.main(["--synthetic", "--tiny", "--cpu", "--limit-train-iters", "2",
                             "--epochs", "1", "--train-batch-size", "2", "--limit-val-iters", "1",
                             "--val-batch-size", "2", "--output-dir", str(tmp_path / "run")]) == 0
        assert os.listdir(tmp_path / "run" / "checkpoints") == ["0"]
    finally:
        shutil.rmtree(tmp_path / "run", ignore_errors=True)  # a ~280 MB checkpoint
    assert len(steps) == 2
    assert all(np.isfinite(v) for s in steps for v in s.values())
    assert len(validated) == 1 and "AP" in validated[0]


def _count_validations(monkeypatch) -> list:
    """The metrics of every ``run_validation`` the trainer makes."""
    seen = []
    run = trainer.run_validation

    def counting(*args, **kwargs):
        seen.append(run(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(trainer, "run_validation", counting)
    return seen


def test_trainer_cli_trains_on_coco_data(tmp_path, monkeypatch):
    """``--tiny --cpu --coco-dataset-root``: JPEGs through the loader's two
    worker processes, uint8 batches through the prefetch thread, normalised
    in the step; two micro-steps with finite losses, one validation batch
    from the validation split, and the prefetch thread and the worker
    processes (the train and the val loader's) gone afterwards."""
    import multiprocessing
    import threading

    generate_split(str(tmp_path / "coco"), "train", 6)
    generate_split(str(tmp_path / "coco"), "validation", 3)
    steps = []
    make = trainer.make_train_step

    def counting(model, criterion, canvas_map=None, grid=None):
        step = make(model, criterion, canvas_map, grid)

        def run(state, batch):
            assert batch["image"].dtype == torch.uint8
            state, metrics = step(state, batch)
            steps.append({k: float(v) for k, v in metrics.items()})
            return state, metrics

        return run

    monkeypatch.setattr(trainer, "make_train_step", counting)
    validated = _count_validations(monkeypatch)
    try:
        assert trainer.main(["--tiny", "--cpu", "--coco-dataset-root", str(tmp_path / "coco"),
                             "--limit-train-iters", "2", "--epochs", "1", "--train-batch-size",
                             "2", "--limit-val-iters", "1", "--val-batch-size", "2",
                             "--output-dir", str(tmp_path / "run")]) == 0
    finally:
        shutil.rmtree(tmp_path / "run", ignore_errors=True)  # a ~280 MB checkpoint
    assert len(steps) == 2
    assert all(np.isfinite(v) for s in steps for v in s.values())
    assert len(validated) == 1 and "AP" in validated[0]
    assert not [t for t in threading.enumerate() if t.name == "device-prefetch"]
    assert not multiprocessing.active_children()


def test_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.train_DETR(TrainingConfig(output_dir=str(tmp_path / "run")), DETRConfig(),
                           synthetic=True)
