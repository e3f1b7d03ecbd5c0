"""Checkpoints, resume and weights of the port, on the CPU at the tiny size
(``--tiny``'s model: ResNet-50 trunk, one encoder and two decoder layers,
hidden 16; synthetic 64x64 batches).

The cases of ``tests/test_trainer.py`` for the port's ``CheckpointManager``
and ``train_DETR`` (round trip, retention, auto-restore after a crash,
weights-only resume), and one the JAX suite cannot make cheaply: two epochs
in one run equal, bit for bit, one epoch and then a restore and one more in a
new run.  Then the weights that cross the package boundary: the reference's
``model.safetensors`` written by the JAX package and read by the port, and
the other way; the port's safetensors reader against the ``safetensors``
package; a converted torchvision trunk (.npz); and the serving engine built
from a checkpoint directory.
"""

import dataclasses
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detr_tpu.config import DETRConfig as JaxConfig
from detr_tpu.models import DETR as JaxDETR
from detr_tpu.models import calibrate_frozen_bn as jax_calibrate
from detr_tpu.models import convert as jax_convert
from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.data import synthetic_batch
from detr_tpu_torch.eval import postprocess_predictions
from detr_tpu_torch.models import DETR, calibrate_frozen_bn, state_dict_from_jax
from detr_tpu_torch.models import convert
from detr_tpu_torch.ops.image_norm import prepare_batch_image
from detr_tpu_torch.serve import InferenceEngine
from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, make_train_step
from detr_tpu_torch.train import trainer
from detr_tpu_torch.train.checkpoint import CheckpointManager
from detr_tpu_torch.train.trainer import to_device, train_DETR
from detr_tpu_torch.utils.trees import assert_same_bits
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

TINY = DETRConfig(num_object_queries=8, num_encoder_layers=1, num_decoder_layers=2,
                  num_attention_heads=2, hidden_size=16, ffn_scale_factor=2, num_classes=80,
                  dtype="float32")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """A checkpoint of this model is ~280 MB (its ResNet-50 trunk and two
    AdamW moments), and pytest keeps the temporary directories of its last
    three sessions: each test removes its own."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def tiny_config(tmp_path, **kw):
    """``tests/test_trainer.py``'s tiny run: 2 micro-steps an epoch, one
    validation batch, a checkpoint and a validation every epoch."""
    defaults = dict(output_dir=str(tmp_path / "run"), cumulative_train_batch_size=2,
                    train_batch_size=2, val_batch_size=2, epochs=2, lr_warmup_epochs=1,
                    lr_hold_max_epochs=1, limit_train_iters=2, limit_val_iters=1, eval_epochs=1,
                    checkpoint_epochs=1, log_frequency=1, shape_buckets=((64, 64),),
                    max_gt_boxes=8, mixed_precision="no", eval_shape=(64, 64))
    defaults.update(kw)
    return TrainingConfig(**defaults)


def _trained_state(seed=0, micro_steps=3):
    """A TrainState after ``micro_steps`` steps at accumulation 2 (so the
    accumulated gradient is held when the count is odd), dropout on."""
    config = TINY.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    tc = TrainingConfig(train_batch_size=2, cumulative_train_batch_size=4, max_gt_boxes=8)
    model = DETR(config)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    opt, _ = build_optimizer(model, tc)
    state = TrainState(model, opt, torch.Generator().manual_seed(seed))
    step = make_train_step(model, build_criterion(tc, config))
    for i in range(micro_steps):
        batch = synthetic_batch(np.random.default_rng(i), 2, 64, 64, max_gt=8)
        state, _ = step(state, to_device(batch, CPU))
    return state


def _full_state(state):
    return {"model": state.model.state_dict(), "opt": state.optimizer.state_dict(),
            "step": state.step, "rng": state.generator.get_state()}


def test_checkpoint_roundtrip(tmp_path):
    """Save a trained state (moments, a held accumulated gradient, 3 steps,
    the generator advanced); restore it into a fresh one from another seed:
    everything equal bit for bit, and the epoch back.  Weights-only
    restore leaves the optimizer, step and generator fresh; a weights-only
    artifact restores the weights and refuses a full restore."""
    state = _trained_state(seed=0)
    assert state.optimizer.state_dict()["acc"] is not None and state.optimizer.updates == 1
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None
    mgr.save(0, state, extra={"epoch": 4})
    assert mgr.latest_step() == 0

    fresh = _trained_state(seed=1, micro_steps=0)
    restored, extra = mgr.restore(fresh)
    assert extra == {"epoch": 4}
    assert_same_bits(_full_state(restored), _full_state(state))

    fresh = _trained_state(seed=1, micro_steps=0)
    opt_before = fresh.optimizer.state_dict()
    rng_before = fresh.generator.get_state()
    w_only = mgr.restore_params_only(fresh)
    assert_same_bits(w_only.model.state_dict(), state.model.state_dict())
    assert w_only.step == 0 and w_only.optimizer.updates == 0
    assert opt_before["adamw"]["state"] == {} and w_only.optimizer.state_dict()["acc"] is None
    assert torch.equal(w_only.generator.get_state(), rng_before)

    payload = mgr.restore_payload(0)
    dst = CheckpointManager(str(tmp_path / "weights"), max_to_keep=1)
    dst.save_params_only(0, payload["params"], payload["frozen"])
    from_artifact = dst.restore_params_only(_trained_state(seed=1, micro_steps=0))
    assert_same_bits(from_artifact.model.state_dict(), state.model.state_dict())
    with pytest.raises(ValueError, match="weights only"):
        dst.restore(_trained_state(seed=1, micro_steps=0))


def test_checkpoint_retention_and_a_half_written_one(tmp_path):
    state = _trained_state(micro_steps=0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for e in range(4):
        mgr.save(e, state, extra={"epoch": e})
    assert mgr.latest_step() == 3 and mgr.steps() == [2, 3]
    assert sorted(os.listdir(mgr.directory)) == ["2", "3"]
    # a save cut before its rename leaves only a temporary directory, which
    # no reader takes for a checkpoint
    os.makedirs(os.path.join(mgr.directory, ".tmp-4"))
    os.makedirs(os.path.join(mgr.directory, "5"))  # a step directory without its file
    assert mgr.latest_step() == 3
    assert CheckpointManager(str(tmp_path / "empty")).latest_step() is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_payload()
    assert not os.path.exists(tmp_path / "empty")  # reading creates nothing


def test_crash_recovery_auto_restore(tmp_path, caplog):
    """A second ``train_DETR`` on the same output dir restores the last
    checkpoint in full, starts at the epoch after it, ignores
    ``resume_from_checkpoint`` with the JAX trainer's log line, validates
    and writes its own checkpoint, the newest ``checkpoint_total_limit``
    kept."""
    config = tiny_config(tmp_path, epochs=2, checkpoint_total_limit=2)
    metrics = train_DETR(config, TINY, synthetic=True, device="cpu")
    for key in ("AP", "AP50", "AP75", "AP-small", "AP-medium", "AP-large"):
        assert key in metrics
    assert any(f.startswith("events") for f in os.listdir(os.path.join(config.output_dir, "logs")))
    with caplog.at_level(logging.INFO, logger="detr_tpu_torch.train.trainer"):
        metrics = train_DETR(config.replace(epochs=3, resume_from_checkpoint=str(tmp_path / "x")),
                             TINY, synthetic=True, device="cpu")
    text = caplog.text
    assert "ignoring --resume-from-checkpoint" in text
    assert "auto-restored checkpoint at epoch 1; resuming from epoch 2" in text
    assert "epoch 0 step" not in text and "epoch 2 step 0" in text
    assert "AP" in metrics
    assert CheckpointManager(config.output_dir).steps() == [1, 2]


def test_weights_only_resume(tmp_path, monkeypatch):
    """``resume_from_checkpoint`` into a fresh output dir: the first step
    sees the other run's newest weights and a fresh optimizer, step 0, and
    the schedule at ``start_epoch``."""
    config = tiny_config(tmp_path, epochs=1)
    train_DETR(config, TINY, synthetic=True, device="cpu")
    saved = CheckpointManager(config.output_dir).restore_payload()
    seen = []
    make = trainer.make_train_step

    def first_look(model, criterion, canvas_map=None):
        step = make(model, criterion, canvas_map)

        def run(state, batch):
            if not seen:
                seen.append((state.step, state.optimizer.updates,
                             state.optimizer.state_dict()["adamw"]["state"],
                             {k: v.clone() for k, v in model.state_dict().items()},
                             state.optimizer.get_learning_rates()))
            return step(state, batch)

        return run

    monkeypatch.setattr(trainer, "make_train_step", first_look)
    config2 = tiny_config(tmp_path, output_dir=str(tmp_path / "run2"), epochs=3, start_epoch=2,
                          resume_from_checkpoint=config.output_dir)
    metrics = train_DETR(config2, TINY, synthetic=True, device="cpu")
    assert "AP" in metrics
    step, updates, moments, weights, lrs = seen[0]
    assert step == 0 and updates == 0 and moments == {}
    assert_same_bits(weights, {**saved["params"], **saved["frozen"]})
    _, schedules = build_optimizer(DETR(TINY), config2)
    assert lrs == {g: s(2) for g, s in schedules.items()}
    assert CheckpointManager(config2.output_dir).steps() == [2]


def test_resume_is_bit_identical_to_an_uninterrupted_run(tmp_path):
    """Dropout 0.1 (the generator's draws matter), 3 micro-steps an epoch at
    accumulation 2 (an accumulated gradient crosses the epoch boundary):
    two epochs in one run, against one epoch, then a new ``train_DETR`` that
    restores it and trains the second.  The final checkpoints are equal bit
    for bit (parameters, frozen statistics, moments, accumulated gradient,
    counts, generator), and so are the validation metrics."""
    _check_resume(tmp_path)


def test_recalibration_every_epoch_and_its_resume_bit_for_bit(tmp_path, monkeypatch):
    """``bn_recalibrate_epochs=1`` over 2 epochs: at each epoch's first
    micro-step the trunk's frozen-BN statistics are, bit for bit,
    ``calibrate_frozen_bn`` of that epoch's weights on the startup sample
    (the loader's first batch), and they moved between the epochs; the run
    resumed after epoch 0 (which takes the same sample and recalibrates at
    epoch 1) equals the uninterrupted one bit for bit, as above."""
    starts = []
    make = trainer.make_train_step

    def recording(model, criterion, canvas_map=None):
        step = make(model, criterion, canvas_map)

        def run(state, batch):
            if state.step % 3 == 0 and len(starts) < 2:  # the first of an epoch's 3
                starts.append({k: v.clone() for k, v in model.state_dict().items()})
            return step(state, batch)

        return run

    monkeypatch.setattr(trainer, "make_train_step", recording)
    config = _check_resume(tmp_path, bn_recalibrate_epochs=1)
    assert len(starts) == 2
    train_batches = trainer._make_loaders(config, synthetic=True)[0]
    sample = to_device(next(iter(train_batches)), CPU)
    stats = [{k: v for k, v in s.items() if k.endswith(("running_mean", "running_var"))}
             for s in starts]
    assert any(not torch.equal(stats[0][k], stats[1][k]) for k in stats[0])
    for start, got in zip(starts, stats):
        model = DETR(TINY)
        model.load_state_dict(start)
        calibrate_frozen_bn(model.backbone.backbone, prepare_batch_image(sample))
        assert_same_bits({k: v for k, v in model.state_dict().items() if k in got}, got)


def _check_resume(tmp_path, **kw) -> TrainingConfig:
    """Two epochs straight against one, then a restore and the second; the
    final checkpoints and metrics equal bit for bit.  Returns the straight
    run's configuration."""
    model_config = TINY.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    kw = dict(limit_train_iters=3, cumulative_train_batch_size=4, eval_epochs=5, **kw)
    straight = tiny_config(tmp_path, output_dir=str(tmp_path / "straight"), epochs=2,
                           checkpoint_total_limit=1, **kw)
    want = train_DETR(straight, model_config, synthetic=True, device="cpu")
    split = tiny_config(tmp_path, output_dir=str(tmp_path / "split"), epochs=1, **kw)
    train_DETR(split, model_config, synthetic=True, device="cpu")
    got = train_DETR(split.replace(epochs=2), model_config, synthetic=True, device="cpu")
    assert got == want
    a = CheckpointManager(straight.output_dir).restore_payload(1)
    b = CheckpointManager(split.output_dir).restore_payload(1)
    # the split run's first checkpoint held half an accumulation
    assert CheckpointManager(split.output_dir).restore_payload(0)["opt_state"]["acc"] is not None
    assert a["opt_state"]["updates"] == 3 and a["step"] == 6 and a["extra"] == {"epoch": 1}
    assert_same_bits(b, a)
    return straight


# ---- weights across the package boundary ----

JAX_TINY = JaxConfig(**{f.name: getattr(TINY, f.name) for f in dataclasses.fields(TINY)},
                     use_pallas_attention=False)
H, W = 64, 96


def _images():
    rng = np.random.default_rng(5)
    imgs = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    imgs[1, 50:] = 0.0
    return imgs, np.array([64, 50], np.int32), np.array([96, 96], np.int32)


@pytest.fixture(scope="module")
def jax_variables():
    """A JAX init with frozen-BN statistics calibrated on the test images,
    as ``test_torch_port_model.py`` holds the forward."""
    variables = jax.jit(JaxDETR(JAX_TINY).init)(jax.random.PRNGKey(2), jnp.zeros((1, H, W, 3)),
                                                jnp.array([H]), jnp.array([W]))
    variables = jax_calibrate(JAX_TINY, variables, jnp.asarray(_images()[0]))
    return jax.tree.map(np.asarray, variables)


def test_reference_safetensors_from_jax_load_into_the_port(jax_variables, tmp_path):
    """The reference layout from the JAX package's ``export_detr_state_dict``
    written by the ``safetensors`` package -> the port's
    ``load_reference_checkpoint``: every tensor as exported, and the port's
    forward equals the JAX forward within 2e-3 (``test_torch_port_model.py``'s
    full-forward tolerance: the trunk's summation order).  The file of JAX's
    own ``save_reference_checkpoint`` reads in the port exactly as in the
    ``safetensors`` package, bit for bit.  (That writer hands the package
    transposed views, which its numpy front end stores in memory order, so
    its Dense weights come back transposed in either reader: a fault of the
    JAX package, recorded in ROADMAP.md.)"""
    from safetensors.numpy import load_file, save_file

    path = str(tmp_path / "model.safetensors")
    jax_convert.save_reference_checkpoint(path, jax_variables["params"], jax_variables["frozen"],
                                          JAX_TINY)
    ours, theirs = convert.load_safetensors(path), load_file(path)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)

    sd = jax_convert.export_detr_state_dict(jax_variables["params"], jax_variables["frozen"],
                                            JAX_TINY)
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, path)
    model = DETR(TINY).eval()
    model.load_state_dict(convert.load_reference_checkpoint(path, TINY), strict=True)
    for k, v in sd.items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v, err_msg=k)
    imgs, hs, ws = _images()
    want = JaxDETR(JAX_TINY).apply(jax_variables, jnp.asarray(imgs), jnp.asarray(hs),
                                   jnp.asarray(ws))
    with torch.inference_mode():
        got = model(*(torch.from_numpy(x) for x in (imgs, hs, ws)))
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-3, rtol=0)


def test_port_safetensors_load_into_jax(jax_variables, tmp_path):
    """The port's ``save_reference_checkpoint`` -> JAX's
    ``load_reference_checkpoint``: the same params and frozen trees, bit
    for bit; the ``safetensors`` package reads the port's file as the port
    does; the port's loader refuses a file that lacks a tensor."""
    from safetensors.numpy import load_file

    model = DETR(TINY)
    model.load_state_dict(state_dict_from_jax(jax_variables["params"], jax_variables["frozen"],
                                              TINY), strict=True)
    path = str(tmp_path / "model.safetensors")
    convert.save_reference_checkpoint(path, model)
    params, frozen = jax_convert.load_reference_checkpoint(path, JAX_TINY)
    for tree, ref in ((params, jax_variables["params"]), (frozen, jax_variables["frozen"])):
        for (p1, a), (p2, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                    jax.tree_util.tree_leaves_with_path(ref)):
            assert p1 == p2
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p1))
    theirs = load_file(path)
    ours = convert.load_safetensors(path)
    assert sorted(ours) == sorted(theirs) == sorted(model.state_dict())
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    sd = model.state_dict()
    del sd["class_embedding.bias"]
    convert.save_safetensors(path, sd)
    with pytest.raises(KeyError, match="class_embedding.bias"):
        convert.load_reference_checkpoint(path, TINY)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int64", "int32", "uint8",
                                   "bool"])
def test_safetensors_writer_and_reader_match_the_package(dtype, tmp_path):
    """Each dtype the port writes, both ways against the ``safetensors``
    package (its torch front end, which takes bf16), bit for bit; scalars
    and empty tensors included."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    tensors = {name: (torch.randn(shape, generator=g) * 100).to(dt)
               for name, shape in (("a", (3, 5)), ("b.c", (7,)), ("s", ()), ("empty", (0, 4)))}
    save_file(tensors, str(tmp_path / "theirs.safetensors"))
    convert.save_safetensors(str(tmp_path / "ours.safetensors"), tensors, {"format": "pt"})
    for got in (convert.load_safetensors(str(tmp_path / "theirs.safetensors")),
                load_file(str(tmp_path / "ours.safetensors"))):
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == dt and got[k].shape == v.shape and torch.equal(got[k], v), k


def test_backbone_npz_loads_into_the_trunk(tmp_path):
    """A torchvision-named trunk through the JAX package's
    ``save_backbone_npz`` and back into the port by ``load_backbone_npz``
    and ``apply_backbone_weights``: every trunk tensor equal; a transposed
    kernel raises."""
    src = DETR(TINY)
    src.reset_parameters(torch.Generator().manual_seed(3))
    trunk_sd = {k: v.numpy() for k, v in src.backbone.backbone.state_dict().items()}
    trunk_sd.update({k: np.random.default_rng(1).random(v.shape).astype(np.float32) + 0.5
                     for k, v in trunk_sd.items() if k.endswith(("running_mean", "running_var"))})
    path = str(tmp_path / "r50.npz")
    jax_convert.save_backbone_npz(path, trunk_sd, "resnet50")
    dst = DETR(TINY)
    convert.apply_backbone_weights(dst, *convert.load_backbone_npz(path))
    got = dst.backbone.backbone.state_dict()
    assert sorted(got) == sorted(trunk_sd)
    for k, v in trunk_sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    params, frozen = convert.load_backbone_npz(path)
    params["conv1"]["kernel"] = params["conv1"]["kernel"].transpose(0, 1, 3, 2)  # HWOI
    with pytest.raises(ValueError, match="conv1.weight"):
        convert.apply_backbone_weights(dst, params, frozen)


def test_engine_from_checkpoint_dir_equals_the_model(tmp_path):
    """``InferenceEngine(checkpoint_dir=...)`` on the CPU serves the newest
    checkpoint's model: its batch forward and postprocess equal the
    in-memory model's, bit for bit; no checkpoint raises
    FileNotFoundError; weights and a checkpoint dir together raise."""
    state = _trained_state(micro_steps=2)
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(0, state)
    engine = InferenceEngine(TINY, checkpoint_dir=str(tmp_path / "run"), batch_size=2,
                             buckets=((64, 96), (96, 64)), min_size=64, max_size=96, device="cpu")
    imgs, hs, ws = _images()
    got = engine._predict(imgs, hs, ws, hs * 2, ws * 2)
    model = state.model.eval()
    with torch.inference_mode():
        out = model(*(torch.from_numpy(x) for x in (imgs, hs, ws)))
        want = postprocess_predictions(out["pred_logits"][:, -1], out["pred_boxes"][:, -1],
                                       torch.from_numpy(hs * 2), torch.from_numpy(ws * 2))
    for k in ("scores", "labels", "boxes"):
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)
    assert len(engine.predict([np.zeros((64, 96, 3), np.uint8)])[0]["scores"]) == 8
    with pytest.raises(FileNotFoundError):
        InferenceEngine(TINY, checkpoint_dir=str(tmp_path / "none"), device="cpu")
    with pytest.raises(ValueError, match="either"):
        InferenceEngine(TINY, variables={}, checkpoint_dir=str(tmp_path / "run"), device="cpu")
