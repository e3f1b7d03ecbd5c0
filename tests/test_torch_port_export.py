"""The port's weights export (``python -m detr_tpu_torch.train.export``,
counterpart of ``scripts/export_weights.py``): a full checkpoint through
``CheckpointManager`` into a weights-only artifact with its ``EPOCH``
sidecar, round trip bit for bit, and a weights-only resume from it."""

import numpy as np
import pytest
import torch

from detr_tpu_torch.config import DETRConfig, TrainingConfig
from detr_tpu_torch.data import synthetic_batch
from detr_tpu_torch.models import DETR
from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, make_train_step
from detr_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager
from detr_tpu_torch.train.export import EPOCH_FILE, export_weights, main
from detr_tpu_torch.train.trainer import to_device
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

TINY = DETRConfig(num_object_queries=8, num_encoder_layers=1, num_decoder_layers=1,
                  num_attention_heads=2, hidden_size=16, ffn_scale_factor=2, num_classes=7,
                  dtype="float32")
TC = TrainingConfig(train_batch_size=2, cumulative_train_batch_size=2, max_gt_boxes=5)


def _state(seed: int) -> TrainState:
    model = DETR(TINY)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    opt, _ = build_optimizer(model, TC)
    return TrainState(model, opt, torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run with full checkpoints at epochs 0 and 3 (one train step before
    each, so the optimizer's moments exist)."""
    state = _state(0)
    step = make_train_step(state.model, build_criterion(TC, TINY))
    batch = to_device(synthetic_batch(np.random.default_rng(0), 2, 64, 64, max_gt=5,
                                      num_classes=7), torch.device("cpu"))
    run = tmp_path_factory.mktemp("run")
    mgr = CheckpointManager(str(run))
    for epoch in (0, 3):
        state, _ = step(state, batch)
        mgr.save(epoch, state, extra={"epoch": epoch})
    return run, state


def test_export_round_trips_the_newest_checkpoint(run_dir, tmp_path, capsys):
    run, state = run_dir
    out = tmp_path / "artifact"
    assert main([str(run), str(out)]) == 0
    assert "exported step 3 (epoch 3)" in capsys.readouterr().out
    assert (out / EPOCH_FILE).read_text() == "4"
    assert sorted(p.name for p in out.iterdir()) == [EPOCH_FILE, "checkpoints"]
    artifact = CheckpointManager(str(out))
    assert artifact.steps() == [3]
    payload = artifact.restore_payload()
    assert sorted(payload) == ["frozen", "params"]
    for name, p in state.model.named_parameters():
        assert torch.equal(payload["params"][name], p.detach()), name
    for name, b in state.model.named_buffers():
        assert torch.equal(payload["frozen"][name], b), name
    full = (run / "checkpoints" / "3" / STATE_FILE).stat().st_size
    assert (out / "checkpoints" / "3" / STATE_FILE).stat().st_size < full / 2

    fresh = _state(1)  # another init: the resume must overwrite every tensor
    artifact.restore_params_only(fresh)
    for (name, a), b in zip(fresh.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert fresh.optimizer.updates == 0 and fresh.step == 0  # weights only


def test_export_of_a_chosen_step_and_of_an_empty_run(run_dir, tmp_path):
    run, _ = run_dir
    assert export_weights(str(run), str(tmp_path / "a"), step=0) == (0, 0)
    assert (tmp_path / "a" / EPOCH_FILE).read_text() == "1"
    assert not list((tmp_path / "a").glob("*.tmp"))
    with pytest.raises(SystemExit, match="no checkpoints"):
        main([str(tmp_path / "empty"), str(tmp_path / "b")])
