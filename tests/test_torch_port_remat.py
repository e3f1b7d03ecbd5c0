"""``DETRConfig.remat`` in the port: every encoder and decoder layer
checkpointed (``torch.utils.checkpoint``), its dropout seeds fixed before
the call so that the recomputation draws the masks the forward drew.

At dropout 0.1 in every slot, two micro-steps and an update with ``remat``
equal those without it exactly on the CPU: each micro-step's loss dict and
``grad_norm``, the accumulated gradient of the first micro-step, the
parameters after the update (and so the generator's draws of the second
micro-step).  The same on two tensor-parallel gloo ranks, where the
recomputation repeats the layers' collectives.  A layer under ``remat``
keeps fewer bytes for the backward.  (Against the JAX model with
``remat=True``: ``tests/test_torch_port_train.py``.)
"""

import numpy as np
import pytest
import torch

import torch_ranks
from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.data import synthetic_batch
from detr_tpu_torch.models import DETR
from detr_tpu_torch.parallel.launch import spawn
from detr_tpu_torch.train.trainer import to_device
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

CONFIG = dict(num_object_queries=8, num_encoder_layers=2, num_decoder_layers=2,
              num_attention_heads=2, hidden_size=32, ffn_scale_factor=2, num_classes=7,
              dtype="float32", hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
G, GLOBAL_B = 5, 2
TIMEOUT = 240.0  # seconds per spawned run


@pytest.fixture(scope="module")
def spec():
    """The port's random init of a small DETR, a global batch of 2 at 64x64,
    an injected assignment, two micro-steps of accumulation."""
    model = DETR(DETRConfig(**CONFIG))
    model.reset_parameters(torch.Generator().manual_seed(0))
    batch = synthetic_batch(np.random.default_rng(0), GLOBAL_B, 64, 64, max_gt=G, num_classes=7)
    rng = np.random.default_rng(4)
    qog = np.where(batch["gt_valid"][:, None, :],
                   np.stack([np.stack([rng.permutation(8)[:G] for _ in range(2)])
                             for _ in range(GLOBAL_B)]), -1).astype(np.int32)
    return dict(config=CONFIG, state={k: v.numpy().copy() for k, v in model.state_dict().items()},
                batch=batch, qog=qog, tp=1, accum=2,
                train=dict(cumulative_train_batch_size=2 * GLOBAL_B, train_batch_size=GLOBAL_B,
                           epochs=10, lr_warmup_epochs=1, lr_hold_max_epochs=2),
                lrs={"backbone": 1e-3, "rest": 1e-2}, seed=5)


def _assert_equal_runs(plain: dict, remat: dict) -> None:
    assert remat["metrics"] == plain["metrics"]
    assert plain["updates"] == remat["updates"] == 1
    for key in ("grad", "params", "moments"):
        assert sorted(remat[key]) == sorted(plain[key])
        for name, want in plain[key].items():
            np.testing.assert_array_equal(remat[key][name], want, err_msg=f"{key} {name}")


def test_remat_step_equals_the_plain_step(spec):
    plain, remat = torch_ranks.remat_pair_rank(0, spec)
    _assert_equal_runs(plain, remat)
    assert plain["metrics"][0] != plain["metrics"][1]  # the second micro-step drew new masks


def test_remat_under_tensor_parallelism_equals_the_plain_tp_step(spec):
    """tp=2 on two gloo ranks: with ``remat`` as without, bit for bit, on
    both ranks."""
    results = spawn(torch_ranks.remat_pair_rank, 2, args=(dict(spec, tp=2),), timeout=TIMEOUT)
    for plain, remat in results:
        assert remat["metrics"] == plain["metrics"] == results[0][0]["metrics"]
        assert remat["local_shapes"] == plain["local_shapes"]
    _assert_equal_runs(*results[0])


def _saved_bytes(remat: bool, spec: dict) -> tuple[int, torch.Tensor]:
    """Bytes autograd keeps for the backward of one training forward."""
    model = DETR(DETRConfig(**dict(CONFIG, remat=remat)))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in spec["state"].items()})
    model.train()
    b = to_device(spec["batch"], torch.device("cpu"))
    kept = []

    def pack(t):
        kept.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = model(b["image"], b["height"], b["width"],
                    generator=torch.Generator().manual_seed(1))
    return sum(kept), out["pred_logits"]


def test_remat_keeps_fewer_bytes_for_the_backward(spec):
    plain_bytes, plain_out = _saved_bytes(False, spec)
    remat_bytes, remat_out = _saved_bytes(True, spec)
    assert torch.equal(remat_out, plain_out)
    assert remat_bytes < plain_bytes
