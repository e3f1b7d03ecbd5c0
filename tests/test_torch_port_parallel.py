"""The port's data parallelism and its layout-independent dropout.

Ranks are gloo processes on the CPU, spawned by
``detr_tpu_torch.parallel.launch.spawn`` with a timeout each (the rank
functions are in ``torch_ranks.py``).  A small DETR as in
``test_torch_port_train.py``: ResNet-50 trunk at 64x64, one encoder and two
decoder layers, hidden 64, 2 heads of 32, fp32.

  * dropout 0: a 2-rank data-parallel step on a global batch of 4 against
    the JAX ``make_train_step`` on a 2-device virtual CPU mesh
    (``shard_batch``, ``shard_state``), the same numpy weights, batch and
    injected assignment: the loss dict and ``grad_norm`` at the tolerance of
    ``test_torch_port_train.py``'s parity test (2e-3 relative, one argmax
    flip in the argmax-based entries), the parameters after one AdamW update
    by its ``_flip_aware_close`` and within rtol 2e-4, atol 2e-5 (the JAX
    package's own TP-vs-one-device tolerance); with accumulation over 2
    micro-steps, the port's 2 ranks against its one process;
  * dropout 0.1: data-parallel, tensor-parallel and dp x tp steps against
    the port's one-process step on the concatenated batch (same seeds): the
    loss dicts to 1e-5 relative and the global gradient of the first
    micro-step to 1e-4 of each tensor's largest value, plus 1e-8 (gradients
    that are 0 in exact arithmetic come out ~1e-14; fp32 summation order;
    a mask drawn on the local index instead moves the losses by ~1e-2);
  * the hash offsets: ``hash_dropout`` and ``attention_keep`` of a block
    equal the block of the global mask, bit for bit;
    the AdamW moments split like their parameters, and gathered equal to
    the one-process moments;
  * ``param_specs`` against the JAX rule, ``validate_tp``'s refusals,
    same-seeded replicas.
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
from detr_tpu.models import DETR as JaxDETR
from detr_tpu.parallel import make_mesh as jax_make_mesh
from detr_tpu.parallel import shard_batch as jax_shard_batch
from detr_tpu.parallel import shard_state as jax_shard_state
from detr_tpu.parallel.tp import param_specs as jax_param_specs
from detr_tpu.train import build_optimizer as jax_build_optimizer
from detr_tpu.train import make_train_step as jax_make_train_step
from detr_tpu.train.train_step import TrainState as JaxTrainState
from detr_tpu.train.train_step import build_criterion as jax_build_criterion
from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.data import synthetic_batch
from detr_tpu_torch.models import DETR, state_dict_from_jax
from detr_tpu_torch.ops.dropout import _M32, attention_keep, hash_dropout
from detr_tpu_torch.parallel import Grid, param_specs, validate_tp
from detr_tpu_torch.parallel.launch import spawn
from test_torch_port_train import _flip_aware_close
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

SMALL = dict(num_object_queries=8, num_encoder_layers=1, num_decoder_layers=2,
             num_attention_heads=2, hidden_size=64, ffn_scale_factor=2, num_classes=7,
             dtype="float32", hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
DROPOUT = dict(SMALL, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
G = 5
GLOBAL_B = 4
TIMEOUT = 240.0  # seconds per spawned run


def _train(per_rank_batch: int, accum: int = 1) -> dict:
    return dict(cumulative_train_batch_size=per_rank_batch * accum,
                train_batch_size=per_rank_batch, epochs=10, lr_warmup_epochs=1,
                lr_hold_max_epochs=2)


def _global_batch(seed: int = 0) -> dict:
    return synthetic_batch(np.random.default_rng(seed), GLOBAL_B, 64, 64, max_gt=G, num_classes=7)


def _qog(batch) -> np.ndarray:
    rng = np.random.default_rng(4)
    return np.where(batch["gt_valid"][:, None, :],
                    np.stack([np.stack([rng.permutation(8)[:G] for _ in range(2)])
                              for _ in range(GLOBAL_B)]), -1).astype(np.int32)


@pytest.fixture(scope="module")
def start():
    """The JAX package's init of the small DETR (one jitted compile), its
    identity frozen statistics, as numpy trees, and the port's state dict
    of them."""
    cfg = JaxConfig(**SMALL)
    batch = {k: jnp.asarray(v) for k, v in _global_batch().items()}
    variables = jax.jit(JaxDETR(cfg).init)(jax.random.PRNGKey(0), batch["image"],
                                           batch["height"], batch["width"])
    params = jax.tree.map(np.asarray, variables["params"])
    frozen = jax.tree.map(np.asarray, variables["frozen"])
    sd = state_dict_from_jax(params, frozen, DETRConfig(**SMALL))
    return params, frozen, {k: v.numpy() for k, v in sd.items()}


def _spec(start, tp, per_rank_batch, accum=1, config=SMALL, qog=True):
    batch = _global_batch()
    return dict(config=config, train=_train(per_rank_batch, accum), state=start[2], batch=batch,
                qog=_qog(batch) if qog else None, tp=tp, accum=accum)


def _check_metrics(got: dict, want: dict, rel: float, flips: bool) -> None:
    assert set(got) == set(want)
    for key in want:
        tol = rel * max(1.0, abs(want[key]))
        if flips and key.startswith(("cardinality_error", "class_error", "diag_nonbg")):
            tol += 100.0 / 8  # one argmax flip among the queries
        assert got[key] == pytest.approx(want[key], abs=tol), key


def _same_on_every_rank(results) -> None:
    for r in results[1:]:
        assert r["metrics"] == results[0]["metrics"]


def test_dp_step_matches_the_jax_mesh_step(start):
    """2 data-parallel ranks, 2 images each, against the JAX step on a
    2-device mesh over the global batch of 4 (module docstring's
    tolerances)."""
    params, frozen, sd = start
    jcfg = JaxConfig(**SMALL)
    jtc = JaxTrainingConfig(**_train(GLOBAL_B))
    batch = _global_batch()
    qog = _qog(batch)
    tx, _ = jax_build_optimizer(jtc)
    jparams = jax.tree.map(jnp.asarray, params)
    mesh = jax_make_mesh(2)
    jstate = jax_shard_state(
        JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                      frozen=jax.tree.map(jnp.asarray, frozen), opt_state=tx.init(jparams),
                      rng=jax.random.PRNGKey(0), tx=tx), mesh)
    jcrit = dataclasses.replace(jax_build_criterion(jtc, jcfg), matcher=lambda *a: jnp.asarray(qog))
    jstep = jax_make_train_step(JaxDETR(jcfg), jcrit, donate=False)
    jstate, jm = jstep(jstate, jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    want_params = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), frozen,
                                      DETRConfig(**SMALL))

    results = spawn(torch_ranks.train_step_rank, 2, args=(_spec(start, 1, 2),), timeout=TIMEOUT)
    _same_on_every_rank(results)
    _check_metrics(results[0]["metrics"][0], {k: float(v) for k, v in jm.items()}, 2e-3, True)
    assert all(r["updates"] == 1 for r in results)
    got = {k: torch.from_numpy(v) for k, v in results[0]["params"].items()}
    before = {k: torch.from_numpy(v) for k, v in sd.items()}
    lrs = {"backbone": 3e-5 * 0.01, "rest": 3e-4 * 0.01}  # the schedule at epoch 0
    _flip_aware_close(got, {k: want_params[k] for k in got}, lrs, before)
    for key, want in want_params.items():
        if key in got:
            np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=key)


def test_dp_accumulation_matches_one_process(start):
    """Two micro-steps of accumulation: 2 ranks of 2 images against the
    port's one process on the 4 images, each micro-step's loss dict and
    grad_norm to 1e-5 relative (one argmax flip allowed), the global gradient
    of the first micro-step to 1e-4 of each tensor's largest value plus 1e-8,
    and the
    parameters after the update within rtol 2e-4, atol 2e-5."""
    _check_layout(start, tp=1, world=2, config=SMALL, flips=True)


@pytest.mark.parametrize("tp,world", [(1, 2), (2, 2), (2, 4)], ids=["dp2", "tp2", "dp2xtp2"])
def test_dropout_layouts_equal_one_process(start, tp, world):
    """Dropout 0.1 in every slot: the multi-rank step equals the port's
    one-process step on the concatenated batch (module docstring)."""
    _check_layout(start, tp=tp, world=world, config=DROPOUT, flips=False)


def _check_layout(start, tp, world, config, flips):
    dp = world // tp
    one = torch_ranks.train_step_rank(0, _spec(start, 1, GLOBAL_B, accum=2, config=config))
    results = spawn(torch_ranks.train_step_rank, world,
                    args=(_spec(start, tp, GLOBAL_B // dp, accum=2, config=config),),
                    timeout=TIMEOUT)
    _same_on_every_rank(results)
    for got, want in zip(results[0]["metrics"], one["metrics"]):
        _check_metrics(got, want, 1e-5, flips)
    for name, want in one["grad"].items():
        got = results[0]["grad"][name]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()) + 1e-8,
                                   err_msg=name)
    for name, want in one["params"].items():
        np.testing.assert_allclose(results[0]["params"][name], want, rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    _check_split_moments(one, results, tp)


def _check_split_moments(one, results, tp):
    """Every rank's AdamW moments have its parameters' local shapes (a split
    one 1/tp of the full one on its dim), and gathered they equal the
    one-process moments (1e-4 of each tensor's largest value, plus 1e-9)."""
    specs = param_specs(one["local_shapes"])
    # 5 attentions (q, k, v weight and bias, output weight) and 3 FFNs (fc1
    # weight and bias, fc2 weight)
    assert sum(s is not None for s in specs.values()) == 7 * 5 + 3 * 3
    for r in results:
        assert r["local_moment_shapes"] == r["local_shapes"]
        for name, shape in r["local_shapes"].items():
            full = list(one["local_shapes"][name])
            if specs[name] is not None:
                full[specs[name]] //= tp
            assert list(shape) == full, name
    for name, want in one["moments"].items():
        np.testing.assert_allclose(results[0]["moments"][name], want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()) + 1e-9, err_msg=name)


def test_param_specs_split_the_jax_rules_parameters(start):
    """``param_specs`` on the port's names splits exactly the parameters the
    JAX rule splits, each on the torch dim of the JAX one: a tree of codes
    (0 replicated, 1 column split, 2 row split) per JAX leaf, carried
    through ``state_dict_from_jax``, equals the port's."""
    params, frozen, _ = start
    jspecs = jax_param_specs(params)
    P = jax.sharding.PartitionSpec

    def code(leaf, spec):
        c = 0 if spec == P() else 1 if spec in (P(None, "model"), P("model")) else 2
        return np.full(leaf.shape, c, np.float32)

    codes = state_dict_from_jax(jax.tree.map(code, params, jspecs), frozen, DETRConfig(**SMALL))
    names = [n for n, _ in DETR(DETRConfig(**SMALL)).named_parameters()]
    specs = param_specs(names)
    for name in names:
        want = int(codes[name].flatten()[0])
        assert (codes[name] == want).all(), name
        got = specs[name]
        if want == 0:
            assert got is None, name
        elif want == 1:  # output features: nn.Linear's weight rows, the bias
            assert got == 0, name
        else:  # input features: the weight's columns
            assert got == 1 and name.endswith(".weight"), name


def test_hash_dropout_block_is_the_global_masks_block():
    """A block of batch rows and FFN columns draws exactly that block of the
    global array's mask."""
    x = torch.ones(6, 5, 12)
    full = hash_dropout(x, 0.3, 1234, False)
    for b0, nb, c0, nc in ((0, 6, 0, 12), (2, 2, 0, 12), (4, 2, 6, 6), (1, 3, 3, 4)):
        block = hash_dropout(x[:nb, :, :nc], 0.3, 1234, False, batch_offset=b0, col_offset=c0,
                             total_cols=12)
        assert torch.equal(block, full[b0:b0 + nb, :, c0:c0 + nc])
    # one process's call is unchanged: the plain flat index
    assert torch.equal(hash_dropout(x, 0.3, 7, False, 0, 0, 12), hash_dropout(x, 0.3, 7, False))


def test_attention_keep_block_is_the_global_masks_block():
    """Heads (b_off + b) * H_total + h_off + h: a block of batch rows and
    heads draws that block of the global keep-mask."""
    full = attention_keep(99, 4, 8, 5, 7, 0.25, "cpu")
    for b0, nb, h0, nh in ((0, 4, 0, 8), (2, 2, 0, 8), (0, 4, 4, 4), (3, 1, 2, 2)):
        block = attention_keep(99, nb, nh, 5, 7, 0.25, "cpu", b_off=b0, h_off=h0, h_total=8)
        assert torch.equal(block, full[b0:b0 + nb, h0:h0 + nh])
    assert _M32 == 0xFFFFFFFF


def test_masked_attention_with_a_hash_base_is_the_global_block():
    """The attention function (its CPU path) on a block of rows and heads
    with the block's hash base equals that block of the global call, out and
    gradients, at dropout 0.3."""
    from detr_tpu_torch.ops.masked_attention import masked_attention

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(4, n, 4, 8)).astype(np.float32)).requires_grad_()
               for n in (5, 7, 7))
    out, _ = masked_attention(q, k, v, None, 0.3, 11)
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    want = torch.autograd.grad(out, (q, k, v), g)
    b0, h0 = 2, 2
    sl = (slice(b0, b0 + 2), slice(None), slice(h0, h0 + 2))
    qb, kb, vb = (x.detach()[sl].clone().requires_grad_() for x in (q, k, v))
    ob, _ = masked_attention(qb, kb, vb, None, 0.3, 11, hash_base=(b0, h0, 4))
    torch.testing.assert_close(ob, out.detach()[sl], rtol=0, atol=1e-6)
    got = torch.autograd.grad(ob, (qb, kb, vb), g[sl])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b[sl], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="hash base"):
        masked_attention(qb, kb, vb, None, 0.3, 11, hash_base=(0, 3, 4))


def test_validate_tp_refuses_what_the_jax_one_refuses(monkeypatch):
    """Heads that do not divide by the group, and a group that spans nodes
    (torchrun's LOCAL_WORLD_SIZE); a world that does not divide by the
    group refuses to form (3 spawned ranks, model_parallel 2)."""
    grid = Grid(rank=0, world=8, tp_size=4)
    with pytest.raises(ValueError, match="num_attention_heads"):
        validate_tp(DETRConfig(**SMALL), grid)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="within one node"):
        validate_tp(DETRConfig(**{**SMALL, "num_attention_heads": 4}), grid)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    validate_tp(DETRConfig(**{**SMALL, "num_attention_heads": 4}), grid)
    with pytest.raises(RuntimeError, match="not divisible by model_parallel=2"):
        spawn(torch_ranks.environment_rank, 3, args=({"tp": 2},), timeout=TIMEOUT)


def test_spawned_ranks_see_their_grid():
    """4 ranks as 2 x 2: rank r at data row r // 2 and model column r % 2."""
    results = spawn(torch_ranks.environment_rank, 4, args=({"tp": 2},), timeout=TIMEOUT)
    for r, got in enumerate(results):
        assert got == {"rank": r, "world": 4, "dp": 2, "tp": 2, "dp_rank": r // 2,
                       "tp_rank": r % 2}


def test_same_seeded_replicas_are_equal():
    """``shard_state`` trusts that every rank's same-seeded init agrees (as
    the JAX package's replicated placement does): two inits from one seed,
    in two processes' worth of fresh modules, are equal bit for bit."""
    from detr_tpu_torch.train.trainer import build_model

    a, b = (build_model(DETRConfig(**SMALL), 5).state_dict() for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
