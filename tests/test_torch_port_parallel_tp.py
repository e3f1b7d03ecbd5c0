"""The port's tensor parallelism against the JAX package's, dropout 0.

A 2-rank tensor-parallel step (global batch 4 on one data-parallel row)
against the JAX ``make_train_step`` under ``make_mesh_2d(2, 2)`` and
``shard_state_tp``, and a 4-rank dp x tp step (2 x 2) against the JAX step
under ``make_mesh_2d(4, 2)``: the same numpy weights, batch and injected
assignment.  The loss dict and ``grad_norm`` at the tolerance of
``test_torch_port_train.py``'s parity test (2e-3 relative, one argmax flip
in the argmax-based entries), the parameters after one AdamW update within
``tests/test_tensor_parallel.py``'s rtol 2e-4, atol 2e-5 and by
``_flip_aware_close``; the JAX state really split, the port's query
projection really split on every rank.  Ranks are gloo processes on the CPU
(``torch_ranks.py``); the small DETR of ``test_torch_port_parallel.py``.
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
from detr_tpu.parallel import shard_batch as jax_shard_batch
from detr_tpu.parallel.tp import make_mesh_2d as jax_make_mesh_2d
from detr_tpu.parallel.tp import shard_state_tp as jax_shard_state_tp
from detr_tpu.parallel.tp import validate_tp as jax_validate_tp
from detr_tpu.train import build_optimizer as jax_build_optimizer
from detr_tpu.train import make_train_step as jax_make_train_step
from detr_tpu.train.train_step import TrainState as JaxTrainState
from detr_tpu.train.train_step import build_criterion as jax_build_criterion
from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.models import state_dict_from_jax
from detr_tpu_torch.parallel.launch import spawn
from test_torch_port_parallel import (
    GLOBAL_B,
    SMALL,
    TIMEOUT,
    _check_metrics,
    _global_batch,
    _qog,
    _same_on_every_rank,
    _spec,
    _train,
    start,  # noqa: F401  (module fixture)
)
from test_torch_port_train import _flip_aware_close
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize("world", [2, 4], ids=["tp2", "dp2xtp2"])
def test_tp_step_matches_the_jax_mesh_step(start, world):  # noqa: F811
    params, frozen, sd = start
    tp, dp = 2, world // 2
    jcfg = JaxConfig(**SMALL)
    jtc = JaxTrainingConfig(**_train(GLOBAL_B))
    batch = _global_batch()
    qog = _qog(batch)
    mesh = jax_make_mesh_2d(world, model_parallel=tp)
    jax_validate_tp(jcfg, mesh)
    tx, _ = jax_build_optimizer(jtc)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_shard_state_tp(
        JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                      frozen=jax.tree.map(jnp.asarray, frozen), opt_state=tx.init(jparams),
                      rng=jax.random.PRNGKey(0), tx=tx), mesh)
    q = jstate.params["encoder"]["layer0"]["self_attention"]["query_proj"]["kernel"]
    assert not q.sharding.is_fully_replicated
    jcrit = dataclasses.replace(jax_build_criterion(jtc, jcfg), matcher=lambda *a: jnp.asarray(qog))
    jstep = jax_make_train_step(JaxDETR(jcfg), jcrit, donate=False)
    jstate, jm = jstep(jstate, jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh))
    want_params = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), frozen,
                                      DETRConfig(**SMALL))

    results = spawn(torch_ranks.train_step_rank, world, args=(_spec(start, tp, GLOBAL_B // dp),),
                    timeout=TIMEOUT)
    _same_on_every_rank(results)
    _check_metrics(results[0]["metrics"][0], {k: float(v) for k, v in jm.items()}, 2e-3, True)
    for r in results:
        assert r["updates"] == 1
        assert r["local_shapes"]["encoder.layers.0.self_attention.query_proj.weight"] == (32, 64)
        assert r["local_shapes"]["encoder.layers.0.ffn.layers.3.weight"] == (64, 64)
    got = {k: torch.from_numpy(v) for k, v in results[0]["params"].items()}
    before = {k: torch.from_numpy(v) for k, v in sd.items()}
    lrs = {"backbone": 3e-5 * 0.01, "rest": 3e-4 * 0.01}  # the schedule at epoch 0
    _flip_aware_close(got, {k: want_params[k] for k in got}, lrs, before)
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), want_params[key].numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=key)
