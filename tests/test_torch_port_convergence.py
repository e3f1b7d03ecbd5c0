"""The port's learning run (``detr_tpu_torch.examples.convergence_synthetic``)
against the JAX script's pieces, on the CPU.

The JAX script itself cannot be called (it compiles a ``lax.fori_loop`` of
a thousand steps), so its loop is rebuilt here from the JAX package's
pieces as the script builds them: ``create_train_state`` with its optax
chain, ``calibrate_frozen_bn`` on the first batch, the loss of the last
decoder layer's set criterion, ``one_step``.  The small demo's model (2+2
layers, d=64, 16 queries, 5 classes) at batch 2 and 64x64, fp32, dropout 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from detr_tpu.config import DETRConfig as JaxConfig
from detr_tpu.config import TrainingConfig as JaxTrainingConfig
from detr_tpu.data import synthetic_batch as jax_synthetic_batch
from detr_tpu.eval.metrics import DetectionMetrics as JaxDetectionMetrics
from detr_tpu.eval.postprocess import PostProcess as JaxPostProcess
from detr_tpu.losses.criterion import total_loss as jax_total_loss
from detr_tpu.models import DETR as JaxDETR
from detr_tpu.models import calibrate_frozen_bn as jax_calibrate
from detr_tpu.train import create_train_state
from detr_tpu.train.train_step import _targets_of_batch
from detr_tpu.train.train_step import build_criterion as jax_build_criterion
from detr_tpu_torch.examples import convergence_synthetic as cs
from detr_tpu_torch.models import state_dict_from_jax
from detr_tpu_torch.train.optimizer import GROUPS
from test_torch_threads import few_torch_threads  # noqa: F401  (autouse)

# The small demo's model at a tiny batch and image size, dropout 0.
TINY = ["--batch-size", "2", "--image-size", "128", "--n-train-batches", "2", "--dropout", "0.0"]
LR = 3e-4


def test_optimizer_matches_the_scripts_optax_chain():
    """``make_optimizer`` with ``warmup_lr`` set before each update, against
    ``optax.chain(clip_by_global_norm(1.0), adamw(linear_schedule(0, lr,
    300), weight_decay=1e-4))`` over 6 updates of random gradients, some
    clipped and some not: the parameters within rtol 1e-6 (atol 1e-6, as
    ``test_torch_port_train.py`` holds AdamW to optax: optax's float32 bias
    correction ``1 - 0.999**t`` alone is off by ~1e-5 of itself at t=1, the
    port's is float64).  Update 0 (rate 0) leaves them unchanged."""

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = torch.nn.Linear(7, 5)
            self.head = torch.nn.Linear(5, 3)

    rng = np.random.default_rng(0)
    net = Net()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)))
    names = [n for n, _ in net.named_parameters()]
    lr = 3.0  # large, so that the warm-up's small rates move the parameters
    args = cs.parse_args(["--lr", str(lr)])
    opt = cs.make_optimizer(net, args)
    assert {g["name"] for g in opt.adamw.param_groups} == set(GROUPS)
    assert all(g["weight_decay"] == 1e-4 for g in opt.adamw.param_groups)

    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.linear_schedule(0.0, lr, 300), weight_decay=1e-4))
    jparams = {n: jnp.asarray(p.detach().numpy()) for n, p in net.named_parameters()}
    ostate = tx.init(jparams)
    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    norms = [3.0, 0.5, 7.0, 0.2, 1.5, 0.9]  # global norms: clipped when > 1
    for u, norm in enumerate(norms):
        grads = {n: rng.normal(size=p.shape).astype(np.float32) for n, p in jparams.items()}
        scale = norm / np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
        grads = {n: (g * scale).astype(np.float32) for n, g in grads.items()}
        updates, ostate = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, ostate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        rate = cs.warmup_lr(opt.updates, lr)
        assert rate == float(optax.linear_schedule(0.0, lr, 300)(jnp.int32(u)))
        opt.set_learning_rates({g: rate for g in GROUPS})
        assert opt.apply_gradients([torch.from_numpy(grads[n]) for n in names])
        if u == 0:
            for n, p in net.named_parameters():
                assert torch.equal(p.detach(), start[n]), n
        for n, p in net.named_parameters():
            torch.testing.assert_close(p.detach(), torch.from_numpy(np.array(jparams[n])),
                                       rtol=1e-6, atol=1e-6)
    assert opt.updates == len(norms)
    moved = max(float((p.detach() - start[n]).abs().max()) for n, p in net.named_parameters())
    assert moved > 1e-3


def _jax_loop(args):
    """The JAX script's loop from its pieces, fp32: (state, batches,
    one_step), ``one_step`` returning the new state and the step's loss
    dict with its total."""
    num_classes = args.num_classes
    cfg = JaxConfig(num_object_queries=args.queries, num_encoder_layers=args.enc_layers,
                    num_decoder_layers=args.dec_layers, num_attention_heads=args.heads,
                    hidden_size=args.d_model, ffn_scale_factor=args.ffn_scale,
                    num_classes=num_classes, dtype="float32",
                    hidden_dropout_prob=args.dropout, attention_probs_dropout_prob=args.dropout)
    tc = JaxTrainingConfig(cumulative_train_batch_size=args.batch_size,
                           train_batch_size=args.batch_size)
    model = JaxDETR(cfg)
    criterion = jax_build_criterion(tc, cfg)

    def make_batch(seed):
        return {k: jnp.asarray(v) for k, v in jax_synthetic_batch(
            np.random.default_rng(seed), batch_size=args.batch_size, height=args.image_size,
            width=args.image_size, max_gt=args.max_gt, num_classes=num_classes, mean_boxes=3.0,
            learnable=True).items()}

    batches = [make_batch(s) for s in range(args.n_train_batches)]
    tx = optax.chain(optax.clip_by_global_norm(args.clip),
                     optax.adamw(optax.linear_schedule(0.0, args.lr, 300), weight_decay=1e-4))
    # jitted: one compile each instead of one per operation
    state = jax.jit(lambda rng, b: create_train_state(model, tx, rng, b))(
        jax.random.PRNGKey(0), batches[0])
    cal = jax.jit(lambda v, image: jax_calibrate(cfg, v, image))(
        {"params": state.params, "frozen": state.frozen}, batches[0]["image"])
    state = state.replace(frozen=cal["frozen"])

    def loss_fn(params, frozen, b, rng_):
        out = model.apply({"params": params, "frozen": frozen}, b["image"], b["height"],
                          b["width"], False, rngs={"dropout": rng_})
        loss_dict = criterion(out, _targets_of_batch(b))
        return jax_total_loss(loss_dict), loss_dict

    @jax.jit
    def one_step(s, b):
        rng_, drng = jax.random.split(s.rng)
        (loss, loss_dict), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            s.params, s.frozen, b, drng)
        return s.apply_gradients(grads).replace(rng=rng_), dict(loss_dict, loss=loss)

    return state, batches, one_step, cfg


def test_three_steps_of_the_loop_match_the_jax_pieces():
    """The port's ``build`` (fp32, on the CPU) given the JAX state's weights
    and calibrated statistics, then three ``train_chunk`` steps over the two
    memorised batches (0, 1, 0) against three ``one_step`` calls: every key
    of each step's loss dict within 2e-3 of max(1, |JAX's|), the
    argmax-based ones allowed one flip among the queries; and after the
    third step (two updates that moved them, at rates 1e-6 and 2e-6) the
    parameters within 2 rates of JAX's."""
    args = cs.parse_args(TINY)
    jstate, jbatches, one_step, jcfg = _jax_loop(args)
    params = jax.tree.map(np.asarray, jstate.params)
    frozen = jax.tree.map(np.asarray, jstate.frozen)

    run = cs.build(args, torch.device("cpu"), dtype="float32")
    cfg = run["config"]
    assert cfg.dtype == "float32" and cfg.hidden_dropout_prob == 0.0
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)} == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
        if f.name != "use_pallas_attention"}
    # the same data: the generator's batches, in the same order
    for (device_batch, host), jb in zip(run["train"], jbatches):
        np.testing.assert_array_equal(host["image"], np.asarray(jb["image"]))
        assert torch.equal(device_batch["image"], torch.from_numpy(host["image"]))
    run["model"].load_state_dict(state_dict_from_jax(params, frozen, cfg), strict=True)
    state = run["state"]
    before = {n: p.detach().clone() for n, p in run["model"].named_parameters()}
    batches = [b for b, _ in run["train"]]
    queries = cfg.num_object_queries
    for i in range(3):
        jstate, jm = one_step(jstate, jbatches[i % len(jbatches)])
        m = cs.train_chunk(run["step"], state, args.lr, batches, i, 1)
        assert set(jm) <= set(m)
        for key in jm:
            want = float(jm[key])
            tol = 2e-3 * max(1.0, abs(want))
            if key.startswith(("cardinality_error", "class_error", "diag_nonbg")):
                tol += 100.0 / queries  # one argmax flip among the queries
            assert float(m[key]) == pytest.approx(want, abs=tol), (i, key)
        if i == 0:  # update 0 runs at rate 0
            for n, p in run["model"].named_parameters():
                assert torch.equal(p.detach(), before[n]), n
    assert state.optimizer.updates == 3 and state.step == 3
    assert state.optimizer.get_learning_rates() == {g: cs.warmup_lr(2, args.lr) for g in GROUPS}
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), frozen, cfg)
    for n, p in run["model"].named_parameters():
        rate = cs.warmup_lr(1, args.lr) + cs.warmup_lr(2, args.lr)
        assert float((p.detach() - want[n]).abs().max()) <= 2 * rate + 1e-6, n


def test_evaluate_matches_the_jax_postprocess_and_metrics():
    """``evaluate`` on a stub eval step's logits and boxes (the same numbers
    on both sides, boxes near the ground truth so the AP is not trivial),
    over three generator batches whose image ids it offsets by ``vi * B``,
    against the JAX script's ``evaluate``: the same dict, key for key."""
    args = cs.parse_args(["--batch-size", "3", "--image-size", "96"])
    rng = np.random.default_rng(3)
    hosts = [cs.make_batch(args, 1000 + s, args.num_classes) for s in range(3)]
    B, Q, C = args.batch_size, args.queries, args.num_classes
    outputs = []
    for host in hosts:
        logits = rng.normal(size=(B, 2, Q, C + 1)).astype(np.float32)
        boxes = rng.uniform(0.2, 0.6, size=(B, 2, Q, 4)).astype(np.float32)
        x0, y0, x1, y1 = np.moveaxis(host["boxes_normalized"], -1, 0)
        near = np.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)
        G = near.shape[1]
        boxes[:, -1, :G] = np.where(host["gt_valid"][..., None],
                                    near + rng.normal(0, 0.01, near.shape), boxes[:, -1, :G])
        for b in range(B):
            logits[b, -1, np.arange(G), host["class_idx"][b]] += 4.0
        outputs.append({"pred_logits": torch.from_numpy(logits),
                        "pred_boxes": torch.from_numpy(boxes)})
    calls = iter(outputs)
    got = cs.evaluate(lambda batch: (next(calls), {}),
                      [({k: torch.from_numpy(v) for k, v in h.items()}, h) for h in hosts],
                      [f"color_{i}" for i in range(C)], B, offset_ids=True)

    names = [f"color_{i}" for i in range(C)]
    pp, m = JaxPostProcess(names), JaxDetectionMetrics(names)
    for vi, (vb, out) in enumerate(zip(hosts, outputs)):
        preds = pp(jnp.asarray(out["pred_logits"].numpy()[:, -1]),
                   jnp.asarray(out["pred_boxes"].numpy()[:, -1]), vb["height"], vb["width"])
        host = {k: np.asarray(v) for k, v in vb.items()}
        host["image_id"] = host["image_id"] + vi * args.batch_size
        m.update(preds, host)
    want = m.compute()
    assert got == want
    assert 0.1 < got["AP50"] <= 1.0
    # without the offset the three batches' images would share ids 1..B
    calls = iter(outputs)
    merged = cs.evaluate(lambda batch: (next(calls), {}),
                         [({k: torch.from_numpy(v) for k, v in h.items()}, h) for h in hosts],
                         names, B, offset_ids=False)
    assert merged != got


@pytest.mark.parametrize("bar, ok", [("0", True), ("1.1", False)])
def test_main_exits_by_the_bar(bar, ok, capsys):
    """``main`` at the tiny size on the CPU: two steps, an evaluation after
    each (with the history it records), the FINAL line; exit 0 at bar 0,
    and the script's message (a nonzero exit) at bar 1.1."""
    argv = ["--cpu", "--steps", "2", "--eval-every", "1", "--ap50-bar", bar, *TINY]
    history = []
    if ok:
        assert cs.main(argv, history) == 0
        assert "PASS: train AP50" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit) as exc:
            cs.main(argv, history)
        assert exc.value.code != 0
        assert "below bar 1.1" in str(exc.value.code)
        assert "end-to-end learning check FAILED" in str(exc.value.code)
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) and set(h["val"]) == set(h["train"]) for h in history)
    assert all(np.isfinite(h["val"]["AP"]) for h in history)


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.main(["--steps", "1", "--eval-every", "1", *TINY])
