"""Card-only checks of the port: the CUDA kernels against their plain
versions, the engine and a train step on the card against the CPU.

They carry the ``gpu`` marker and skip themselves without a CUDA card.  This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py -q
"""

import numpy as np
import pytest
import torch

from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.ops import masked_attention as ma
from detr_tpu_torch.serve import InferenceEngine

F32_MIN = float(np.finfo(np.float32).min)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("L", [130, 400, 700])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_card(card, dtype, rate, L):
    """Ragged L (130, 400, 700: the bf16 kernel's three block shapes on an
    H100, 16, 32 and 64 rows per block), a ragged key mask and one fully
    masked image, dropout 0 and 0.1.  bf16 out (tensor cores, which sum in
    another order): within one bf16 ulp per element and at most 1 % of its
    elements differing (``bf16_agreement``); fp32 out within 1e-4; lse within
    1e-4 for both, exactly finfo(float32).min on the fully masked image.  A
    second launch gives the same bits (no atomics)."""
    from detr_tpu_torch.ops.attention import BF16_MAX_SHARE, BF16_MAX_ULPS, bf16_agreement

    rng = np.random.default_rng(1)
    B, S, H, D = 3, 200, 8, 32
    dt = getattr(torch, dtype)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(B, n, H, D)).astype(np.float32)).to(card, dt)
        for n in (L, S, S)
    )
    mask = torch.from_numpy(np.arange(S)[None, :] >= np.array([[150], [37], [1]])).to(card)
    mask[2] = True
    before = ma.launches
    out, lse = ma.masked_attention(q, k, v, mask, rate, 9)
    assert ma.launches == before + 1
    again = ma.masked_attention(q, k, v, mask, rate, 9)
    ref_out, ref_lse = ma.masked_attention_reference(q, k, v, mask, 9, rate)
    torch.cuda.synchronize()
    assert out.dtype == dt and lse.dtype == torch.float32 and lse.shape == (B, H, L)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    if dtype == "bfloat16":
        max_ulps, share = bf16_agreement(out, ref_out)
        assert max_ulps <= BF16_MAX_ULPS and share <= BF16_MAX_SHARE, (max_ulps, share)
    else:
        torch.testing.assert_close(out, ref_out, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    assert (lse[2] == F32_MIN).all()


@pytest.mark.gpu
def test_bf16_kernel_takes_rows_off_16_bytes(card):
    """The bf16 kernel copies 16-byte chunks of each row: the wrapper hands it
    an aligned copy of q, k and v whose rows do not start on 16 bytes, and
    the result equals the aligned inputs' bit for bit."""
    rng = np.random.default_rng(6)
    base = torch.from_numpy(rng.normal(size=(2, 70, 8, 33)).astype(np.float32)).to(card, torch.bfloat16)
    q = base[..., 1:]  # rows 66 bytes apart, starting 2 bytes in
    k, v = base[:, :50, :, 1:], base[:, 20:, :, 1:]
    got = ma.masked_attention(q, k, v)
    want = ma.masked_attention(*(x.contiguous() for x in (q, k, v)))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("D", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_head_sizes_match_plain_version_on_card(card, dtype, D):
    """Head sizes under 32 (``--tiny``'s 8, and 16): the wrapper zero-pads
    to 32 and passes 1/sqrt(D).  Forward and backward through the autograd
    Function, dropout 0.1, a ragged mask and a fully masked image, one launch
    of each kernel, against the unpadded plain versions by the rules above:
    bf16 out and gradients by ``bf16_agreement``, fp32 out and lse within
    1e-4, fp32 gradients within 1e-4 of their largest plain value."""
    from detr_tpu_torch.ops.attention import BF16_MAX_SHARE, BF16_MAX_ULPS, bf16_agreement

    rng = np.random.default_rng(D)
    B, L, S, H = 3, 130, 200, 2
    dt = getattr(torch, dtype)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(B, n, H, D)).astype(np.float32)).to(card, dt)
        .requires_grad_()
        for n in (L, S, S)
    )
    g = torch.from_numpy(rng.normal(size=(B, L, H, D)).astype(np.float32)).to(card, dt)
    mask = torch.from_numpy(np.arange(S)[None, :] >= np.array([[150], [37], [1]])).to(card)
    mask[2] = True
    before = (ma.launches, ma.launches_bwd_dkv, ma.launches_bwd_dq)
    out, lse = ma.masked_attention(q, k, v, mask, 0.1, 3)
    out.backward(g)
    assert (ma.launches, ma.launches_bwd_dkv, ma.launches_bwd_dq) == tuple(x + 1 for x in before)
    qd, kd, vd = (x.detach() for x in (q, k, v))
    ref_out, ref_lse = ma.masked_attention_reference(qd, kd, vd, mask, 3, 0.1)
    want = ma.masked_attention_backward_reference(qd, kd, vd, mask, g, out.detach(), lse, 3, 0.1)
    torch.cuda.synchronize()
    assert out.shape == (B, L, H, D) and out.dtype == dt
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    assert (lse[2] == F32_MIN).all()
    for got, ref in zip((out, q.grad, k.grad, v.grad), (ref_out, *want)):
        assert got.shape == ref.shape and got.dtype == dt
        if dtype == "bfloat16":
            max_ulps, share = bf16_agreement(got, ref)
            assert max_ulps <= BF16_MAX_ULPS and share <= BF16_MAX_SHARE, (max_ulps, share)
        elif got is out:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
        else:
            scale = float(ref.abs().max())
            assert float((got - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros(1, 4, 2, 64, device=card)
    with pytest.raises(ValueError, match="head size"):
        ma.masked_attention(q, q, q)
    q = torch.zeros(1, 4, 2, 32, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ma.masked_attention(q, q, q)
    q = torch.zeros(1, 4, 32, 2, device=card).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ma.masked_attention(q, q, q)


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(card):
    """Tiny DETR (ResNet-50 trunk) in fp32, same seeded weights: the card's
    engine (kernel path, TF32 off) against the CPU's (plain path).  Scores
    atol 1e-4, boxes atol 1e-2 px."""
    tiny = DETRConfig(num_object_queries=8, num_encoder_layers=1, num_decoder_layers=2,
                      num_attention_heads=8, hidden_size=256, ffn_scale_factor=2,
                      num_classes=3, dtype="float32")
    kw = dict(batch_size=2, buckets=((64, 96), (96, 64)), min_size=64, max_size=96)
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((64, 96), (96, 64), (50, 70))]
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        on_card = InferenceEngine(tiny, device="cuda", **kw)
        before = ma.launches
        got = on_card.predict(images)
        # two buckets -> two forwards of 1 + 2 * 2 attentions each
        assert ma.launches - before == 2 * 5
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    want = InferenceEngine(tiny, device="cpu", **kw).predict(images)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_match_plain_version_on_card(card, dtype, rate):
    """Dropout 0 and 0.1 (the kernels are built for each), ragged L (130) and
    S (200), a ragged key mask and a fully masked image, through the
    autograd Function.  bf16 (tensor cores, which
    sum in another order): each gradient within one bf16 ulp per element and
    at most 1 % of its elements differing (``bf16_agreement``); fp32 (scalar
    kernels): within 1e-4 of the plain version's largest value of that
    gradient.  A second backward gives the same bits (no atomics)."""
    from detr_tpu_torch.ops.attention import BF16_MAX_SHARE, BF16_MAX_ULPS, bf16_agreement

    rng = np.random.default_rng(3)
    B, L, S, H, D = 3, 130, 200, 8, 32
    dt = getattr(torch, dtype)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(B, n, H, D)).astype(np.float32)).to(card, dt)
        .requires_grad_()
        for n in (L, S, S)
    )
    g = torch.from_numpy(rng.normal(size=(B, L, H, D)).astype(np.float32)).to(card, dt)
    mask = torch.from_numpy(np.arange(S)[None, :] >= np.array([[150], [37], [1]])).to(card)
    mask[2] = True
    before = (ma.launches_bwd_dkv, ma.launches_bwd_dq)
    out, lse = ma.masked_attention(q, k, v, mask, rate, 5)
    assert out.grad_fn is not None
    out.backward(g, retain_graph=True)
    assert (ma.launches_bwd_dkv, ma.launches_bwd_dq) == (before[0] + 1, before[1] + 1)
    again = torch.autograd.grad(out, (q, k, v), g)
    want = ma.masked_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), mask, g, out.detach(), lse, 5, rate)
    torch.cuda.synchronize()
    for got, repeat, ref in zip((q.grad, k.grad, v.grad), again, want):
        assert got.dtype == dt
        assert torch.equal(got, repeat)
        if dtype == "bfloat16":
            max_ulps, share = bf16_agreement(got, ref)
            assert max_ulps <= BF16_MAX_ULPS and share <= BF16_MAX_SHARE, (max_ulps, share)
        else:
            scale = float(ref.float().abs().max())
            assert float((got.float() - ref.float()).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
def test_auction_kernel_matches_plain_version_on_card(card):
    """The kernel runs the plain version's rounds in the same fp32 order: the
    same assignments and round counts, and the same bits on a second launch.
    A small batch (6 problems, Q=32, G=16) and the training shape (N=30,
    Q=G=100) with n_valid cycling over 0, 1, 7, 31, 32, 33, 64 and 100
    (one warp's ballot edges and a full problem), random and
    near-identical rows; Q=200 (the kernel's build for Q above 128); the
    chunked build at Q=2048, G=20 (past 1024 queries) and at Q=1000, G=48
    (candidate lists too large for shared memory beside the benefit rows);
    and the caps hit at once (max_iters=1: the greedy completion).  Q=8192,
    G=8, whose shared state does not fit a block, raises before any launch
    and says so."""
    from detr_tpu_torch.matcher import auction as au

    rng = np.random.default_rng(4)
    cost = torch.from_numpy(rng.normal(size=(6, 32, 16)).astype(np.float32) * 3)
    valid = torch.from_numpy(rng.random((6, 16)) < 0.7)
    valid[1] = False
    N, Q = 30, 100
    dense_valid = torch.from_numpy(
        np.arange(Q)[None, :] < np.resize([0, 1, 7, 31, 32, 33, 64, 100], N)[:, None])
    dense = torch.from_numpy(rng.normal(size=(N, Q, Q)).astype(np.float32) * 3)
    contentious = torch.from_numpy(
        (rng.normal(size=(N, 1, Q)) * 3 + rng.normal(size=(N, Q, Q)) * 0.01).astype(np.float32))
    wide = torch.from_numpy(rng.normal(size=(4, 200, 60)).astype(np.float32) * 3)
    wide_valid = torch.from_numpy(rng.random((4, 60)) < 0.8)
    long = torch.from_numpy(rng.normal(size=(4, 2048, 20)).astype(np.float32) * 3)
    long_valid = torch.from_numpy(np.arange(20)[None, :] < np.array([[20], [13], [1], [0]]))
    tall = torch.from_numpy(rng.normal(size=(3, 1000, 48)).astype(np.float32) * 3)
    tall_valid = torch.from_numpy(rng.random((3, 48)) < 0.9)
    for c, v, max_iters in ((cost, valid, 4000), (dense, dense_valid, 4000),
                            (contentious, dense_valid, 4000), (wide, wide_valid, 4000),
                            (long, long_valid, 4000), (tall, tall_valid, 4000),
                            (dense, dense_valid, 1)):
        c, v = c.to(card), v.to(card)
        before = au.launches
        qog, rounds = au.auction_lap(c, v, eps_min=1e-3, max_iters=max_iters)
        assert au.launches == before + 1
        again = au.auction_lap(c, v, eps_min=1e-3, max_iters=max_iters)
        want, want_rounds = au.auction_lap_reference(c, v, eps_min=1e-3, max_iters=max_iters)
        assert torch.equal(qog, want) and torch.equal(rounds, want_rounds)
        assert torch.equal(qog, again[0]) and torch.equal(rounds, again[1])
    before = au.launches
    big = torch.zeros((1, 8192, 8), device=card)
    with pytest.raises(ValueError, match="shared memory"):
        au.auction_lap(big, torch.ones((1, 8), dtype=torch.bool, device=card))
    assert au.launches == before


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(card):
    """A small DETR (ResNet-50 trunk, 8 heads of 32) in fp32, dropout 0, TF32
    off: one train step on the card (kernels) and on the CPU (plain
    versions) from the same weights, with the same injected assignment.
    Every loss at rtol 1e-3, grad_norm at rtol 1e-3."""
    import dataclasses

    from detr_tpu_torch.config import TrainingConfig
    from detr_tpu_torch.data import synthetic_batch
    from detr_tpu_torch.models import DETR
    from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, make_train_step
    from detr_tpu_torch.train.trainer import to_device
    from detr_tpu_torch.utils.trees import assert_same_bits, tree_map

    cfg = DETRConfig(num_object_queries=8, num_encoder_layers=1, num_decoder_layers=2,
                     ffn_scale_factor=2, num_classes=7, dtype="float32",
                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    tc = TrainingConfig(train_batch_size=2, cumulative_train_batch_size=2)
    batch = synthetic_batch(np.random.default_rng(5), 2, 64, 96, max_gt=5, num_classes=7)
    qog = np.where(batch["gt_valid"][:, None, :], np.arange(5)[None, None, :], -1)
    qog = np.broadcast_to(qog, (2, 2, 5)).astype(np.int32)
    model = DETR(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    results = []
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in (card, torch.device("cpu")):
            m = DETR(cfg).to(device)
            m.load_state_dict(model.state_dict())
            crit = dataclasses.replace(build_criterion(tc, cfg),
                                       matcher=lambda *a, d=device: torch.from_numpy(qog).to(d))
            opt, _ = build_optimizer(m, tc)
            _, metrics = make_train_step(m, crit)(TrainState(m, opt, torch.Generator()),
                                                  to_device(batch, device))
            results.append({k: float(v) for k, v in metrics.items()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    got, want = results
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-3, abs=1e-5), key


@pytest.mark.gpu
def test_checkpoint_saved_on_card_restores_on_cpu(card, tmp_path):
    """A small DETR trained three micro-steps on the card (accumulation 2:
    one update, half an accumulation held, dropout 0.1), saved, and restored
    into a fresh state on the CPU: every parameter, frozen statistic, moment,
    accumulated gradient, count and the generator equal the card's, bit for
    bit."""
    from detr_tpu_torch.config import TrainingConfig
    from detr_tpu_torch.data import synthetic_batch
    from detr_tpu_torch.models import DETR
    from detr_tpu_torch.train import TrainState, build_criterion, build_optimizer, make_train_step
    from detr_tpu_torch.train.checkpoint import CheckpointManager
    from detr_tpu_torch.train.trainer import to_device
    from detr_tpu_torch.utils.trees import assert_same_bits, tree_map

    cfg = DETRConfig(num_object_queries=8, num_encoder_layers=1, num_decoder_layers=2,
                     ffn_scale_factor=2, num_classes=7)
    tc = TrainingConfig(train_batch_size=2, cumulative_train_batch_size=4, max_gt_boxes=5)
    model = DETR(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(card)
    opt, _ = build_optimizer(model, tc)
    state = TrainState(model, opt, torch.Generator().manual_seed(0))
    step = make_train_step(model, build_criterion(tc, cfg))
    for i in range(3):
        batch = synthetic_batch(np.random.default_rng(i), 2, 64, 96, max_gt=5, num_classes=7)
        state, _ = step(state, to_device(batch, card))
    CheckpointManager(str(tmp_path)).save(0, state, extra={"epoch": 0})

    cpu_model = DETR(cfg)
    cpu_opt, _ = build_optimizer(cpu_model, tc)
    restored, extra = CheckpointManager(str(tmp_path)).restore(
        TrainState(cpu_model, cpu_opt, torch.Generator()))
    assert extra == {"epoch": 0} and restored.step == 3

    def same(want, got):  # bit for bit, every restored tensor on the CPU
        devices = set()
        tree_map(lambda t: devices.add(t.device.type), got)
        assert devices == {"cpu"}
        assert_same_bits(want, got)

    same(model.state_dict(), cpu_model.state_dict())
    want = opt.state_dict()
    assert want["acc"] is not None and want["updates"] == 1
    same(want, cpu_opt.state_dict())
    assert torch.equal(state.generator.get_state(), restored.generator.get_state())


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "high", "medium"])
def test_device_resize_on_card_is_true_fp32(card, precision):
    """The device-resize wire's products in true fp32 on the card whatever
    the process sets for fp32 matmuls (TF32 at "high", bf16 at "medium"):
    within 1e-3 uint8 levels of the CPU (TF32 would be 0.1-0.25), padding
    exactly 0, and the process's setting given back."""
    from detr_tpu_torch.ops.device_resize import resize_on_device

    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    ext = [np.array(v, np.int32) for v in ((96, 70), (128, 90), (150, 200), (200, 64))]
    args = [torch.from_numpy(a) for a in (src, *ext)]
    want = resize_on_device(*args, (208, 224))
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        got = resize_on_device(*(a.to(card) for a in args), (208, 224))
        torch.cuda.synchronize()
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(previous)
    got = got.cpu()
    assert float((got - want).abs().max()) <= 1e-3
    assert not got[0, 150:].any() and not got[1, 200:].any() and not got[1, :, 64:].any()


COCO_SIZES = ((480, 640), (427, 640), (640, 640), (640, 480), (640, 427))


@pytest.mark.gpu
def test_source_wire_canvas_on_card_matches_host_canvas(card):
    """COCO-sized uint8 requests onto 800x1344 and 1344x800: the canvas the
    card's forward receives (the sources resampled, rounded and normalised
    on the card) against the host wire's (``ValTransform``,
    ``fit_to_bucket``, the float32 canvas).  Recovered as uint8 levels: at
    most one apart, and on at most 5 % of the pixels; exactly 0.0 outside
    each image."""
    from detr_tpu_torch.data.bucketing import EVAL_BUCKETS, fit_to_bucket, pick_bucket
    from detr_tpu_torch.data.transforms import _NORM_BIAS, _NORM_SCALE
    from detr_tpu_torch.serve.engine import _empty_target

    tiny = DETRConfig(num_object_queries=8, num_encoder_layers=1, num_decoder_layers=1,
                      num_attention_heads=8, hidden_size=256, ffn_scale_factor=2,
                      num_classes=3)
    engine = InferenceEngine(tiny, batch_size=8, device="cuda")
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in COCO_SIZES]
    seen = []
    engine.model.register_forward_pre_hook(lambda _m, args: seen.append(args[0].cpu()))
    engine.predict(images)
    # landscape and square sources share the wide bucket, portrait the tall
    assert [tuple(x.shape[1:3]) for x in seen] == list(EVAL_BUCKETS)

    def levels(x):
        return np.rint((x + _NORM_BIAS) / _NORM_SCALE).astype(int)

    rows = {0: 0, 1: 0}
    for img in images:
        timg, _ = engine.transform(img, _empty_target())
        bid = pick_bucket(timg.shape[0], timg.shape[1], EVAL_BUCKETS)
        timg, _ = fit_to_bucket(timg, _empty_target(), EVAL_BUCKETS[bid])
        th, tw = timg.shape[:2]
        mine = seen[bid][rows[bid]].numpy()
        rows[bid] += 1
        assert not mine[th:].any() and not mine[:, tw:].any()
        diff = np.abs(levels(mine[:th, :tw]) - levels(timg))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.05, (img.shape, (diff > 0).mean())


@pytest.mark.gpu
def test_source_wire_peak_memory_is_the_host_wires(card):
    """DETR-R50 at batch 8 on 800x1344: one ``predict`` of 8 COCO-sized
    requests on the source wire holds at most 1 % more device memory at its
    peak than on the host wire (the same requests as float32): the
    resample's tensors are gone before the forward."""
    engine = InferenceEngine(DETRConfig(), batch_size=8, device="cuda")
    engine.warmup()
    rng = np.random.default_rng(10)
    images = [rng.integers(0, 256, (*COCO_SIZES[i % 3], 3), dtype=np.uint8) for i in range(8)]
    peaks = {}
    for wire, batch in (("host", [img.astype(np.float32) for img in images]),
                        ("source", images), ("host", [img.astype(np.float32) for img in images])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine.predict(batch)
        torch.cuda.synchronize()
        peaks[wire] = torch.cuda.max_memory_allocated()
    assert peaks["source"] <= 1.01 * peaks["host"], peaks


# The deformable cell's four levels at its 832x1344 canvas (strides 8-64).
MSDA_LEVELS = ((104, 168), (52, 84), (26, 42), (13, 21))


def _msda_inputs(device, dtype, B, Lq, H=8, D=32, P=4, levels=MSDA_LEVELS, seed=0):
    """Value, locations and weights at ``levels``.  Each location lies in a
    cell of its level's pixel grid at a fraction 0.05-0.95 of the way across
    it on both axes, the cells drawn from [-1, W_l] x [-1, H_l] so that some
    samples have corners outside the map: the kernel (px = x * W - 0.5) and
    grid_sample (((2x - 1) + 1) * W - 1) / 2) round px differently by an ulp,
    and a location within an ulp of a cell edge would put them in
    neighbouring cells, where the bilinear derivative jumps."""
    gen = torch.Generator(device=device).manual_seed(seed)
    S = sum(h * w for h, w in levels)
    L = len(levels)
    value = torch.randn(B, S, H, D, generator=gen, device=device).to(dtype)
    locs = []
    for h, w in levels:
        cell = torch.stack([torch.randint(-1, w, (B, Lq, H, P), generator=gen, device=device),
                            torch.randint(-1, h, (B, Lq, H, P), generator=gen, device=device)], -1)
        frac = 0.05 + 0.9 * torch.rand(B, Lq, H, P, 2, generator=gen, device=device)
        size = torch.tensor([w, h], dtype=torch.float32, device=device)
        locs.append((cell.float() + frac + 0.5) / size)
    loc = torch.stack(locs, dim=3)
    logits = torch.randn(B, Lq, H, L * P, generator=gen, device=device)
    attn = torch.softmax(logits, -1).view(B, Lq, H, L, P)
    return value, loc, attn


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_msda_kernels_match_plain_version_on_card(card, dtype):
    """The MSDA forward and backward kernels against the plain grid_sample
    version at the deformable cell's encoder shapes (4 levels of 832x1344,
    Lq = S = 23,205, 8 heads of 32, 4 points; B 2), with corners outside the
    map.  Both sum the same fp32 products of the same inputs in another
    order (and the kernel's d value with atomics), which moves a sum by
    ~1e-6 of its terms' absolute sum: fp32 outputs and gradients within
    1e-4 of their largest element (fp8 e4m3's 3 mantissa bits would miss
    by ~1e-1); bf16 out and d value within one bf16 ulp, at most 1 % of
    the elements differing (``bf16_agreement``).  The locations' and
    weights' gradients are fp32 in both dtypes, and repeat bit for bit."""
    from detr_tpu_torch.ops import ms_deform_attn as msda
    from detr_tpu_torch.ops.attention import BF16_MAX_SHARE, BF16_MAX_ULPS, bf16_agreement

    dt = getattr(torch, dtype)
    value, loc, attn = _msda_inputs(card, dt, B=2, Lq=sum(h * w for h, w in MSDA_LEVELS))
    value.requires_grad_(True)
    loc.requires_grad_(True)
    attn.requires_grad_(True)
    g = torch.randn(*loc.shape[:3], value.shape[-1], device=card).to(dt)
    before = (msda.launches, msda.launches_bwd)
    out = msda.ms_deform_attn(value, MSDA_LEVELS, loc, attn)
    got = torch.autograd.grad(out, (value, loc, attn), g)
    assert (msda.launches, msda.launches_bwd) == (before[0] + 1, before[1] + 1)
    again = torch.autograd.grad(msda.ms_deform_attn(value, MSDA_LEVELS, loc, attn),
                                (value, loc, attn), g)
    ref = msda.ms_deform_attn_reference(value, MSDA_LEVELS, loc, attn)
    want = torch.autograd.grad(ref, (value, loc, attn), g)
    torch.cuda.synchronize()
    assert out.dtype == dt and got[0].dtype == dt
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])

    def close(a, b):
        a, b = a.float(), b.float()
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-4, err

    if dtype == "bfloat16":
        for a, b in ((out, ref), (got[0], want[0])):
            max_ulps, share = bf16_agreement(a, b)
            assert max_ulps <= BF16_MAX_ULPS and share <= BF16_MAX_SHARE, (max_ulps, share)
    else:
        close(out, ref)
        close(got[0], want[0])
    close(got[1], want[1])
    close(got[2], want[2])


@pytest.mark.gpu
def test_msda_kernel_rejects_what_it_does_not_take(card):
    from detr_tpu_torch.ops import ms_deform_attn as msda

    value, loc, attn = _msda_inputs(card, torch.bfloat16, B=1, Lq=5, levels=((4, 4), (2, 2)))
    with pytest.raises(ValueError):  # the levels do not hold S rows
        msda.ms_deform_attn(value, ((4, 4), (2, 3)), loc, attn)
    with pytest.raises(ValueError):  # fp16 values
        msda.ms_deform_attn(value.half(), ((4, 4), (2, 2)), loc, attn)
    with pytest.raises(ValueError):  # head size 64
        msda.ms_deform_attn(torch.cat([value, value], -1), ((4, 4), (2, 2)), loc, attn)


# (shape, rate, seed, batch_offset, col_offset, total_cols, layout): a ragged
# numel (not a multiple of 8) plain and with offsets whose rows end inside a
# 16-byte vector, DC5's FFN hidden (8 x 4368 tokens x 2048) and Deformable
# DETR's (4 x 23,205 x 1024) at the resident cells' micro-batches, a tensor
# parallel rank's FFN columns, a data parallel rank's batch rows, an input
# that does not start on 16 bytes, and a transposed one
DROPOUT_CASES = {
    "ragged": ((3, 37, 51), 0.5, 7, 0, 0, None, "plain"),
    "ragged_offsets": ((3, 37, 51), 0.1, 2**31 - 2, 2, 51, 153, "plain"),
    "dc5_ffn": ((8, 4368, 2048), 0.1, 1234, 0, 0, None, "plain"),
    "deformable_ffn": ((4, 23205, 1024), 0.1, 99, 0, 0, None, "plain"),
    "tp_cols": ((2, 1092, 1024), 0.1, 5, 2, 1024, 2048, "plain"),
    "dp_rows": ((4, 1092, 256), 0.1, 6, 4, 0, None, "plain"),
    "unaligned": ((5, 33, 64), 0.1, 8, 0, 0, None, "offset"),
    "transposed": ((6, 40, 32), 0.1, 9, 0, 0, None, "transposed"),
}


def _dropout_input(card, dtype, shape, layout, seed):
    """A tensor of ``shape`` with a NaN, an inf or a -inf at every seventh
    element: contiguous, one element into its storage, or a transpose."""
    gen = torch.Generator(device=card).manual_seed(seed)
    n = int(np.prod(shape))
    flat = torch.randn(n + 1, generator=gen, device=card).to(dtype)
    flat[1::21], flat[8::21], flat[15::21] = float("nan"), float("inf"), float("-inf")
    if layout == "offset":
        return flat[1:].view(shape)
    if layout == "transposed":
        return flat[:n].view(*shape[:-2], shape[-1], shape[-2]).transpose(-1, -2)
    return flat[:n].view(shape)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(DROPOUT_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_dropout_kernel_matches_plain_path_on_card(card, dtype, case):
    """The kernel (one launch each way) against the plain composition
    ``hash_dropout_reference`` run on the card, bit for bit: the output and
    the input's gradient, NaN and inf included (a dropped one is +0)."""
    from detr_tpu_torch.ops import dropout

    shape, rate, seed, b0, c0, width, layout = DROPOUT_CASES[case]
    dt = getattr(torch, dtype)
    bits = torch.int16 if dt == torch.bfloat16 else torch.int32
    x = _dropout_input(card, dt, shape, layout, seed)
    dy = _dropout_input(card, dt, shape, "plain", seed + 1)
    leaf = x.detach().requires_grad_(True)
    before = (dropout.launches, dropout.launches_bwd)
    got = dropout.hash_dropout(leaf, rate, seed, False, b0, c0, width)
    (got_dx,) = torch.autograd.grad(got, leaf, dy)
    assert (dropout.launches, dropout.launches_bwd) == (before[0] + 1, before[1] + 1)
    ref_leaf = x.detach().requires_grad_(True)
    want = dropout.hash_dropout_reference(ref_leaf, rate, seed, b0, c0, width)
    (want_dx,) = torch.autograd.grad(want, ref_leaf, dy)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == x.shape and got_dx.dtype == dt
    assert torch.equal(got.contiguous().view(bits), want.contiguous().view(bits))
    assert torch.equal(got_dx.contiguous().view(bits), want_dx.contiguous().view(bits))
    assert abs(float((want == 0).float().mean()) - rate) < 0.05


@pytest.mark.gpu
def test_hash_dropout_kernel_rejects_what_it_does_not_take(card):
    from detr_tpu_torch.ops import dropout

    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            dropout.hash_dropout(torch.ones(4, 8, device=card, dtype=dt), 0.1, 3, False)


@pytest.mark.gpu
def test_hash_dropout_launch_counters_count_launches_made(card):
    """The counters move where the kernel launches: a direct launch of
    either way counts one in its own counter, an empty tensor none."""
    from detr_tpu_torch.ops import dropout

    x = torch.ones(3, 40, device=card, dtype=torch.bfloat16)
    before = (dropout.launches, dropout.launches_bwd)
    dropout._kernel(x, 0.1, 3, 0, 0, None)
    assert (dropout.launches, dropout.launches_bwd) == (before[0] + 1, before[1])
    dropout._kernel(x, 0.1, 3, 0, 0, None, backward=True)
    assert (dropout.launches, dropout.launches_bwd) == (before[0] + 1, before[1] + 1)
    empty = torch.empty(0, 40, device=card, dtype=torch.bfloat16, requires_grad=True)
    y = dropout.hash_dropout(empty, 0.1, 3, False)
    torch.autograd.grad(y, empty, torch.empty_like(y))
    assert (dropout.launches, dropout.launches_bwd) == (before[0] + 1, before[1] + 1)
