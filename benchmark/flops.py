"""Operations and bytes: the model's FLOPs at a canvas, the attention
kernels' least work, and the H100's published peaks.

A FLOP is one multiply or one add of a product (2 per multiply-add), counted
for the convolutions and matrix products the forward needs, as
``torch.utils.flop_counter`` counts them; elementwise work, norms and
softmax are not counted.  Training counts 3x the forward (the backward
computes the gradients of both operands of every product).
"""

from __future__ import annotations

STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def _out(n: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def trunk_flops(h: int, w: int, backbone: str = "resnet50", dilation: bool = False):
    """(FLOPs of the trunk's convolutions for one (h, w) image, the feature
    map's (fh, fw))."""
    total = 0

    def conv(cin, cout, k, s, d, hh, ww):
        nonlocal total
        p = d * (k - 1) // 2
        ho, wo = _out(hh, k, s, p, d), _out(ww, k, s, p, d)
        total += 2 * cin * cout * k * k * ho * wo
        return ho, wo

    h, w = conv(3, 64, 7, 2, 1, h, w)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), STAGES[backbone]), 1):
        dil_stage = dilation and stage == 4
        for b in range(n):
            stride = 1 if (b > 0 or stage == 1 or dil_stage) else 2
            dil = 2 if (dil_stage and b > 0) else 1
            conv(cin, planes, 1, 1, 1, h, w)
            ho, wo = conv(planes, planes, 3, stride, dil, h, w)
            conv(planes, planes * 4, 1, 1, 1, ho, wo)
            if b == 0:
                conv(cin, planes * 4, 1, stride, 1, h, w)
            h, w, cin = ho, wo, planes * 4
    return total, (h, w)


def attention_calls(cfg: dict, tokens: int) -> list[tuple[int, int, bool]]:
    """(L, S, masked) of each attention call of one forward."""
    q = cfg["num_object_queries"]
    enc = [(tokens, tokens, True)] * cfg["num_encoder_layers"]
    dec = [(q, q, False), (q, tokens, True)] * cfg["num_decoder_layers"]
    return enc + dec


def forward_flops(cfg: dict, h: int, w: int) -> int:
    """FLOPs of one image's forward at canvas (h, w)."""
    total, (fh, fw) = trunk_flops(h, w, cfg["backbone"], cfg["dilation"])
    d = cfg["hidden_size"]
    dff = d * cfg["ffn_scale_factor"]
    S = fh * fw
    Q = cfg["num_object_queries"]
    L = cfg["num_decoder_layers"]
    total += 2 * 2048 * d * S
    for lq, s, _ in attention_calls(cfg, S):
        total += 2 * lq * d * d * 2 + 2 * s * d * d * 2  # q, o from the queries; k, v
        total += 2 * 2 * lq * s * d  # q.k and p.v
    total += cfg["num_encoder_layers"] * 2 * 2 * S * d * dff
    total += L * 2 * 2 * Q * d * dff
    c1 = cfg["num_classes"] + 1
    n = cfg["box_embedding_mlp_num_layers"]
    total += L * Q * (2 * d * c1 + 2 * d * d * (n - 1) + 2 * d * 4)
    return total


def attention_bounds(b: int, lq: int, s: int, masked: bool, heads: int, d: int,
                     dtype: str = "bfloat16") -> tuple[float, float]:
    """Least seconds of one attention call's forward and of its backward:
    the larger of operations (2 per multiply-add of each product the
    function needs: q.k and P.v forward; q.k, dP = g.v, dV = P g, dQ = dS k,
    dK = dS q backward) over the peak, and bytes (every input read once,
    every output written once) over the memory rate."""
    elt = 2 if dtype == "bfloat16" else 4
    rows = b * heads * d * elt
    stats = 4 * b * heads * lq  # one fp32 per query row: lse, delta
    mask = b * s if masked else 0
    fwd = (4 * b * heads * lq * s * d, rows * (2 * lq + 2 * s) + stats + mask)
    bwd = (10 * b * heads * lq * s * d, rows * (3 * lq + 4 * s) + 2 * stats + mask)
    return tuple(max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES) for ops, nbytes in (fwd, bwd))
