"""Deformable DETR's operations and bytes: the forward's FLOPs at a canvas,
and the least time of one multi-scale deformable attention (MSDA) call.

FLOPs as ``flops`` counts them (2 per multiply-add of every convolution and
matrix product the forward needs; elementwise work, norms, softmax and
MSDA's bilinear gathers not counted; training 3x the forward): the trunk
(``flops.trunk_flops``), the four levels' input projections, per encoder
layer over all S tokens the value projection, the sampling offsets and
attention weights, the output projection and the FFN, per decoder layer
over its Q queries the self-attention's four projections and its q.k and
P.v, the cross-attention's value projection over the S memory tokens and
its three projections of the queries, the FFN, and the shared heads; the
reference points once.
"""

from __future__ import annotations

from benchmark.flops import PEAK_BYTES, PEAK_FLOPS, _out, trunk_flops

TRUNK_CHANNELS = (512, 1024, 2048)


def level_shapes(cfg: dict, h: int, w: int) -> list[tuple[int, int]]:
    """Each level's (h, w) at canvas (h, w): the trunk's C3, C4 and C5, then
    stride-2 3x3 convolutions."""
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)  # stem
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # max pool: C2
    shapes = []
    for stage in (2, 3, 4):
        if not (cfg["dilation"] and stage == 4):
            h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
        shapes.append((h, w))
    while len(shapes) < cfg["num_feature_levels"]:
        h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
        shapes.append((h, w))
    return shapes


def forward_flops(cfg: dict, h: int, w: int) -> int:
    """FLOPs of one image's forward at canvas (h, w)."""
    total, _ = trunk_flops(h, w, cfg["backbone"], cfg["dilation"])
    d = cfg["hidden_size"]
    dff = d * cfg["ffn_scale_factor"]
    H, L = cfg["num_attention_heads"], cfg["num_feature_levels"]
    Q = cfg["num_object_queries"]
    shapes = level_shapes(cfg, h, w)
    S = sum(a * b for a, b in shapes)
    for lvl, (a, b) in enumerate(shapes):
        if lvl < len(TRUNK_CHANNELS):
            total += 2 * TRUNK_CHANNELS[lvl] * d * a * b
        else:
            cin = TRUNK_CHANNELS[-1] if lvl == len(TRUNK_CHANNELS) else d
            total += 2 * cin * 9 * d * a * b

    def msda(lq: int, points: int) -> int:
        samples = H * L * points
        return (2 * S * d * d  # value projection of every memory token
                + 2 * lq * d * (3 * samples)  # sampling offsets (x, y) and weights
                + 2 * lq * d * d)  # output projection

    ffn = 2 * 2 * d * dff
    total += cfg["num_encoder_layers"] * (msda(S, cfg["enc_n_points"]) + S * ffn)
    self_attn = 4 * 2 * Q * d * d + 2 * 2 * Q * Q * d
    total += cfg["num_decoder_layers"] * (self_attn + msda(Q, cfg["dec_n_points"]) + Q * ffn)
    n = cfg["box_embedding_mlp_num_layers"]
    heads = Q * (2 * d * cfg["num_classes"] + 2 * d * d * (n - 1) + 2 * d * 4)
    total += cfg["num_decoder_layers"] * heads + 2 * Q * d * 2
    return total


def msda_bounds(b: int, lq: int, s: int, heads: int, d: int, levels: int, points: int,
                dtype: str = "bfloat16") -> tuple[float, float]:
    """Least seconds of one MSDA call's forward and of its backward (D = d
    per head): the larger of operations at the fp32 CUDA-core peak
    (``PEAK_FLOPS["float32"]``: the gathers are no matrix product) and bytes
    at the memory rate.  Operations: 8 * D per sample forward (four corners'
    multiply-adds over D channels), 4x that backward.  Bytes: every input
    read once and every output written once; forward the value (B, S, H, D)
    in the compute dtype, the fp32 locations (2 per sample) and weights, the
    output (B, Lq, H, D); backward those inputs, the output's gradient, and
    the value's, locations' and weights' gradients."""
    elt = 2 if dtype == "bfloat16" else 4
    samples = b * lq * heads * levels * points
    value = b * s * heads * d * elt
    rows = b * lq * heads * d * elt
    loc, weights = 8 * samples, 4 * samples
    fwd = (8 * d * samples, value + loc + weights + rows)
    bwd = (32 * d * samples, 2 * (value + loc + weights) + rows)
    return tuple(max(ops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES) for ops, nbytes in (fwd, bwd))
