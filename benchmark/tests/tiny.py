"""A tiny configuration and traffic of each kind, for the CPU tests: never a
cell.  The matcher's epsilon is near zero here, so that the port's auction
and the reference's exact assignment agree and the numbers compared read
round-off alone."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]

MODEL = dict(backbone="resnet50", dilation=False, temperature=10000, num_object_queries=8,
             num_encoder_layers=1, num_decoder_layers=2, num_attention_heads=2, hidden_size=16,
             ffn_scale_factor=2, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
             box_embedding_mlp_num_layers=3, initializer_range=0.02, layer_norm_eps=1e-5,
             num_classes=80, dtype="float32", padding_mask_mode="full")
SIZES = [[48, 64], [64, 48], [64, 64]]
TRAFFIC = {
    "resident": dict(kind="train", feed="resident", micro_batch=2, accumulation=2,
                     canvas=[64, 96], batches=6, min_extent_share=0.6, prefetch_depth=2,
                     boxes_per_image_mean=3, max_gt=8, checked_steps=3, reference_rows=1,
                     trace_micro_steps=2),
    "coco": dict(kind="train", feed="coco", micro_batch=2, accumulation=2,
                 buckets=[[64, 96], [96, 64], [80, 80]], num_workers=0, prefetch_depth=2,
                 photometric_distort=True, images=12, labels=48, source_sizes=SIZES,
                 boxes_per_image_mean=3, max_boxes=8, max_gt=8, checked_steps=3,
                 reference_rows=1, trace_micro_steps=2),
    "poisson": dict(kind="serve", arrivals="poisson", rate_per_s=4.0, batch_size=2, pool=6,
                    source_sizes=SIZES, min_size=64, max_size=96, buckets=[[64, 96], [96, 64]],
                    checked_requests=3, trace_seconds=1.0, host_threads=2),
    "backlog": dict(kind="serve", arrivals="backlog", batch_size=2, pool=6, source_sizes=SIZES,
                    min_size=64, max_size=96, buckets=[[64, 96], [96, 64]], checked_requests=3,
                    trace_calls=2, host_threads=2),
}
# fp32 on both sides with an exact matcher: round-off reads ~1e-5 at most;
# the served score ~2e-4 in log space (the resize rounds a few pixels apart).
LIMITS = {"train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3},
          "serve": {"score_gap": 1e-3, "box_gap": 1e-4}}
SEED = 2**31 + 7


def config(dtype: str = "float32") -> dict:
    cfg = copy.deepcopy(json.loads((ROOT / "benchmark/configs/detr_r50.json").read_text()))
    cfg["model"] = dict(MODEL, dtype=dtype)
    cfg["train"]["matcher_eps_min"] = 1e-7
    return cfg


def make_run(kind: str, trace: bool = False, seconds: float = 1.0) -> harness.Run:
    traffic = TRAFFIC[kind]
    limits = {k: {"limit": v} for k, v in LIMITS[traffic["kind"]].items()}
    return harness.Run({"name": f"tiny_{kind}", "chips": 1}, config(), dict(traffic), SEED,
                       seconds, trace, time.perf_counter(), limits)
