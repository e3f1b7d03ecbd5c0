from detr_tpu_torch.matcher.auction import assignment_total_cost, auction_lap
from detr_tpu_torch.matcher.hungarian import (
    HungarianMatcher,
    compute_cost_matrix,
    match_batch,
    scipy_match_batch,
)

__all__ = [
    "assignment_total_cost",
    "auction_lap",
    "HungarianMatcher",
    "compute_cost_matrix",
    "match_batch",
    "scipy_match_batch",
]
