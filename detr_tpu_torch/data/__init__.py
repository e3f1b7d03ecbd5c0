from detr_tpu_torch.data.bucketing import EVAL_BUCKETS, fit_to_bucket, pick_bucket
from detr_tpu_torch.data.synthetic import SyntheticCocoDataset, synthetic_batch
from detr_tpu_torch.data.transforms import ValTransform

__all__ = [
    "EVAL_BUCKETS",
    "fit_to_bucket",
    "pick_bucket",
    "SyntheticCocoDataset",
    "synthetic_batch",
    "ValTransform",
]
