from detr_tpu_torch.data.bucketing import (
    DEFAULT_BUCKETS,
    EVAL_BUCKETS,
    assemble_batch,
    fit_to_bucket,
    pick_bucket,
)
from detr_tpu_torch.data.coco import CocoDataset
from detr_tpu_torch.data.loader import BucketedLoader, make_eval_loader
from detr_tpu_torch.data.prefetch import DevicePlacement, prefetch_to_device
from detr_tpu_torch.data.synthetic import SyntheticCocoDataset, synthetic_batch
from detr_tpu_torch.data.transforms import (
    TrainTransform,
    ValTransform,
    get_train_transforms,
    get_val_transforms,
)

__all__ = [
    "synthetic_batch",
    "SyntheticCocoDataset",
    "CocoDataset",
    "BucketedLoader",
    "make_eval_loader",
    "prefetch_to_device",
    "DevicePlacement",
    "get_train_transforms",
    "get_val_transforms",
    "TrainTransform",
    "ValTransform",
    "DEFAULT_BUCKETS",
    "EVAL_BUCKETS",
    "assemble_batch",
    "pick_bucket",
    "fit_to_bucket",
]
