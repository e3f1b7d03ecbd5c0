from detr_tpu_torch.eval.coco_eval import CocoEvaluator
from detr_tpu_torch.eval.metrics import DetectionMetrics
from detr_tpu_torch.eval.postprocess import PostProcess, postprocess_predictions

__all__ = ["CocoEvaluator", "DetectionMetrics", "PostProcess", "postprocess_predictions"]
