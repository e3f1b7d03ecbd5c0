from detr_tpu_torch.losses.criterion import SetCriterion, total_loss

__all__ = ["SetCriterion", "total_loss"]
