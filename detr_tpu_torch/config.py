"""Model and training configuration of the PyTorch port.

The port's own copies of ``detr_tpu.config.DETRConfig`` and
``TrainingConfig``: the same field names and defaults, so a configuration
carries over one to one.  The Pallas toggle, which only steers the JAX
package, is left out: in the port every attention runs through
``ops.masked_attention``.  ``DeformableDETRConfig`` extends ``DETRConfig``
with Deformable DETR's fields.  ``TrainingConfig`` holds the fields the
trainer reads: the synthetic and COCO paths with both wires (``device_resize``),
validation and its image grids (``save_image_epochs``), checkpointing, the
watchdog, the host memory limit and the multi-rank grid (``num_devices``,
``model_parallel``).  XLA's buffer donation is not ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class DETRConfig:
    """Model hyperparameters.

    Defaults reproduce DETR-R50: 100 queries, 6+6 transformer layers, 8 heads,
    d_model 256, FFN 2048 (256*8), dropout 0.1, 80 COCO classes (+1 no-object).
    """

    backbone: str = "resnet50"  # "resnet50" | "resnet101"
    # Dilated C5 variant (DETR-DC5): stride-16 final stage via dilation, 2x tokens.
    dilation: bool = False
    temperature: int = 10000  # positional-encoding frequency temperature
    num_object_queries: int = 100
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    num_attention_heads: int = 8
    hidden_size: int = 256
    ffn_scale_factor: int = 8  # FFN width = hidden_size * 8 = 2048
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    box_embedding_mlp_num_layers: int = 3
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-5
    num_classes: int = 80
    # Compute dtype of convolutions, Dense layers and attention; parameters
    # stay fp32.
    dtype: str = "bfloat16"
    # "full" masks the whole L-shaped pad region (official DETR); "corner"
    # masks only rows >= h AND cols >= w, as the original reference did.
    padding_mask_mode: str = "full"  # "full" | "corner"
    # A converted torchvision trunk (.npz of ``models.convert``'s
    # ``save_backbone_npz`` layout) that the trainer loads instead of
    # calibrating a random one.
    backbone_weights: Optional[str] = None
    # Recompute each encoder and decoder layer's activations in the backward
    # pass (torch.utils.checkpoint) instead of keeping them: less device
    # memory for a second forward of the transformer.
    remat: bool = False

    @property
    def head_size(self) -> int:
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide by num_attention_heads")
        return self.hidden_size // self.num_attention_heads

    @property
    def ffn_hidden_size(self) -> int:
        return self.hidden_size * self.ffn_scale_factor

    @property
    def backbone_stride(self) -> int:
        """Total stride of the extracted feature map."""
        return 16 if self.dilation else 32

    @property
    def backbone_channels(self) -> int:
        return 2048

    def replace(self, **kw) -> "DETRConfig":
        return dataclasses.replace(self, **kw)


@dataclass
class DeformableDETRConfig(DETRConfig):
    """Deformable DETR-R50 (arXiv:2010.04159, ``models.deformable_detr``):
    defaults at the published widths (Table 1 and the reference code's
    ``main.py``): 300 queries, FFN 1024 (256*4), 4 feature levels (C3-C5
    and a stride-2 convolution of C5), 4 sampling points per head and level
    in the encoder and the decoder; the rest as ``DETRConfig``.  Its
    training recipe's two settings live here too: the sigmoid focal loss's
    and focal matching cost's alpha (gamma is 2), and the learning-rate
    multiplier of the sampling offsets and reference points, a third
    parameter group (``train.optimizer``)."""

    num_object_queries: int = 300
    ffn_scale_factor: int = 4
    num_feature_levels: int = 4
    enc_n_points: int = 4
    dec_n_points: int = 4
    focal_alpha: float = 0.25
    lr_linear_proj_mult: float = 0.1


@dataclass
class TrainingConfig:
    """Trainer hyperparameters (the reference's detr/train.py defaults)."""

    output_dir: str = "runs/detr"
    start_epoch: int = 0
    # Weights-only resume: another run's output_dir (fresh optimizer; the
    # schedule starts at start_epoch).  Ignored when output_dir already holds
    # checkpoints, which are restored in full instead.
    resume_from_checkpoint: Optional[str] = None

    # <root>/{train,validation}/{data/*.jpg,labels.json} (data.coco)
    coco_dataset_root: str = "datasets/coco-2017"

    # Effective batch 64 via gradient accumulation.
    cumulative_train_batch_size: int = 64
    train_batch_size: int = 5
    val_batch_size: int = 25

    epochs: int = 100
    limit_train_iters: int = 0
    limit_val_iters: int = 0

    # Warmup -> hold -> cosine schedule, stepped once per epoch.
    lr: float = 3e-4
    lr_backbone: float = 3e-5  # backbone always 10x lower
    lr_warmup_epochs: int = 5
    lr_warmup_decay: float = 0.01
    lr_hold_max_epochs: int = 35
    lr_min: float = 3e-6

    weight_decay: float = 1e-4
    # None: every trainable parameter decays at weight_decay (the reference,
    # which declares the field and never wires it).  A float: LayerNorm
    # parameters decay at this rate instead (train.optimizer).
    norm_weight_decay: Optional[float] = None
    gradient_max_norm: float = 1.0  # <= 0 disables clipping

    # "bf16" (fp32 parameters, bf16 compute with fp32 islands) or "no" (fp32
    # everywhere).  The trainer maps this onto DETRConfig.dtype.
    mixed_precision: str = "bf16"

    seed: int = 0
    log_frequency: int = 100
    # Full-state checkpoint every checkpoint_epochs epochs, the newest
    # checkpoint_total_limit kept; validation with COCO mAP every eval_epochs
    # epochs and after the last.
    checkpoint_total_limit: int = 3
    checkpoint_epochs: int = 1
    eval_epochs: int = 10
    # Log the ground-truth and prediction image grids of the first
    # validation batch on validations at epochs that are multiples of this.
    save_image_epochs: int = 1

    # Decode-and-augment worker processes of the loader (data.loader).
    num_workers: int = 2

    # Matcher cost weights.
    set_cost_class: float = 1.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0

    # Loss coefficients.
    label_ce_loss_coef: float = 1.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    eos_coef: float = 0.1

    # Aspect-ratio buckets (height, width): images are padded into the
    # smallest that fits; the synthetic loader uses the first.
    shape_buckets: Tuple[Tuple[int, int], ...] = (
        (832, 1344),
        (1344, 832),
        (1056, 1056),
    )
    # The eval loader's landscape (height, width), with its transpose for
    # portrait images.
    eval_shape: Tuple[int, int] = (800, 1344)
    # The val transform's shortest and longest side.
    val_min_size: int = 800
    val_max_size: int = 1333
    # GT slots per image after padding.
    max_gt_boxes: int = 100
    # Batches made and copied to the card ahead of the step by a background
    # thread (data.prefetch); 0 makes each batch when the step asks for it.
    prefetch_depth: int = 2
    # Ship augmented images as uint8 and normalise them on the card
    # (ops.image_norm): a quarter of the bytes to copy.  False normalises on
    # the host.
    device_normalize: bool = True
    # The training augmentation's photometric distort.  Off for learning runs
    # on the synthetic colour-coded dataset, where its channel permutation
    # and hue rotation give a box another class's colour.
    photometric_distort: bool = True
    # Final epsilon of the auction matcher during training: the matching is
    # within 2 * eps * G of optimal.
    matcher_eps_min: float = 1e-3
    # The device-resize wire (ops.device_resize): ship SOURCE-resolution
    # uint8 pixels in a per-bucket source canvas and resample each image to
    # its augmented size on the card, 2.5-3.3x fewer bytes to copy than the
    # padded augmented canvas, and no resample on the host.  The source
    # canvases derive from shape_buckets (data.bucketing.derive_source_buckets)
    # unless source_buckets is set.
    device_resize: bool = False
    source_buckets: Optional[tuple] = None
    # Recalibrate a random trunk's frozen-BN statistics on the startup
    # sample every N epochs (0: only once, at the start).  Statistics
    # calibrated once go stale as the convolutions train, and the
    # activations grow until the gradient clip throttles learning; they
    # stay constant within an epoch.
    bn_recalibrate_epochs: int = 0
    # Read the previous micro-step's loss every N micro-steps (0: never): a
    # non-finite-loss tripwire that also bounds how far the host runs ahead
    # of the card.
    dispatch_sync_steps: int = 1
    # Exit with code 42 (utils.watchdog) when no micro-step, validation
    # batch or checkpoint completes for this long; 0 disables.  A retry
    # wrapper relaunches, and the checkpoint auto-restore resumes.
    watchdog_secs: float = 1200.0
    # Host RSS limit in GB (utils.host): exit 42 at the epoch boundary past
    # it (after the checkpoint), at once past 1.25x it; 0 disables.
    host_rss_limit_gb: float = 64.0
    # Ranks of a torch.distributed run (parallel.distributed): 0 means all
    # of them; any other value must equal the world size.
    num_devices: int = 0
    # Size of the tensor-parallel group: adjacent ranks split the attention
    # heads and the FFN hidden Megatron-style (parallel.tp); the heads must
    # divide by it.  The data-parallel size is the world size over it.
    model_parallel: int = 1

    @property
    def gradient_accumulation_steps(self) -> int:
        return max(1, self.cumulative_train_batch_size // self.train_batch_size)

    def replace(self, **kw) -> "TrainingConfig":
        return dataclasses.replace(self, **kw)
