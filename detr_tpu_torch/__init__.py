"""detr_tpu_torch — the PyTorch/CUDA port of ``detr_tpu`` for NVIDIA Hopper.

It serves and trains DETR with the same layouts and numbers as the JAX
package, which stays beside it as the reference: plain PyTorch for the dense
work, a hand-written CUDA kernel wherever the JAX package has a Pallas
kernel, and copies of the JAX package's host C++ kernels (``native/``).  It
imports nothing of JAX or of ``detr_tpu``.
"""

from detr_tpu_torch.config import DETRConfig, TrainingConfig

__version__ = "0.1.0"

__all__ = ["DETRConfig", "TrainingConfig", "__version__"]
