"""Runnable examples of the port (counterparts of the root ``examples/``):
``convergence_synthetic`` (the end-to-end learning run), and the dev
harnesses ``dev_data``, ``dev_model`` and ``visualize_results``.  Each runs
as ``python -m detr_tpu_torch.examples.<name>``, on the card unless given
``--cpu``."""
