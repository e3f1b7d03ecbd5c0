"""The benchmark's plain reference: DETR in fp32 PyTorch, written from the
published description and the port's stated semantics, independent of the
port's code.  It imports nothing of ``detr_tpu_torch`` or ``detr_tpu``.

``weights`` makes the parameters from a seed, ``images`` redoes the input
path (normalising uint8, the val resize, buckets, padding), ``model`` is the
forward (R50 and DC5 trunks, frozen BN, the pre-norm transformer, sine
positions, heads), ``criterion`` the set loss with an exact assignment,
``optim`` the accumulated, clipped AdamW, and ``dropout`` the counter-hash
masks that the configuration's dropout draws.
"""
