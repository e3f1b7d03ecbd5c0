"""AdamW behind gradient accumulation and global-norm clipping, plain.

An update every ``every`` micro-steps from the mean of their gradients,
clipped to ``max_norm`` of its global norm (scaled by max_norm / norm when
the norm reaches max_norm); AdamW with betas (0.9, 0.999), eps 1e-8 and
decoupled weight decay; the trunk's parameters (``backbone.*``) at
``lr_backbone``, the rest at ``lr``.
"""

from __future__ import annotations

import math

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


class AdamW:
    def __init__(self, params: dict, lr: float, lr_backbone: float, weight_decay: float,
                 max_norm: float, every: int):
        self.params = params  # name -> fp32 tensor, updated in place
        self.lr = {n: (lr_backbone if n.startswith("backbone.") else lr) for n in params}
        self.wd, self.max_norm, self.every = weight_decay, max_norm, every
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.acc = {n: torch.zeros_like(p) for n, p in params.items()}
        self.micro, self.t = 0, 0

    def micro_step(self, grads: dict) -> dict | None:
        """Add one micro-step's gradients; on an update, returns the clipped
        mean gradient it applied."""
        for n, g in grads.items():
            self.acc[n] += g
        self.micro += 1
        if self.micro < self.every:
            return None
        mean = {n: a / self.every for n, a in self.acc.items()}
        norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in mean.values()))
        coef = 1.0 if norm < self.max_norm else self.max_norm / norm
        mean = {n: g * coef for n, g in mean.items()}
        self.t += 1
        b1, b2 = BETAS
        bc1, bc2 = 1 - b1**self.t, 1 - b2**self.t
        with torch.no_grad():
            for n, p in self.params.items():
                g = mean[n]
                lr = self.lr[n]
                p.mul_(1 - lr * self.wd)
                self.m[n].mul_(b1).add_(g, alpha=1 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[n].sqrt() / math.sqrt(bc2)).add_(EPS)
                p.addcdiv_(self.m[n], denom, value=-lr / bc1)
        for a in self.acc.values():
            a.zero_()
        self.micro = 0
        return mean
