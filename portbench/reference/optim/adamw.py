"""Plain reference of the mix's ``adamw`` (a frozen copy, plain PyTorch)."""
from __future__ import annotations

import torch


class Optimizer:
    """Adam with bias correction (weight decay 0, no clip)."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = self.v = None
        self.t = 0

    def step(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if self.m is None:
            self.m, self.v = torch.zeros_like(p), torch.zeros_like(p)
        self.t += 1
        self.m.mul_(self.b1).add_((1 - self.b1) * g)
        self.v.mul_(self.b2).add_((1 - self.b2) * g * g)
        den = torch.div(self.v, 1 - self.b2 ** self.t).sqrt_().add_(self.eps)
        p.sub_(torch.div(self.m, 1 - self.b1 ** self.t).mul_(self.lr).div_(den))
        return g
