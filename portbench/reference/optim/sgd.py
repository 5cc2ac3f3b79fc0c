"""Plain reference of the mix's ``sgd`` (a frozen copy, plain PyTorch)."""
from __future__ import annotations

import torch


class Optimizer:
    """Momentum SGD with a clip of the gradient's global norm."""

    def __init__(self, lr: float, momentum: float = 0.9, clip_norm: float = 10.0):
        self.lr, self.momentum, self.clip_norm = lr, momentum, clip_norm
        self.mu = None

    def step(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """Update ``p`` in place; -> the update direction the moment holds
        after the first step (the clipped gradient)."""
        if self.clip_norm:
            g = g * torch.clamp_max(self.clip_norm / torch.clamp_min(torch.linalg.vector_norm(g),
                                                                     1e-12), 1.0)
        self.mu = g.clone() if self.mu is None else self.mu.mul_(self.momentum).add_(g)
        p.sub_(self.lr * self.mu)
        return g
