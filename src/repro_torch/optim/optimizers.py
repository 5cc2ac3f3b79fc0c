"""Local optimizers (port of ``repro/optim/optimizers.py``).

The reference's optimizers are init/update pairs over param pytrees. Here a
client's parameters are one row of the packed ``(C, N_total)`` round state
and its gradient arrives in the same packed layout (``models.yolov3.forward``
over views of the row), so the optimizer works on flat tensors:

- ``init(packed)`` takes the ``(C, N_total)`` params and returns the state as
  client-stacked tensors: one ``(C, N_total)`` buffer per moment, in the
  params' packed layout, and a ``(C,)`` step count where there is one.
- ``update(p, g, state)`` steps ONE client in place: ``p`` is its row of the
  packed params, ``g`` its packed gradient, ``state`` the matching rows of
  the state buffers. The reference returns new arrays that its donated jit
  aliases onto the old ones; the port writes into the one preallocated
  buffer directly.

The global norm of :func:`clip_by_global_norm` is the norm of the whole
packed gradient, which is the reference's norm over all leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[torch.Tensor], dict[str, torch.Tensor]]
    update: Callable[[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]], None]
    name: str = "opt"


def clip_by_global_norm(grads: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` so its global L2 norm is at most ``max_norm`` (no
    host sync: the scale stays a tensor)."""
    norm = torch.sqrt(torch.sum(torch.square(grads.float())))
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return (grads.float() * scale).to(grads.dtype)


def sgd(lr: float = 1e-2, momentum: float = 0.9, clip_norm: float = 10.0) -> Optimizer:
    """SGD with momentum, the paper's local trainer; ``momentum=0`` keeps no
    state at all (the reference's stateless path)."""
    if momentum == 0.0:
        def init0(packed: torch.Tensor) -> dict:
            return {}

        def update0(p: torch.Tensor, g: torch.Tensor, state: dict) -> None:
            if clip_norm:
                g = clip_by_global_norm(g, clip_norm)
            p.sub_(lr * g.to(p.dtype))

        return Optimizer(init0, update0, "sgd")

    def init(packed: torch.Tensor) -> dict:
        return {"mu": torch.zeros_like(packed)}

    def update(p: torch.Tensor, g: torch.Tensor, state: dict) -> None:
        if clip_norm:
            g = clip_by_global_norm(g, clip_norm)
        mu = state["mu"]
        mu.mul_(momentum).add_(g.to(mu.dtype))
        p.sub_((lr * mu).to(p.dtype))

    return Optimizer(init, update, "sgd")


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: float = 0.0) -> Optimizer:
    """AdamW with bias correction; ``t`` counts each client's own steps."""

    def init(packed: torch.Tensor) -> dict:
        return {
            "m": torch.zeros(packed.shape, dtype=torch.float32, device=packed.device),
            "v": torch.zeros(packed.shape, dtype=torch.float32, device=packed.device),
            "t": torch.zeros(packed.shape[:1], dtype=torch.int32, device=packed.device),
        }

    def update(p: torch.Tensor, g: torch.Tensor, state: dict) -> None:
        if clip_norm:
            g = clip_by_global_norm(g, clip_norm)
        g = g.float()
        t = state["t"]
        t.add_(1)
        m, v = state["m"], state["v"]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        tf = t.float()
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf
        # lr * (m / bc1) / (sqrt(v / bc2) + eps), op for op, in two
        # temporaries: a full-width model's row is 6.9 GB
        den = torch.div(v, bc2).sqrt_().add_(eps)
        step = torch.div(m, bc1).mul_(lr).div_(den)
        del den
        if weight_decay:
            step.add_(lr * weight_decay * p.float())
        if p.dtype == torch.float32:
            p.sub_(step)
        else:
            p.copy_((p.float() - step).to(p.dtype))

    return Optimizer(init, update, "adamw")
