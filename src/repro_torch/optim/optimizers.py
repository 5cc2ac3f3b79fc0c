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

Under a mesh's ``"model"`` axis a rank holds a column block of each row
(``core.packing.packed_cols``) and steps it alone: ``update(p, g, state,
reduce)`` takes the block of the row, of its gradient and of its moments.
Both optimizers are elementwise except for the clip, whose squared sum is
the block's, summed over the model axis by ``reduce`` (an in-place sum of
a 0-d tensor over the ranks holding the other blocks), so every rank
scales by the norm of the whole row.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[torch.Tensor], dict[str, torch.Tensor]]
    update: Callable[..., None]  # (p, g, state[, reduce]) -> None, in place
    name: str = "opt"


def clip_by_global_norm(grads: torch.Tensor, max_norm: float, reduce=None) -> torch.Tensor:
    """Scale ``grads`` so its global L2 norm is at most ``max_norm`` (no
    host sync: the scale stays a tensor). ``reduce``: ``grads`` is a block
    of the row, and ``reduce`` sums the block's squared sum in place over
    the ranks holding the others."""
    sq = torch.sum(torch.square(grads.float()))
    norm = torch.sqrt(sq if reduce is None else reduce(sq))
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return (grads.float() * scale).to(grads.dtype)


def sgd(lr: float = 1e-2, momentum: float = 0.9, clip_norm: float = 10.0) -> Optimizer:
    """SGD with momentum, the paper's local trainer; ``momentum=0`` keeps no
    state at all (the reference's stateless path)."""
    if momentum == 0.0:
        def init0(packed: torch.Tensor) -> dict:
            return {}

        def update0(p: torch.Tensor, g: torch.Tensor, state: dict, reduce=None) -> None:
            if clip_norm:
                g = clip_by_global_norm(g, clip_norm, reduce)
            p.sub_(lr * g.to(p.dtype))

        return Optimizer(init0, update0, "sgd")

    def init(packed: torch.Tensor) -> dict:
        return {"mu": torch.zeros_like(packed)}

    def update(p: torch.Tensor, g: torch.Tensor, state: dict, reduce=None) -> None:
        if clip_norm:
            g = clip_by_global_norm(g, clip_norm, reduce)
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

    def update(p: torch.Tensor, g: torch.Tensor, state: dict, reduce=None) -> None:
        if clip_norm:
            g = clip_by_global_norm(g, clip_norm, reduce)
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
