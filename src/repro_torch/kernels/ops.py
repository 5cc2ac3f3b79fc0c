"""Kernel dispatch (port of ``repro/kernels/ops.py``).

``impl="kernel"`` (the default) runs the kernel wrapper, which launches the
CUDA kernel for a tensor on the card and its plain version for one on the
CPU. ``impl="ref"`` forces the plain PyTorch version on any device; only
``chip_smoke.py`` and the tests pass it, to hold the kernel against it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import detect, ref

IMPLS = ("kernel", "ref")


def nms(boxes: torch.Tensor, scores: torch.Tensor, *, iou_thresh: float = 0.5,
        score_thresh: float = 0.0, max_keep: int = 0, impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return detect.nms(boxes, scores, iou_thresh=iou_thresh,
                          score_thresh=score_thresh, max_keep=max_keep)
    if impl == "ref":
        return ref.nms(boxes, scores, iou_thresh, score_thresh, max_keep)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
