"""Kernel dispatch (port of ``repro/kernels/ops.py``): NMS and pairwise IoU.

``impl="kernel"`` (the default) runs the kernel wrapper, which launches the
CUDA kernel for a tensor on the card and its plain version for one on the
CPU. ``impl="ref"`` forces the plain PyTorch version on any device; only
``chip_smoke.py`` and the tests pass it, to hold the kernel against it. The
bucket reduce K1 is selected by ``FedConfig.agg_impl`` instead
(``core.packing.masked_bucket_mean``).
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


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor, *, giou: bool = False,
                 impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return detect.pairwise_iou(boxes_a, boxes_b, giou=giou)
    if impl == "ref":
        return ref.pairwise_iou(boxes_a, boxes_b, giou)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
