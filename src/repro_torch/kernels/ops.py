"""Kernel dispatch (port of ``repro/kernels/ops.py``): NMS, pairwise IoU and
the fused transports (quant8 K4, grouped K6, quant4 K7, masked sum K8).

``impl="kernel"`` (the default) runs the kernel wrapper, which launches the
CUDA kernel for a tensor on the card and its plain version for one on the
CPU. ``impl="ref"`` forces the plain PyTorch version on any device; only
``chip_smoke.py`` and the tests pass it, to hold the kernel against it. The
aggregators select K1, K4, K6, K7 and K8 through ``FedConfig.agg_impl``
instead (``core.packing``, ``core.aggregators``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import detect, mask, pack, quant4, ref

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


def quant8_reduce(delta: torch.Tensor, weights: torch.Tensor, *, block: int = 1024,
                  impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return pack.quant8_reduce(delta, weights, block=block)
    if impl == "ref":
        return ref.quant8_reduce(delta, weights, block)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def quant4_reduce(delta: torch.Tensor, weights: torch.Tensor, key: int = 0, *,
                  mode: str = "nearest", block: int = 1024, impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return quant4.quant4_reduce(delta, weights, key, mode=mode, block=block)
    if impl == "ref":
        return ref.quant4_reduce(delta, weights, key, mode, block)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def grouped_reduce(packed: torch.Tensor, wn: torch.Tensor, *, impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return pack.grouped_reduce(packed, wn)
    if impl == "ref":
        return ref.grouped_reduce(packed, wn)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def masked_u32_sum(rows: torch.Tensor, participation: torch.Tensor, *,
                   impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return mask.masked_u32_sum(rows, participation)
    if impl == "ref":
        return ref.masked_u32_sum(rows, participation)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
