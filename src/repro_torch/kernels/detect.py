"""Detection kernels (port of ``repro/kernels/detect.py``): pairwise IoU
and NMS.

:func:`pairwise_iou` is the eval matcher's IoU/GIoU matrix: the
hand-written CUDA kernel ``csrc/iou.cu`` for tensors on the card, its plain
version ``kernels.ref.pairwise_iou`` for tensors on the CPU, one launch for
the whole (batched) call.

:func:`nms` is the reference's ``nms`` wrapper: a stable descending-score
sort, one launch of the keep-mask kernel over every image of the batch, the
``max_keep`` cap and the scatter back to the caller's order. The keep mask,
:func:`nms_keep`, is the hand-written CUDA kernel ``csrc/nms.cu`` for a
tensor on the card (an all-pairs IoU bitmask resolved by one warp up to
1024 boxes an image, the sequential scan above), and its plain version
``kernels.ref.nms_keep`` for a tensor on the CPU. A CUDA tensor never takes
the plain version: the kernel launches or the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


# the CUDA grid's y and z extents: ceil(N / 8) a-box tiles and the batch
GRID_LIMIT = 65535


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor, *, giou: bool = False) -> torch.Tensor:
    """boxes_a (B?, N, 4), boxes_b (B?, M, 4) center-format f32 -> (B?, N, M)
    f32 IoU (or GIoU). Counts its CUDA launches in ``pairwise_iou.launches``."""
    if boxes_a.device.type == "cpu":
        return ref.pairwise_iou(boxes_a, boxes_b, giou)
    if boxes_a.device.type != "cuda":
        raise ValueError(f"pairwise_iou runs on cuda or cpu tensors, not {boxes_a.device}")
    squeeze = boxes_a.dim() == 2
    if squeeze:
        boxes_a, boxes_b = boxes_a[None], boxes_b[None]
    if (boxes_a.dim() != 3 or boxes_b.dim() != 3 or boxes_a.shape[2] != 4
            or boxes_b.shape[2] != 4 or boxes_a.shape[0] != boxes_b.shape[0]):
        raise ValueError(f"expected boxes (B?, N, 4) and (B?, M, 4), got "
                         f"{tuple(boxes_a.shape)} and {tuple(boxes_b.shape)}")
    if boxes_a.dtype != torch.float32 or boxes_b.dtype != torch.float32:
        raise TypeError("pairwise_iou takes float32 boxes")
    if boxes_b.device != boxes_a.device:
        raise ValueError("both box sets must be on one device")
    B, N, _ = boxes_a.shape
    M = boxes_b.shape[1]
    if B > GRID_LIMIT or -(-N // 8) > GRID_LIMIT:
        raise ValueError(f"B={B}, N={N} exceed the kernel's grid")
    boxes_a, boxes_b = boxes_a.contiguous(), boxes_b.contiguous()
    out = torch.empty((B, N, M), dtype=torch.float32, device=boxes_a.device)
    _build.launch("pairwise_iou_launch", boxes_a.device, boxes_a.data_ptr(), boxes_b.data_ptr(),
                  out.data_ptr(), B, N, M, int(giou))
    pairwise_iou.launches += 1
    return out[0] if squeeze else out


pairwise_iou.launches = 0


def nms_keep(boxes_s: torch.Tensor, valid_s: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """boxes_s (B, N, 4) f32 score-sorted, valid_s (B, N) 0/1 f32 ->
    keep_s (B, N) f32. Counts its CUDA launches in ``nms_keep.launches``."""
    if boxes_s.device.type == "cpu":
        return ref.nms_keep(boxes_s, valid_s, iou_thresh)
    if boxes_s.device.type != "cuda":
        raise ValueError(f"nms_keep runs on cuda or cpu tensors, not {boxes_s.device}")
    if boxes_s.dim() != 3 or boxes_s.shape[2] != 4 or valid_s.shape != boxes_s.shape[:2]:
        raise ValueError(f"expected boxes (B, N, 4) and valid (B, N), got "
                         f"{tuple(boxes_s.shape)} and {tuple(valid_s.shape)}")
    if boxes_s.dtype != torch.float32 or valid_s.dtype != torch.float32:
        raise TypeError("nms_keep takes float32 boxes and valid mask")
    if valid_s.device != boxes_s.device:
        raise ValueError("boxes and valid mask must be on one device")
    if boxes_s.shape[1] * 24 > 227 * 1024:
        raise ValueError(f"N={boxes_s.shape[1]} boxes do not fit one block's shared memory")
    boxes_s, valid_s = boxes_s.contiguous(), valid_s.contiguous()
    keep = torch.empty_like(valid_s)
    B, N = valid_s.shape
    _build.launch("nms_keep_launch", boxes_s.device, boxes_s.data_ptr(), valid_s.data_ptr(),
                  keep.data_ptr(), B, N, float(iou_thresh))
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0


def nms(boxes: torch.Tensor, scores: torch.Tensor, *, iou_thresh: float = 0.5,
        score_thresh: float = 0.0, max_keep: int = 0) -> torch.Tensor:
    """boxes (B?, N, 4), scores (B?, N) -> keep mask (B?, N) f32, original order.

    Score-sorted sequential NMS with fixed shapes (``detect.nms``): ties in
    score keep the original order, ``score_thresh`` pre-drops boxes at or
    below it, and ``max_keep > 0`` masks survivors beyond the top max_keep.
    """
    squeeze = boxes.dim() == 2
    if squeeze:
        boxes, scores = boxes[None], scores[None]
    order, boxes_s, valid_s = ref.sort_by_score(boxes, scores, score_thresh)
    keep = ref.finish(order, nms_keep(boxes_s, valid_s, iou_thresh), max_keep)
    return keep[0] if squeeze else keep
