"""Detection decode (port of ``repro/core/detection.py::decode_predictions``).

raw heads -> ``yolov3.decode_boxes`` -> top-K by conf * max class prob ->
one batched NMS launch (``kernels.ops.nms``). Shapes are fixed: every image
gets ``max_detections`` slots with a 0/1 validity mask.

``match_detections``, ``average_precision`` and ``build_evaluator`` (eval,
on the pairwise-IoU kernel) belong to a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import yolov3

# NMS pre-suppression score floor: conf * class-prob below this is noise
SCORE_THRESH = 0.05


def candidates(model, images: torch.Tensor, max_detections: int):
    """images (B, H, W, 3) -> the top-K candidates and the class-shifted boxes
    that NMS sees: (boxes (B, K, 4), scores (B, K), cls (B, K) int32,
    shifted (B, K, 4))."""
    boxes, scores, labels = [], [], []
    for raw, anchors in zip(model(images), yolov3.ANCHORS):
        b, conf, cls = yolov3.decode_boxes(raw.float(), anchors)
        B = b.shape[0]
        boxes.append(b.reshape(B, -1, 4))
        scores.append((conf * cls.max(dim=-1).values).reshape(B, -1))
        labels.append(cls.argmax(dim=-1).reshape(B, -1).to(torch.int32))
    boxes = torch.cat(boxes, dim=1)
    scores = torch.cat(scores, dim=1)
    labels = torch.cat(labels, dim=1)
    k = min(max_detections, scores.shape[1])
    # lax.top_k breaks ties by lower index; torch.topk promises no order, a
    # stable sort does
    sorted_scores, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, top_idx = sorted_scores[:, :k], idx[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_labels = torch.gather(labels, 1, top_idx)
    if k < max_detections:  # pad up to the fixed K slots
        pad = max_detections - k
        top_boxes = torch.nn.functional.pad(top_boxes, (0, 0, 0, pad))
        top_scores = torch.nn.functional.pad(top_scores, (0, pad), value=-1.0)
        top_labels = torch.nn.functional.pad(top_labels, (0, pad))
    # |x1-x2| + (w1+w2)/2 <= 3 * max|coord|, so this stride strictly
    # separates classes. Per IMAGE, not per batch: the padded-batch pin needs
    # every slot's decode to be a function of that slot alone.
    stride = 1.0 + 3.0 * top_boxes.abs().amax(dim=(1, 2))
    shifted = top_boxes.clone()
    shifted[..., 0] += top_labels.float() * stride[:, None]
    return top_boxes, top_scores, top_labels, shifted


def decode_predictions(
    cfg,
    model,
    images: torch.Tensor,
    *,
    max_detections: int = 64,
    score_thresh: float = SCORE_THRESH,
    nms_iou: float = 0.5,
    impl: str = "kernel",
) -> dict[str, torch.Tensor]:
    """images (B, H, W, 3) -> fixed-size detections per image.

    Returns {"boxes" (B, K, 4) center-format, "scores" (B, K) descending,
    "cls" (B, K) int32, "valid" (B, K) 0/1 f32} with K = max_detections.
    NMS is class-aware through the per-image class-offset shift. ``cfg`` is
    the model's config (kept for the reference's signature); ``impl``
    selects the NMS (``kernels.ops``).
    """
    if model.cfg != cfg:
        raise ValueError(f"model built for {model.cfg.name}, decode asked for {cfg.name}")
    boxes, scores, labels, shifted = candidates(model, images, max_detections)
    keep = ops.nms(shifted, scores, iou_thresh=nms_iou, score_thresh=score_thresh, impl=impl)
    return {"boxes": boxes, "scores": scores, "cls": labels, "valid": keep}
