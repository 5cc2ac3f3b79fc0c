"""Detection decode and federated evaluation (port of
``repro/core/detection.py``).

raw heads -> ``yolov3.decode_boxes`` -> top-K by conf * max class prob ->
one batched NMS launch (``kernels.ops.nms``, K3) -> :func:`match_detections`
(one pairwise-IoU launch, K2, then the greedy score-ordered matching) ->
:func:`average_precision` (VOC all-point AP@0.5) -> :func:`build_evaluator`
(per-client and pooled global mAP from one call over the (C, ...) client
axis). Shapes are fixed: every image gets ``max_detections`` slots with a
0/1 validity mask and the ground truth is padded with one. The greedy
matching loops over the K score-ranked slots on tensors, every image at
once; the AP loops over classes. Neither is a Pallas kernel in the
reference, so both are plain torch.
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


def match_detections(
    pred: dict[str, torch.Tensor],
    gt_boxes: torch.Tensor,
    gt_cls: torch.Tensor,
    gt_valid: torch.Tensor,
    *,
    iou_thresh: float = 0.5,
    impl: str = "kernel",
) -> torch.Tensor:
    """Greedy score-ordered matching -> per-detection TP flags (B, K) f32.

    pred: ``decode_predictions`` output (scores descending per image);
    gt_boxes (B, G, 4), gt_cls (B, G) int, gt_valid (B, G) 0/1. One
    pairwise-IoU launch covers the batch; then slot k (in score order) is a
    true positive iff its best same-class, still-unmatched, valid GT reaches
    ``iou_thresh``, and each GT matches at most one detection. ``impl``
    selects the IoU (``kernels.ops``).
    """
    iou = ops.pairwise_iou(pred["boxes"].float().contiguous(), gt_boxes.float().contiguous(),
                           impl=impl)  # (B, K, G)
    B, K, G = iou.shape
    rows = torch.arange(B, device=iou.device)
    gcls, gvalid = gt_cls.long(), gt_valid > 0
    pcls, pvalid = pred["cls"].long(), pred["valid"] > 0
    matched = torch.zeros((B, G), dtype=torch.bool, device=iou.device)
    tp = torch.zeros((B, K), dtype=torch.float32, device=iou.device)
    for k in range(K):
        iou_k = iou[:, k]
        cand = (iou_k >= iou_thresh) & (gcls == pcls[:, k, None]) & gvalid & ~matched
        j = torch.argmax(torch.where(cand, iou_k, -1.0), dim=1)  # first of the best
        hit = cand[rows, j] & pvalid[:, k]
        matched[rows, j] |= hit
        tp[:, k] = hit.float()
    return tp


def average_precision(
    scores: torch.Tensor,
    tp: torch.Tensor,
    valid: torch.Tensor,
    cls: torch.Tensor,
    n_gt_per_class: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """VOC all-point AP over one detection pool.

    scores/tp/valid/cls: flat (D,) over every detection slot of the pool;
    n_gt_per_class: (n_classes,) GT counts. Returns (ap (n_classes,), mAP)
    where mAP averages over the classes with at least one GT.
    """
    n_classes = n_gt_per_class.shape[0]
    aps = []
    for c in range(n_classes):
        m = (valid > 0) & (cls == c)
        order = torch.argsort(-torch.where(m, scores, -torch.inf), stable=True)
        mf = m.float()
        tp_s = (tp * mf)[order]
        fp_s = ((1.0 - tp) * mf)[order]
        ctp, cfp = torch.cumsum(tp_s, 0), torch.cumsum(fp_s, 0)
        recall = ctp / torch.clamp_min(n_gt_per_class[c].float(), 1.0)
        precision = ctp / torch.clamp_min(ctp + cfp, 1e-9)
        env = torch.flip(torch.cummax(torch.flip(precision, [0]), 0).values, [0])
        dr = torch.diff(recall, prepend=recall.new_zeros(1))
        aps.append(torch.sum(env * dr))
    ap = torch.stack(aps)
    present = (n_gt_per_class > 0).float()
    map50 = torch.sum(ap * present) / torch.clamp_min(torch.sum(present), 1.0)
    return ap, map50


def _gt_hist(gt_cls: torch.Tensor, gt_valid: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(..., G) labels and validity -> (..., G, n_classes) one-hot counts."""
    return torch.nn.functional.one_hot(gt_cls.long(), n_classes).float() * gt_valid.float()[..., None]


def evaluate_detections(
    pred: dict[str, torch.Tensor],
    gt_boxes: torch.Tensor,
    gt_cls: torch.Tensor,
    gt_valid: torch.Tensor,
    n_classes: int,
    *,
    iou_thresh: float = 0.5,
) -> dict[str, torch.Tensor]:
    """One population's detection quality: {"ap" (n_classes,), "map" ()}."""
    tp = match_detections(pred, gt_boxes, gt_cls, gt_valid, iou_thresh=iou_thresh)
    n_gt = _gt_hist(gt_cls, gt_valid, n_classes).sum(dim=(0, 1))
    ap, map50 = average_precision(
        pred["scores"].reshape(-1), tp.reshape(-1), pred["valid"].reshape(-1),
        pred["cls"].reshape(-1), n_gt,
    )
    return {"ap": ap, "map": map50}


def build_evaluator(
    cfg,
    *,
    max_detections: int = 64,
    score_thresh: float = SCORE_THRESH,
    nms_iou: float = 0.5,
    match_iou: float = 0.5,
):
    """Federated evaluator: ``evaluate(model, eval_batch) -> mAP dict``.

    eval_batch: {"images" (C, B, H, W, 3), "gt_boxes" (C, B, G, 4),
    "gt_cls" (C, B, G), "gt_valid" (C, B, G)}, tensors on the model's
    device. Returns {"map": pooled global mAP@0.5, "per_client_map" (C,),
    "per_client_ap" (C, n_classes)}: decode, NMS and IoU run once over the
    flattened (C*B) image axis (one launch of each kernel), only the AP
    pooling differs.
    """
    n_classes = cfg.vocab_size

    def evaluate(model, batch: dict) -> dict[str, torch.Tensor]:
        images = batch["images"]
        C, B = images.shape[:2]
        flat = lambda x: x.reshape((C * B,) + tuple(x.shape[2:]))
        with torch.inference_mode():
            pred = decode_predictions(
                cfg, model, flat(images), max_detections=max_detections,
                score_thresh=score_thresh, nms_iou=nms_iou,
            )
            gt_cls, gt_valid = flat(batch["gt_cls"]).long(), flat(batch["gt_valid"]).float()
            tp = match_detections(pred, flat(batch["gt_boxes"]).float(), gt_cls, gt_valid,
                                  iou_thresh=match_iou)
            hist = _gt_hist(gt_cls, gt_valid, n_classes)  # (C*B, G, n_classes)
            per = lambda x: x.reshape(C, -1)
            n_gt_c = hist.reshape(C, -1, n_classes).sum(dim=1)
            client = [
                average_precision(per(pred["scores"])[c], per(tp)[c], per(pred["valid"])[c],
                                  per(pred["cls"])[c], n_gt_c[c])
                for c in range(C)
            ]
            _, map_g = average_precision(
                pred["scores"].reshape(-1), tp.reshape(-1), pred["valid"].reshape(-1),
                pred["cls"].reshape(-1), hist.sum(dim=(0, 1)),
            )
        return {
            "map": map_g,
            "per_client_map": torch.stack([m for _, m in client]),
            "per_client_ap": torch.stack([ap for ap, _ in client]),
        }

    return evaluate
