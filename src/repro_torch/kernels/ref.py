"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py::nms_np``, ``pairwise_iou_np``, ``_corners_np`` and
``packed_bucket_reduce``, of the fused transports K4, K6, K7, K8, of the row
and block quantizers K5a/K5b and K12a/K12b, of the LM kernels K9
``flash_attention`` and K10 ``ssd_chunk_scan``, and of the per-leaf FedAvg
K11 ``fedavg_masked_mean``).

The detection versions are straight transcriptions of the reference's
NumPy oracles, op for op in float32: every op is a plain IEEE
add/sub/mul/div/min/max, each rounded on its own, so on the host they equal
the oracles bit for bit. :func:`packed_bucket_reduce`, :func:`quant8_reduce`,
:func:`quant4_reduce`, :func:`grouped_reduce`, :func:`masked_u32_sum` and
:func:`fedavg_masked_mean` are the reference's oracles written as the CUDA kernels' ordered client
chains (``acc = d_0 w_0``, then ``acc = acc + d_c w_c``), so kernel and
plain version agree bit for bit on the card. A wrapper in ``kernels.detect``
or ``kernels.pack`` runs these for a tensor on the CPU; on the card they
serve only as what ``chip_smoke.py`` and the tests hold the CUDA kernels
against.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing

IOU_EPS = 1e-9


def _corners(boxes: torch.Tensor):
    """(..., 4) center-format f32 -> x1, y1, x2, y2, area (all f32)."""
    x1 = boxes[..., 0] - boxes[..., 2] * 0.5
    y1 = boxes[..., 1] - boxes[..., 3] * 0.5
    x2 = boxes[..., 0] + boxes[..., 2] * 0.5
    y2 = boxes[..., 1] + boxes[..., 3] * 0.5
    return x1, y1, x2, y2, torch.clamp_min((x2 - x1) * (y2 - y1), 0.0)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A threshold as an f32 scalar tensor: comparisons round it to f32
    first, as the reference's ``np.float32(thresh)`` does."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def nms_keep(boxes_s: torch.Tensor, valid_s: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """The sequential scan of ``kernels/detect.py::_nms_kernel``.

    boxes_s (B, N, 4) f32 sorted by descending score, valid_s (B, N) 0/1
    f32 -> keep_s (B, N) f32: box i, while still kept, clears every later
    box whose IoU with it exceeds ``iou_thresh``.
    """
    B, N = valid_s.shape
    x1, y1, x2, y2, area = _corners(boxes_s)
    keep = valid_s.clone()
    thresh = _f32(iou_thresh, boxes_s)
    pos = torch.arange(N, device=boxes_s.device)
    for i in range(N):
        ix = torch.clamp_min(torch.minimum(x2[:, i, None], x2) - torch.maximum(x1[:, i, None], x1), 0.0)
        iy = torch.clamp_min(torch.minimum(y2[:, i, None], y2) - torch.maximum(y1[:, i, None], y1), 0.0)
        inter = torch.clamp_min(ix * iy, 0.0)
        iou = inter / torch.clamp_min(area[:, i, None] + area - inter, IOU_EPS)
        suppress = (pos > i) & (iou > thresh) & (keep[:, i, None] > 0)
        keep = keep.masked_fill(suppress, 0.0)
    return keep


def sort_by_score(boxes: torch.Tensor, scores: torch.Tensor, score_thresh: float):
    """Stable descending-score sort (ties keep the original order) ->
    (order, boxes_s (B, N, 4) f32 contiguous, valid_s (B, N) f32), as the
    reference's ``nms`` wrapper prepares its kernel's operands."""
    scores = scores.float()
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_s = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4)).contiguous()
    valid_s = (torch.gather(scores, 1, order) > _f32(score_thresh, scores)).float()
    return order, boxes_s, valid_s


def finish(order: torch.Tensor, keep_s: torch.Tensor, max_keep: int) -> torch.Tensor:
    """Cap survivors to the top ``max_keep`` by rank (0 = no cap) and
    scatter the sorted keep mask back to the caller's box order."""
    if max_keep:
        rank = torch.cumsum(keep_s, dim=-1)  # survivor rank in score order
        keep_s = keep_s * (rank <= max_keep).float()
    return torch.empty_like(keep_s).scatter_(1, order, keep_s)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float = 0.5,
        score_thresh: float = 0.0, max_keep: int = 0) -> torch.Tensor:
    """The whole NMS in plain torch (``ref.nms_np``): boxes (B?, N, 4),
    scores (B?, N) -> keep mask (B?, N) f32 in the original order."""
    squeeze = boxes.dim() == 2
    if squeeze:
        boxes, scores = boxes[None], scores[None]
    order, boxes_s, valid_s = sort_by_score(boxes, scores, score_thresh)
    keep = finish(order, nms_keep(boxes_s, valid_s, iou_thresh), max_keep)
    return keep[0] if squeeze else keep


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor, giou: bool = False) -> torch.Tensor:
    """``ref.pairwise_iou_np``: boxes_a (B?, N, 4), boxes_b (B?, M, 4)
    center-format f32 -> (B?, N, M) f32 IoU, or GIoU. Zero-area boxes score
    0 against everything (the 1e-9 union floor)."""
    ax1, ay1, ax2, ay2, aa = _corners(boxes_a.float())
    bx1, by1, bx2, by2, ba = _corners(boxes_b.float())
    a_, b_ = (lambda t: t[..., :, None]), (lambda t: t[..., None, :])
    ix = torch.clamp_min(torch.minimum(a_(ax2), b_(bx2)) - torch.maximum(a_(ax1), b_(bx1)), 0.0)
    iy = torch.clamp_min(torch.minimum(a_(ay2), b_(by2)) - torch.maximum(a_(ay1), b_(by1)), 0.0)
    inter = torch.clamp_min(ix * iy, 0.0)
    union = a_(aa) + b_(ba) - inter
    iou = inter / torch.clamp_min(union, IOU_EPS)
    if not giou:
        return iou
    cx = torch.maximum(a_(ax2), b_(bx2)) - torch.minimum(a_(ax1), b_(bx1))
    cy = torch.maximum(a_(ay2), b_(by2)) - torch.minimum(a_(ay1), b_(by1))
    carea = torch.clamp_min(cx * cy, 0.0)
    return iou - (carea - union) / torch.clamp_min(carea, IOU_EPS)


def packed_bucket_reduce(packed: torch.Tensor, wmask: torch.Tensor, bucket_ids: torch.Tensor,
                         mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``packed_bucket_reduce``: packed (C, N), wmask (C, B),
    bucket_ids (N,) int, mask (C,) 0/1 or None -> (num (N,), den (N,)) f32
    with ``num[n] = sum_c mask[c] wmask[c, ids[n]] packed[c, n]`` and
    ``den[n] = sum_c mask[c] wmask[c, ids[n]]``, the clients summed in order
    c = 0..C-1 from zero, one rounding per product and per sum."""
    C, N = packed.shape
    wm = wmask.float()
    if mask is not None:
        wm = wm * mask.float()[:, None]
    ids = bucket_ids.long()
    num = torch.zeros(N, dtype=torch.float32, device=packed.device)
    den = torch.zeros(N, dtype=torch.float32, device=packed.device)
    for c in range(C):
        w = wm[c][ids]
        num = num + packed[c].float() * w
        den = den + w
    return num, den


def quant8_reduce(delta: torch.Tensor, weights: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """K4's plain version: delta (C, N) f32, weights (C,) f32 -> (N,) f32
    ``sum_c w_c (q_c * scale_c)``, ``scale = max(amax, 1e-12)/127`` per
    ``block`` elements, ``q = clip(round(x/scale), -127, 127)``, the clients
    one ordered chain whatever C (``packing.quant_mean``)."""
    return packing.quant_mean(delta, weights, block, 127.0, chain_max=delta.shape[0])


def quantize_rows(x: torch.Tensor, block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """K5a's plain version: x (C, N) f32 -> (q int8 (C, N), scales f32 (C,
    ceil(N/block))), ``scale = max(amax, 1e-12)/127`` per block (a true
    division, ``packing.exact_div``), ``q = clip(round(x/scale), -127,
    127)`` (``packing.quantize_rows_ref``)."""
    return packing.quantize_rows_ref(x, block)


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor, block: int = 1024,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K5b's plain version: (C, N) int8 + (C, ceil(N/block)) scales -> (C,
    N) ``q * scale`` with one cast to ``dtype``
    (``packing.dequantize_rows_ref``)."""
    return packing.dequantize_rows_ref(q, scales, block, dtype)


def quantize(x: torch.Tensor, block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """K12a's plain version: :func:`quantize_rows` of the one row ``x``
    (N,) -> (q (N,), scales (ceil(N/block),))."""
    q, scales = quantize_rows(x.reshape(1, -1), block)
    return q[0], scales[0]


def dequantize(q: torch.Tensor, scales: torch.Tensor, block: int = 1024,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K12b's plain version: :func:`dequantize_rows` of the one row ``q``."""
    return dequantize_rows(q.reshape(1, -1), scales.reshape(1, -1), block, dtype)[0]


def quant4_reduce(delta: torch.Tensor, weights: torch.Tensor, key: int = 0,
                  mode: str = "nearest", block: int = 1024) -> torch.Tensor:
    """K7's plain version: K4 with ``scale = max(amax, 1e-12)/7``, clip to
    +-7, and ``mode`` "nearest" (``round``) or "stochastic"
    (``floor(x/scale + u)``, u from ``packing.counter_uniform(key, c, n)``)."""
    if mode not in ("nearest", "stochastic"):
        raise ValueError(f"quant4 mode={mode!r}; expected nearest | stochastic")
    return packing.quant_mean(delta, weights, block, 7.0, key if mode == "stochastic" else None,
                              chain_max=delta.shape[0])


def grouped_reduce(packed: torch.Tensor, wn: torch.Tensor) -> torch.Tensor:
    """K6's plain version: packed (C, N) f32, wn (C/G, G) f32 -> (C/G, N) f32
    ``out[g] = sum_i wn[g, i] x[gG + i]``, members summed in order."""
    ngroups, G = wn.shape
    xg = packed.float().reshape(ngroups, G, -1)
    acc = xg[:, 0] * wn[:, 0][:, None]
    for i in range(1, G):
        acc = acc + xg[:, i] * wn[:, i][:, None]
    return acc


def masked_u32_sum(rows: torch.Tensor, participation: torch.Tensor) -> torch.Tensor:
    """K8's plain version: rows (C, N) int32 holding uint32 bits,
    participation (C,) f32 -> (N,) int32 bits of the sum mod 2^32 of the
    rows with ``participation > 0``, clients in order."""
    on = participation.float() > 0
    acc = torch.zeros(rows.shape[1], dtype=torch.int64, device=rows.device)
    for c in range(rows.shape[0]):
        acc = (acc + torch.where(on[c], rows[c].to(torch.int64) & packing.U32, 0)) & packing.U32
    return packing.to_int32_bits(acc)


NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """K9's plain version (``repro/kernels/ref.py::flash_attention``): q (B,
    H, S, hd), k/v (B, Hkv, S, hd) -> (B, H, S, hd) in ``q.dtype``, float32
    inside. Query head h reads kv head h // (H / Hkv); ``window > 0`` keeps
    keys with ``qpos - kpos < window``. Scores are divided by sqrt(hd)."""
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, S, hd).float()
    scores = torch.einsum("bkgsh,bkth->bkgst", qg, k.float())
    # torch.full, not torch.tensor: no blocking host-to-device copy per call
    scores = scores / torch.full((), float(hd), device=q.device).sqrt()
    pos = torch.arange(S, device=q.device)
    rel = pos[:, None] - pos[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rel >= 0
    if window:
        mask &= rel < window
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bkgst,bkth->bkgsh", probs, v.float())
    return out.reshape(B, H, S, hd).to(q.dtype)


def ssd_chunk_scan(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10's plain version (the body of ``repro/kernels/ssd_scan.py::_kernel``
    for every (batch, chunk, head) at once). xdt (B, S, H, P), dA (B, S, H),
    Bm/Cm (B, S, N), S % chunk == 0 -> float32 (y_diag (B, S, H, P), states
    (B, nc, H, P, N), chunk_decay (B, nc, H), exp_cum (B, S, H)):
    cum = cumsum(dA) within the chunk, L = tril(exp(cum_q - cum_t)),
    y_diag = (C Bt * L) xdt, states = (B * exp(cum_last - cum))t xdt as (P, N),
    chunk_decay = exp(cum_last), exp_cum = exp(cum)."""
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    nc = S // chunk
    x = xdt.float().reshape(B, nc, chunk, H, P)
    Bc = Bm.float().reshape(B, nc, chunk, N)
    Cc = Cm.float().reshape(B, nc, chunk, N)
    cum = torch.cumsum(dA.float().reshape(B, nc, chunk, H), dim=2)  # (B, nc, Q, H)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=xdt.device).tril()[None, None, :, :, None]
    L = torch.where(tri, torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :]), 0.0)
    scores = torch.einsum("bcqn,bctn->bcqt", Cc, Bc)
    y = torch.einsum("bcqth,bcthp->bcqhp", scores[..., None] * L, x)
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, Q, H)
    states = torch.einsum("bcthn,bcthp->bchpn", Bc[:, :, :, None, :] * decay_states[..., None], x)
    return (y.reshape(B, S, H, P), states, torch.exp(cum[:, :, -1, :]),
            torch.exp(cum).reshape(B, S, H))


def fedavg_masked_mean(stacked: torch.Tensor, wm: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """K11's plain version (``repro/kernels/ref.py::fedavg_masked_mean``):
    stacked (C, N), wm (C,) f32 weighted mask, den 0-d f32 -> (N,) in
    stacked's dtype, ``acc = 0 + x[0] wm[0]``, then ``acc = acc + x[c] wm[c]``
    in order, in float32, then one true division by the 0-d ``den`` and one
    cast."""
    acc = torch.zeros(stacked.shape[1], dtype=torch.float32, device=stacked.device)
    for c in range(stacked.shape[0]):
        acc = acc + stacked[c].float() * wm[c]
    return (acc / den).to(stacked.dtype)
