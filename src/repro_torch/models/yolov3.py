"""FedYOLOv3 — the paper's object detector (port of ``repro/models/yolov3.py``).

Darknet-style residual backbone with 3-scale detection heads, as
:class:`FedYOLOv3`. The convolutions run through ``torch.nn.functional.conv2d``
(cuDNN on the card): the reference computes them with
``lax.conv_general_dilated`` outside any Pallas kernel.

Parity with the reference's ``forward``:

- Padding is XLA's ``"SAME"`` rule, applied explicitly (:func:`same_pads`).
  A stride-2 3x3 conv on an even input pads ``(0, 1)``, not ``(1, 1)``.
- The reference keeps HWIO weights and NHWC images. The module holds OIHW
  weights (``models.convert`` carries them over) and takes the NHWC batch,
  permuting it to NCHW once at entry. Head outputs come back NHWC, shaped
  ``(B, S, S, A, 5 + C)`` like the reference's.

Training runs the functional :func:`forward` over the reference's HWIO
param tree, whose leaves are views of one client's row of the packed
``(C, N_total)`` round state (``core.packing.unpack_views``). Each view is
permuted to OIHW inside the trunk, so autograd hands the gradient back
straight into the packed layout: no per-step copy of the weights into a
module and no pack of the gradients. The module and the functional form run
one trunk (:func:`_trunk`).

:func:`yolo_loss` is the paper's Eqs. 2-4, with the confidence target's IoU
(:func:`iou`) outside the gradient as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import convert
from repro_torch.models import params as mp
from repro_torch.models.params import ParamInfo

LAMBDA_COORD = 5.0  # the paper's pre-configured loss weights
LAMBDA_NOOBJ = 0.5

# anchor (w, h) priors per scale, normalized to image size
ANCHORS = (
    ((0.05, 0.06), (0.10, 0.12), (0.16, 0.20)),  # stride 8
    ((0.22, 0.28), (0.35, 0.40), (0.45, 0.55)),  # stride 16
    ((0.55, 0.70), (0.75, 0.85), (0.90, 0.95)),  # stride 32
)


def _conv_info(kh, kw, cin, cout, init="normal"):
    return ParamInfo((kh, kw, cin, cout), (None, None, None, None), init=init)


def template(cfg):
    """The reference's HWIO param template (``yolov3.template``).

    cfg.d_model = base width, cfg.n_layers = stages, cfg.vocab_size = C."""
    c = cfg.d_model
    n_stages = max(cfg.n_layers, 3)  # three detection scales need >=3 stages
    A = cfg.n_heads
    C = cfg.vocab_size
    t = {"stem": _conv_info(3, 3, 3, c)}
    widths = [c * 2 ** min(i + 1, 5) for i in range(n_stages)]
    stages = []
    cin = c
    for w in widths:
        stages.append(
            {
                "down": _conv_info(3, 3, cin, w),
                "res1": _conv_info(1, 1, w, w // 2),
                "res2": _conv_info(3, 3, w // 2, w),
            }
        )
        cin = w
    t["stages"] = tuple(stages)
    # heads on the last three stages
    t["heads"] = tuple(
        _conv_info(1, 1, widths[-3 + i], A * (5 + C), init="small_normal") for i in range(3)
    )
    return t


def grid_sizes(cfg, img_size: int) -> list[int]:
    """Detection-head grid sizes for an image size, largest scale first
    (``yolov3.grid_sizes``): strides 2^(n-2), 2^(n-1), 2^n for n stages."""
    n = max(cfg.n_layers, 3)  # template forces >= 3 stages
    return [img_size // (1 << (n - 2)), img_size // (1 << (n - 1)), img_size // (1 << n)]


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA ``"SAME"`` padding of one spatial dim -> ``(lo, hi)``."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW ``x`` * OIHW ``w`` with the reference's SAME padding."""
    ph = same_pads(x.shape[2], w.shape[2], stride)
    pw = same_pads(x.shape[3], w.shape[3], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def _oihw(info: ParamInfo) -> torch.Tensor:
    kh, kw, cin, cout = info.shape
    return torch.empty((cout, cin, kh, kw))


class _Stage(nn.Module):
    def __init__(self, infos: dict):
        super().__init__()
        self.down = nn.Parameter(_oihw(infos["down"]))
        self.res1 = nn.Parameter(_oihw(infos["res1"]))
        self.res2 = nn.Parameter(_oihw(infos["res2"]))


class FedYOLOv3(nn.Module):
    """The detector (``yolov3.forward`` over ``yolov3.template(cfg)``).

    State keys mirror the reference's param paths with ``.`` for ``/``
    (``stages.0.down``), each an OIHW conv weight. Weights are drawn by
    :func:`~repro_torch.models.params.init_params` from ``generator`` (seed 0
    when None), or given as ``weights``, an HWIO tree in the reference's
    layout (NumPy arrays or tensors, e.g. views of a packed row), which is
    also how ``models.convert.from_reference`` carries the reference's in.
    """

    def __init__(self, cfg, generator: torch.Generator | None = None, *, weights=None):
        super().__init__()
        self.cfg = cfg
        t = template(cfg)
        self.stem = nn.Parameter(_oihw(t["stem"]))
        self.stages = nn.ModuleList(_Stage(s) for s in t["stages"])
        self.heads = nn.ParameterList(nn.Parameter(_oihw(h)) for h in t["heads"])
        if weights is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            weights = mp.init_params(t, generator)
        with torch.no_grad():
            self.load_state_dict(convert.from_reference(weights))

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        """images (B, H, W, 3) NHWC -> 3 raw head outputs (B, S, S, A, 5+C)."""
        stages = [(st.down, st.res1, st.res2) for st in self.stages]
        return _trunk(self.cfg, self.stem, stages, list(self.heads), images)


def _trunk(cfg, stem, stages, heads, images: torch.Tensor) -> list[torch.Tensor]:
    """The darknet trunk and heads over OIHW weights."""
    A, C = cfg.n_heads, cfg.vocab_size
    x = images.permute(0, 3, 1, 2).contiguous()
    x = F.leaky_relu(_conv(x, stem), 0.1)
    feats = []
    for down, res1, res2 in stages:
        x = F.leaky_relu(_conv(x, down, stride=2), 0.1)
        h = F.leaky_relu(_conv(x, res1), 0.1)
        x = x + F.leaky_relu(_conv(h, res2), 0.1)
        feats.append(x)
    outs = []
    for f, head in zip(feats[-3:], heads):
        o = _conv(f, head).permute(0, 2, 3, 1)
        B, S1, S2, _ = o.shape
        outs.append(o.reshape(B, S1, S2, A, 5 + C))
    return outs


def forward(params, images: torch.Tensor, cfg) -> list[torch.Tensor]:
    """The reference's functional ``forward``: ``params`` is its HWIO tree
    (``{"heads", "stages", "stem"}``) of tensors, images (B, H, W, 3) ->
    3 raw head outputs (B, S, S, A, 5+C). Gradients flow back into the
    tree's leaves (and through views into the buffer they view)."""
    oihw = lambda w: w.permute(3, 2, 0, 1)
    stages = [(oihw(st["down"]), oihw(st["res1"]), oihw(st["res2"])) for st in params["stages"]]
    return _trunk(cfg, oihw(params["stem"]), stages, [oihw(h) for h in params["heads"]], images)


def decode_boxes(raw: torch.Tensor, anchors):
    """raw (B,S,S,A,5+C) -> boxes (x,y,w,h) normalized, conf, class probs
    (``yolov3.decode_boxes``)."""
    S = raw.shape[1]
    ar = torch.arange(S, device=raw.device, dtype=raw.dtype)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    anc = torch.tensor(anchors, dtype=torch.float32, device=raw.device)  # (A, 2)
    xy = (torch.sigmoid(raw[..., 0:2]) + torch.stack([gx, gy], -1)[:, :, None, :]) / S
    wh = anc[None, None, None] * torch.exp(torch.clamp(raw[..., 2:4], -6, 6))
    conf = torch.sigmoid(raw[..., 4])
    cls = torch.sigmoid(raw[..., 5:])
    return torch.cat([xy, wh], -1), conf, cls


def iou(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Broadcasting IoU of (..., 4) center-format boxes (``yolov3.iou``).
    Zero- and negative-area boxes score 0 against everything."""
    ax1, ay1 = box_a[..., 0] - box_a[..., 2] * 0.5, box_a[..., 1] - box_a[..., 3] * 0.5
    ax2, ay2 = box_a[..., 0] + box_a[..., 2] * 0.5, box_a[..., 1] + box_a[..., 3] * 0.5
    bx1, by1 = box_b[..., 0] - box_b[..., 2] * 0.5, box_b[..., 1] - box_b[..., 3] * 0.5
    bx2, by2 = box_b[..., 0] + box_b[..., 2] * 0.5, box_b[..., 1] + box_b[..., 3] * 0.5
    ix = torch.clamp_min(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), 0.0)
    iy = torch.clamp_min(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), 0.0)
    inter = torch.clamp_min(ix * iy, 0.0)
    area_a = torch.clamp_min((ax2 - ax1) * (ay2 - ay1), 0.0)
    area_b = torch.clamp_min((bx2 - bx1) * (by2 - by1), 0.0)
    union = area_a + area_b - inter
    return inter / torch.clamp_min(union, 1e-9)


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) through :func:`iou`; the eval
    path's pairwise IoU is the kernel ``kernels.ops.pairwise_iou``."""
    return iou(boxes_a[..., :, None, :], boxes_b[..., None, :, :])


def yolo_loss(params, batch: dict, cfg):
    """Paper Eqs. 2-4 (``yolov3.yolo_loss``) -> (loss, metrics).

    batch: {"images" (B, H, W, 3), "targets": per scale {"obj" (B,S,S,A),
    "box" (B,S,S,A,4), "cls" (B,S,S,A,C)}}, tensors on the params' device.
    """
    outs = forward(params, batch["images"], cfg)
    total = torch.zeros((), dtype=torch.float32, device=batch["images"].device)
    metrics = {}
    for s, (raw, anchors) in enumerate(zip(outs, ANCHORS)):
        tgt = batch["targets"][s]
        obj = tgt["obj"].float()
        noobj = 1.0 - obj
        boxes, conf, cls = decode_boxes(raw.float(), anchors)
        # Eq. 2: class prediction loss on object cells
        l_cls = torch.sum(obj[..., None] * (tgt["cls"] - cls) ** 2)
        # Eq. 3: bounding-box coordinate loss
        d = (tgt["box"] - boxes) ** 2
        l_box = (LAMBDA_COORD * torch.sum(obj * (d[..., 0] + d[..., 1]))
                 + LAMBDA_COORD * torch.sum(obj * (d[..., 2] + d[..., 3])))
        # Eq. 4: confidence; theta = p(obj) * IoU(pred, gt), no gradient
        theta = obj * iou(boxes, tgt["box"]).detach()
        l_conf = (torch.sum(obj * (theta - conf) ** 2)
                  + LAMBDA_NOOBJ * torch.sum(noobj * (theta - conf) ** 2))
        total = total + l_cls + l_box + l_conf
        metrics[f"scale{s}/cls"] = l_cls
        metrics[f"scale{s}/box"] = l_box
        metrics[f"scale{s}/conf"] = l_conf
    return total / batch["images"].shape[0], metrics
