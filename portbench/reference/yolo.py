"""Plain reference of fedyolov3's forward and its Eqs. 2-4 loss (a frozen
copy written from the FedVision paper and YOLOv3, plain PyTorch f32).

The trunk: a 3x3 stem, then per stage a stride-2 3x3 down conv and a
residual pair (1x1 to half width, 3x3 back), leaky ReLU 0.1 after every
conv; a 1x1 head on each of the last three stages gives (B, S, S, A, 5+C).
Convolutions pad by the "SAME" rule (a stride-2 conv on an even input pads
(0, 1)). Images are NHWC, weights HWIO, as the row holds them.

The loss, summed over the three scales and divided by the batch: Eq. 2 the
squared class error on object cells; Eq. 3 lambda_coord times the squared
centre and size errors on object cells; Eq. 4 the squared confidence error
against theta = obj * IoU(prediction, truth) (no gradient through the IoU),
lambda_noobj on cells without an object.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.layout import Leaf, normal, place

LAMBDA_COORD = 5.0
LAMBDA_NOOBJ = 0.5
ANCHORS = (  # (w, h) priors per scale, normalized, stride 8 / 16 / 32 at five stages
    ((0.05, 0.06), (0.10, 0.12), (0.16, 0.20)),
    ((0.22, 0.28), (0.35, 0.40), (0.45, 0.55)),
    ((0.55, 0.70), (0.75, 0.85), (0.90, 0.95)),
)


def leaves(sizes: dict) -> list[Leaf]:
    """The row's leaves: a stem, ``n_layers`` darknet stages (a stride-2 3x3
    down conv, a 1x1 and a 3x3 residual conv) of widths base x 2^min(i+1,
    5), and a 1x1 head on each of the last three stages."""
    c, A, C = sizes["d_model"], sizes["n_heads"], sizes["vocab_size"]
    n_stages = max(sizes["n_layers"], 3)
    widths = [c * 2 ** min(i + 1, 5) for i in range(n_stages)]
    conv = lambda name, kh, kw, cin, cout: normal(name, (kh, kw, cin, cout), kh * kw * cin)
    out = [Leaf(f"heads/{i}", (1, 1, widths[-3 + i], A * (5 + C)), "small", 0.02, False)
           for i in range(3)]
    cin = c
    for i, w in enumerate(widths):
        out += [conv(f"stages/{i}/down", 3, 3, cin, w), conv(f"stages/{i}/res1", 1, 1, w, w // 2),
                conv(f"stages/{i}/res2", 3, 3, w // 2, w)]
        cin = w
    out.append(conv("stem", 3, 3, 3, c))
    return place(out)


def grid_sizes(sizes: dict, img: int) -> list[int]:
    n = max(sizes["n_layers"], 3)
    return [img // (1 << (n - 2)), img // (1 << (n - 1)), img // (1 << n)]


def _same(size: int, k: int, stride: int) -> tuple[int, int]:
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1) -> torch.Tensor:
    w = w_hwio.permute(3, 2, 0, 1)
    ph, pw = _same(x.shape[2], w.shape[2], stride), _same(x.shape[3], w.shape[3], stride)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def forward(p: dict, images: torch.Tensor, sizes: dict) -> list[torch.Tensor]:
    """p: {"stem", "stages/i/down|res1|res2", "heads/i"} HWIO tensors."""
    A, C = sizes["n_heads"], sizes["vocab_size"]
    n_stages = max(sizes["n_layers"], 3)
    act = lambda t: F.leaky_relu(t, 0.1)
    x = act(conv(images.permute(0, 3, 1, 2), p["stem"]))
    feats = []
    for i in range(n_stages):
        x = act(conv(x, p[f"stages/{i}/down"], 2))
        x = x + act(conv(act(conv(x, p[f"stages/{i}/res1"])), p[f"stages/{i}/res2"]))
        feats.append(x)
    outs = []
    for i, f in enumerate(feats[-3:]):
        o = conv(f, p[f"heads/{i}"]).permute(0, 2, 3, 1)
        outs.append(o.reshape(o.shape[0], o.shape[1], o.shape[2], A, 5 + C))
    return outs


def _decode(raw: torch.Tensor, anchors) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    S = raw.shape[1]
    ar = torch.arange(S, device=raw.device, dtype=raw.dtype)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    anc = torch.tensor(anchors, dtype=torch.float32, device=raw.device)
    xy = (torch.sigmoid(raw[..., 0:2]) + torch.stack([gx, gy], -1)[:, :, None, :]) / S
    wh = anc * torch.exp(torch.clamp(raw[..., 2:4], -6, 6))
    return torch.cat([xy, wh], -1), torch.sigmoid(raw[..., 4]), torch.sigmoid(raw[..., 5:])


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1 = a[..., :2] - a[..., 2:] / 2, a[..., :2] + a[..., 2:] / 2
    b0, b1 = b[..., :2] - b[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2
    wh = torch.clamp_min(torch.minimum(a1, b1) - torch.maximum(a0, b0), 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda lo, hi: torch.clamp_min((hi - lo)[..., 0] * (hi - lo)[..., 1], 0.0)
    return inter / torch.clamp_min(area(a0, a1) + area(b0, b1) - inter, 1e-9)


def loss(p: dict, batch: dict, sizes: dict) -> torch.Tensor:
    """batch: {"images" (B, H, W, 3), "targets": per scale {"obj", "box",
    "cls"}} -> the scalar loss."""
    total = torch.zeros((), dtype=torch.float32, device=batch["images"].device)
    for raw, anchors, tgt in zip(forward(p, batch["images"], sizes), ANCHORS, batch["targets"]):
        obj = tgt["obj"]
        boxes, conf, cls = _decode(raw, anchors)
        l_cls = torch.sum(obj[..., None] * (tgt["cls"] - cls) ** 2)
        d = (tgt["box"] - boxes) ** 2
        l_box = LAMBDA_COORD * torch.sum(obj * (d[..., 0] + d[..., 1] + d[..., 2] + d[..., 3]))
        theta = obj * _iou(boxes, tgt["box"]).detach()
        e = (theta - conf) ** 2
        l_conf = torch.sum(obj * e) + LAMBDA_NOOBJ * torch.sum((1.0 - obj) * e)
        total = total + l_cls + l_box + l_conf
    return total / batch["images"].shape[0]
