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

``iou`` and ``yolo_loss`` belong to the training slice and are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import convert
from repro_torch.models import params as mp
from repro_torch.models.params import ParamInfo

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
    when None), or carried in from the reference through
    ``models.convert.from_reference`` + ``load_state_dict``.
    """

    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        t = template(cfg)
        self.stem = nn.Parameter(_oihw(t["stem"]))
        self.stages = nn.ModuleList(_Stage(s) for s in t["stages"])
        self.heads = nn.ParameterList(nn.Parameter(_oihw(h)) for h in t["heads"])
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.load_state_dict(convert.from_reference(mp.init_params(t, generator)))

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        """images (B, H, W, 3) NHWC -> 3 raw head outputs (B, S, S, A, 5+C)."""
        A, C = self.cfg.n_heads, self.cfg.vocab_size
        x = images.permute(0, 3, 1, 2).contiguous()
        x = F.leaky_relu(_conv(x, self.stem), 0.1)
        feats = []
        for st in self.stages:
            x = F.leaky_relu(_conv(x, st.down, stride=2), 0.1)
            h = F.leaky_relu(_conv(x, st.res1), 0.1)
            x = x + F.leaky_relu(_conv(h, st.res2), 0.1)
            feats.append(x)
        outs = []
        for f, head in zip(feats[-3:], self.heads):
            o = _conv(f, head).permute(0, 2, 3, 1)
            B, S1, S2, _ = o.shape
            outs.append(o.reshape(B, S1, S2, A, 5 + C))
        return outs


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
