"""Darknet-format annotation (port of ``repro/data/darknet.py``).

Each row of the paper's annotation format is ``{label x y w h}``: the
category, the box center and its width/height, all normalized to [0, 1].
Parser and writer, the platform's directory mapping (an annotation file
sits next to its image and is mapped into the training directory), and the
grid targets of the Eqs. 2-4 loss. A NumPy copy of the reference:
the same boxes give bit-identical targets.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class BBox:
    label: int
    x: float  # center, normalized
    y: float
    w: float
    h: float

    def validate(self) -> "BBox":
        if not (0 <= self.x <= 1 and 0 <= self.y <= 1 and 0 < self.w <= 1 and 0 < self.h <= 1):
            raise ValueError(f"bbox out of range: {self}")
        if self.label < 0:
            raise ValueError(f"negative label: {self}")
        return self


def parse_annotation(text: str) -> list[BBox]:
    boxes = []
    for ln, line in enumerate(text.splitlines()):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 5:
            raise ValueError(f"line {ln}: expected 'label x y w h', got {line!r}")
        boxes.append(BBox(int(parts[0]), *(float(p) for p in parts[1:])).validate())
    return boxes


def write_annotation(boxes: list[BBox]) -> str:
    return "\n".join(f"{b.label} {b.x:.6f} {b.y:.6f} {b.w:.6f} {b.h:.6f}" for b in boxes)


def map_annotations(image_dir: str | Path, train_dir: str | Path) -> dict[str, list[BBox]]:
    """Collect ``<stem>.txt`` next to the images into the training
    directory, returning ``{stem: boxes}``."""
    image_dir, train_dir = Path(image_dir), Path(train_dir)
    train_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for ann in sorted(image_dir.glob("*.txt")):
        boxes = parse_annotation(ann.read_text())
        (train_dir / ann.name).write_text(write_annotation(boxes))
        out[ann.stem] = boxes
    return out


def build_targets(boxes_per_image: list[list[BBox]], grid_sizes: list[int], n_anchors: int,
                  n_classes: int, anchors) -> list[dict]:
    """Grid targets per scale for the Eq. 2-4 loss.

    Returns ``[{"obj" (B,S,S,A), "box" (B,S,S,A,4), "cls" (B,S,S,A,C)}]``.
    Each gt box goes to the grid cell holding its center at every scale, to
    the anchor closest in log (w, h).
    """
    B = len(boxes_per_image)
    out = []
    for s_idx, S in enumerate(grid_sizes):
        obj = np.zeros((B, S, S, n_anchors), np.float32)
        box = np.zeros((B, S, S, n_anchors, 4), np.float32)
        cls = np.zeros((B, S, S, n_anchors, n_classes), np.float32)
        anc = np.asarray(anchors[s_idx], np.float32)  # (A, 2)
        for b, boxes in enumerate(boxes_per_image):
            for gt in boxes:
                gx, gy = min(int(gt.x * S), S - 1), min(int(gt.y * S), S - 1)
                d = np.sum((np.log(anc) - np.log([[gt.w, gt.h]])) ** 2, axis=1)
                a = int(np.argmin(d))
                obj[b, gy, gx, a] = 1.0
                box[b, gy, gx, a] = [gt.x, gt.y, gt.w, gt.h]
                cls[b, gy, gx, a, gt.label % n_classes] = 1.0
        out.append({"obj": obj, "box": box, "cls": cls})
    return out
