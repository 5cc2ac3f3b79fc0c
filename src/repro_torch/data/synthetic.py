"""Synthetic detection scenes (port of ``repro/data/synthetic.py::scene_images``).

A NumPy copy: the same ``np.random.default_rng`` seed gives bit-identical
images and boxes to the reference's. The token, audio and scene-pool
generators belong to later slices.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.darknet import BBox


def scene_images(
    rng: np.random.Generator,
    batch: int,
    size: int,
    n_classes: int,
    max_boxes: int = 3,
    class_probs=None,
    scale_range: tuple[float, float] = (0.15, 0.5),
):
    """Procedural detection scenes: bright rectangles = objects.

    Returns (images (B,size,size,3) f32, boxes list[list[BBox]]).
    ``class_probs`` (n_classes,) skews the object-class distribution and
    ``scale_range`` the box sizes — the per-client non-IID knobs the
    detection scenario suite turns (label skew + box-scale skew).
    """
    imgs = rng.normal(0.0, 0.05, size=(batch, size, size, 3)).astype(np.float32)
    lo, hi = scale_range
    all_boxes: list[list[BBox]] = []
    for b in range(batch):
        boxes = []
        for _ in range(int(rng.integers(1, max_boxes + 1))):
            w, h = rng.uniform(lo, hi, 2)
            x = rng.uniform(w / 2, 1 - w / 2)
            y = rng.uniform(h / 2, 1 - h / 2)
            if class_probs is None:
                label = int(rng.integers(0, n_classes))
            else:
                label = int(rng.choice(n_classes, p=class_probs))
            x0, y0 = int((x - w / 2) * size), int((y - h / 2) * size)
            x1, y1 = int((x + w / 2) * size), int((y + h / 2) * size)
            color = np.zeros(3, np.float32)
            color[label % 3] = 1.0
            imgs[b, y0:y1, x0:x1] += color  # class-colored rectangle
            boxes.append(BBox(label, x, y, w, h))
        all_boxes.append(boxes)
    return imgs, all_boxes
