"""Synthetic camera scenes and their detection targets (a copy of the
port's ``data/synthetic.py::scene_images`` and ``data/darknet.py::
build_targets``).

A scene is noise N(0, 0.05^2) with 1 to ``max_boxes`` class-coloured
rectangles: a box of class k adds 1 to colour channel k mod 3. The boxes
come from ``np.random.default_rng``; the noise is drawn on the device in one
call for the whole pool, so making a pool costs no host work per pixel.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.yolo import ANCHORS, grid_sizes


def draw_boxes(rng: np.random.Generator, n_classes: int, max_boxes: int,
               scale_range: tuple[float, float] = (0.15, 0.5)) -> list[tuple]:
    """One scene's boxes: (label, x, y, w, h), centre format, normalized."""
    lo, hi = scale_range
    boxes = []
    for _ in range(int(rng.integers(1, max_boxes + 1))):
        w, h = rng.uniform(lo, hi, 2)
        x = rng.uniform(w / 2, 1 - w / 2)
        y = rng.uniform(h / 2, 1 - h / 2)
        boxes.append((int(rng.integers(0, n_classes)), float(x), float(y), float(w), float(h)))
    return boxes


def paint(images: torch.Tensor, boxes: list[list[tuple]], size: int) -> None:
    """Add each scene's rectangles to its (size, size, 3) image in place;
    ``images`` is (n, size, size, 3), ``boxes`` one list a scene."""
    for i, scene in enumerate(boxes):
        for label, x, y, w, h in scene:
            x0, y0 = int((x - w / 2) * size), int((y - h / 2) * size)
            x1, y1 = int((x + w / 2) * size), int((y + h / 2) * size)
            images[i, y0:y1, x0:x1, label % 3] += 1.0


def build_targets(boxes: list[list[tuple]], grids: list[int], n_anchors: int,
                  n_classes: int) -> list[dict]:
    """Grid targets per scale for the Eqs. 2-4 loss: each box goes to the
    cell holding its centre, at the anchor closest in log (w, h).
    -> [{"obj" (B,S,S,A), "box" (B,S,S,A,4), "cls" (B,S,S,A,C)}] f32."""
    B = len(boxes)
    out = []
    for s, S in enumerate(grids):
        obj = np.zeros((B, S, S, n_anchors), np.float32)
        box = np.zeros((B, S, S, n_anchors, 4), np.float32)
        cls = np.zeros((B, S, S, n_anchors, n_classes), np.float32)
        anc = np.asarray(ANCHORS[s], np.float32)
        for b, scene in enumerate(boxes):
            for label, x, y, w, h in scene:
                gx, gy = min(int(x * S), S - 1), min(int(y * S), S - 1)
                a = int(np.argmin(np.sum((np.log(anc) - np.log([[w, h]])) ** 2, axis=1)))
                obj[b, gy, gx, a] = 1.0
                box[b, gy, gx, a] = [x, y, w, h]
                cls[b, gy, gx, a, label % n_classes] = 1.0
        out.append({"obj": obj, "box": box, "cls": cls})
    return out


def pool(mix: dict, sizes: dict, seed: int, device) -> list[dict]:
    """``mix["pool_rounds"]`` distinct rounds, each {"images" (C, E, b, H,
    W, 3), "targets": per scale {"obj", "box", "cls"} (C, E, b, ...)} on
    ``device``: the program's batch layout."""
    P, C, E, b = mix["pool_rounds"], mix["clients"], mix["local_steps"], mix["batch"]
    size, K = mix["img_size"], sizes["vocab_size"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    images = torch.randn((P * C * E * b, size, size, 3), generator=gen, device=device).mul_(0.05)
    boxes = [draw_boxes(rng, K, mix["max_boxes"]) for _ in range(P * C * E * b)]
    paint(images, boxes, size)
    images = images.reshape(P, C, E, b, size, size, 3)
    grids = grid_sizes(sizes, size)
    rounds = []
    for p in range(P):
        per = [[build_targets(boxes[((p * C + c) * E + e) * b: ((p * C + c) * E + e + 1) * b],
                              grids, sizes["n_heads"], K) for e in range(E)] for c in range(C)]
        targets = [{k: torch.from_numpy(np.stack([np.stack([per[c][e][s][k] for e in range(E)])
                                                  for c in range(C)])).to(device)
                    for k in ("obj", "box", "cls")} for s in range(len(grids))]
        rounds.append({"images": images[p], "targets": targets})
    return rounds
