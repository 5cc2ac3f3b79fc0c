"""Synthetic data (port of ``repro/data/synthetic.py``): detection scenes
(``scene_images``, ``boxes_to_arrays``, ``detection_scene_pool``), Markov
token streams (``MarkovTokens``, ``token_batches``) and hubert's frames and
cluster labels (``audio_batches``).

A NumPy copy: the same ``np.random.default_rng`` seed gives bit-identical
images, boxes, tokens and frames to the reference's.
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


def boxes_to_arrays(all_boxes: list[list[BBox]], max_boxes: int):
    """Pad BBox lists to the fixed-shape GT arrays the evaluator takes:
    (B, G, 4) center-format f32, (B, G) int32 labels, (B, G) 0/1 validity.
    Boxes beyond ``max_boxes`` are dropped."""
    B = len(all_boxes)
    boxes = np.zeros((B, max_boxes, 4), np.float32)
    cls = np.zeros((B, max_boxes), np.int32)
    valid = np.zeros((B, max_boxes), np.float32)
    for b, bs in enumerate(all_boxes):
        for g, bb in enumerate(bs[:max_boxes]):
            boxes[b, g] = [bb.x, bb.y, bb.w, bb.h]
            cls[b, g] = bb.label
            valid[b, g] = 1.0
    return boxes, cls, valid


def detection_scene_pool(
    n_scenes: int,
    size: int,
    n_classes: int,
    rng: np.random.Generator,
    *,
    max_boxes: int = 3,
    dominance: float = 0.8,
    scale_spread: float = 0.25,
):
    """Labeled scene pool for ``data.partition.make_scenario`` splits.

    Scene i has a dominant class (its partition label): objects draw that
    class with probability ``dominance`` and a box-scale band tied to it
    (class c's boxes live around ``0.12 + scale_spread * c / (K-1)``), so a
    split by label skews both classes and box scales per client.

    Returns {"images" (P,S,S,3), "bboxes" list[list[BBox]], "gt_boxes"
    (P,G,4), "gt_cls" (P,G), "gt_valid" (P,G), "labels" (P,)}.
    """
    images = np.empty((n_scenes, size, size, 3), np.float32)
    bboxes: list[list[BBox]] = []
    labels = np.empty(n_scenes, np.int64)
    for i in range(n_scenes):
        dom = int(rng.integers(0, n_classes))
        probs = np.full(n_classes, (1.0 - dominance) / max(n_classes - 1, 1))
        probs[dom] = dominance if n_classes > 1 else 1.0
        base = 0.12 + scale_spread * dom / max(n_classes - 1, 1)
        im, bs = scene_images(
            rng, 1, size, n_classes, max_boxes,
            class_probs=probs, scale_range=(base, base + 0.2),
        )
        images[i] = im[0]
        bboxes.append(bs[0])
        labels[i] = dom
    gt_boxes, gt_cls, gt_valid = boxes_to_arrays(bboxes, max_boxes)
    return {
        "images": images,
        "bboxes": bboxes,
        "gt_boxes": gt_boxes,
        "gt_cls": gt_cls,
        "gt_valid": gt_valid,
        "labels": labels,
    }


class MarkovTokens:
    """Order-1 Markov token source with client-dependent drift (non-IID)."""

    def __init__(self, vocab: int, seed: int = 0, drift: float = 0.0):
        rng = np.random.default_rng(seed)
        k = min(vocab, 64)  # latent states
        self.vocab = vocab
        base = rng.dirichlet([0.3] * k, size=k)
        if drift:
            base = (1 - drift) * base + drift * rng.dirichlet([0.3] * k, size=k)
        self.trans = base
        self.emit = rng.integers(0, vocab, size=k)
        self.k = k

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), np.int32)
        state = rng.integers(0, self.k, size=batch)
        for t in range(seq):
            out[:, t] = self.emit[state] % self.vocab
            u = rng.random((batch, 1))
            state = (np.cumsum(self.trans[state], axis=1) > u).argmax(axis=1)
        return out


def token_batches(vocab: int, n_clients: int, local_steps: int, batch: int, seq: int,
                  seed: int = 0, non_iid_drift: float = 0.5):
    """Yields {"tokens": (C, E, b, S)} with per-client distributions."""
    sources = [MarkovTokens(vocab, seed=seed + c, drift=non_iid_drift * c / max(n_clients - 1, 1))
               for c in range(n_clients)]
    rng = np.random.default_rng(seed + 999)
    while True:
        yield {
            "tokens": np.stack(
                [np.stack([s.sample(rng, batch, seq) for _ in range(local_steps)]) for s in sources]
            )
        }


def audio_batches(d_model: int, vocab: int, n_clients: int, local_steps: int, batch: int,
                  seq: int, seed: int = 0):
    """Yields hubert's batches: {"frames" (C, E, b, S, d_model) f32, "labels"
    (C, E, b, S) int32 cluster ids, "mask" (C, E, b, S) bool, about 30% of
    the frames}: each frame is its cluster's prototype plus noise."""
    rng = np.random.default_rng(seed)
    proto = rng.normal(size=(vocab, d_model)).astype(np.float32)
    while True:
        labels = rng.integers(0, vocab, size=(n_clients, local_steps, batch, seq))
        frames = proto[labels] + 0.5 * rng.normal(
            size=(n_clients, local_steps, batch, seq, d_model)).astype(np.float32)
        mask = rng.random((n_clients, local_steps, batch, seq)) < 0.3
        yield {"frames": frames.astype(np.float32), "labels": labels.astype(np.int32), "mask": mask}
