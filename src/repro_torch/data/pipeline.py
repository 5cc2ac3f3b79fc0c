"""Host-side detection data (port of ``repro/data/pipeline.py::detection_suite``).

NumPy only: the same seed gives bit-identical batches to the reference's.
The batches stay NumPy; the caller moves them to its device
(``core.rounds.to_device``). The token and audio pipelines belong to later
slices.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.rounds import FedConfig
from repro_torch.data import darknet, partition, synthetic
from repro_torch.models.yolov3 import ANCHORS, grid_sizes


def _scene_targets(pool: dict, idx: np.ndarray, grids: list[int], cfg: ArchConfig):
    """Sampled scene indices (C, E, b) -> (images, per-scale grid targets)."""
    C, E, b = idx.shape
    ims = pool["images"][idx]  # (C, E, b, S, S, 3)
    acc = [
        [darknet.build_targets([pool["bboxes"][i] for i in idx[c, e]], grids, cfg.n_heads,
                               cfg.vocab_size, ANCHORS) for e in range(E)]
        for c in range(C)
    ]
    targets = [
        {
            k: np.stack([np.stack([acc[c][e][s][k] for e in range(E)]) for c in range(C)])
            for k in ("obj", "box", "cls")
        }
        for s in range(len(grids))
    ]
    return ims, targets


def detection_suite(
    cfg: ArchConfig,
    fed: FedConfig,
    batch: int,
    img_size: int = 64,
    scenario: str = "dirichlet",
    seed: int = 0,
    *,
    alpha: float = 0.5,
    pool_scenes: int = 96,
    eval_per_client: int = 4,
    max_boxes: int = 3,
):
    """Partitioned detection data: (train_batches, eval_batch, stats).

    A pool of labeled synthetic scenes (``detection_scene_pool``) is split
    across clients by ``partition.make_scenario``. ``train_batches`` yields
    ``{"images" (C, E, b, S, S, 3), "targets": [per-scale {"obj", "box",
    "cls"}]}``; ``eval_batch`` is a fixed per-client holdout of
    ``eval_per_client`` scenes (``(C, Be, ...)`` leaves) that leaves the
    client's training pool, unless the client holds too few scenes, when it
    is drawn with replacement from the whole partition.
    """
    C, E = fed.n_clients, fed.local_steps
    pool = synthetic.detection_scene_pool(
        pool_scenes, img_size, cfg.vocab_size, np.random.default_rng(seed), max_boxes=max_boxes
    )
    parts = partition.make_scenario(
        scenario, pool["labels"], C, np.random.default_rng(seed + 1), alpha=alpha
    )
    grids = grid_sizes(cfg, img_size)
    eval_rng = np.random.default_rng(seed + 2)
    eval_rows, train_parts = [], []
    for c in range(C):
        p = parts[c]
        if len(p) > eval_per_client:
            sel = eval_rng.choice(p, size=eval_per_client, replace=False)
            train_parts.append(np.setdiff1d(p, sel))
        else:
            sel = eval_rng.choice(p, size=eval_per_client, replace=True)
            train_parts.append(p)
        eval_rows.append(sel)
    eval_idx = np.stack(eval_rows)
    eval_batch = {
        "images": pool["images"][eval_idx],
        "gt_boxes": pool["gt_boxes"][eval_idx],
        "gt_cls": pool["gt_cls"][eval_idx],
        "gt_valid": pool["gt_valid"][eval_idx],
    }
    stats = {
        "parts": parts,
        "label": partition.partition_stats(parts, pool["labels"]),
        "scale": partition.scale_skew_stats(parts, pool["gt_boxes"], pool["gt_valid"]),
    }

    def train_batches():
        draw = np.random.default_rng(seed + 3)
        while True:
            idx = np.stack([draw.choice(train_parts[c], size=(E, batch)) for c in range(C)])
            ims, targets = _scene_targets(pool, idx, grids, cfg)
            yield {"images": ims, "targets": targets}

    return train_batches(), eval_batch, stats
