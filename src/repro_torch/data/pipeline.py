"""Host-side batching (port of ``repro/data/pipeline.py``): the detection
suite, the partitioned token pool and ``fed_batches`` for every modality.

NumPy only: the same seed gives bit-identical batches to the reference's.
The batches stay NumPy; the caller moves them to its device
(``core.rounds.to_device``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.rounds import FedConfig
from repro_torch.data import darknet, partition, synthetic
from repro_torch.models.yolov3 import ANCHORS, grid_sizes


def partitioned_token_batches(
    vocab: int,
    n_clients: int,
    local_steps: int,
    batch: int,
    seq: int,
    scenario: str = "dirichlet",
    seed: int = 0,
    *,
    alpha: float = 0.5,
    n_sources: int = 8,
    pool_per_source: int = 64,
):
    """Token batches drawn from a partitioned labeled pool.

    A pool of sequences is pre-sampled from ``n_sources`` distinct Markov
    chains (label = source id), split across clients by the named
    ``data.partition`` scenario, and each client then draws batches from its
    own index set only. Yields {"tokens": (C, E, b, S)}.
    """
    sources = [synthetic.MarkovTokens(vocab, seed=seed + s) for s in range(n_sources)]
    rng = np.random.default_rng(seed + 101)
    seqs = np.concatenate([s.sample(rng, pool_per_source, seq) for s in sources])
    labels = np.repeat(np.arange(n_sources), pool_per_source)
    parts = partition.make_scenario(
        scenario, labels, n_clients, np.random.default_rng(seed + 202), alpha=alpha
    )
    draw = np.random.default_rng(seed + 303)
    while True:
        idx = np.stack(
            [draw.choice(parts[c], size=(local_steps, batch)) for c in range(n_clients)]
        )
        yield {"tokens": seqs[idx].astype(np.int32)}  # (C, E, b, S)


def _stack_targets(acc: list[list[list[dict]]]) -> list[dict]:
    """Per-(client, step) grid targets -> per-scale dicts of (C, E, b, ...)."""
    C, E = len(acc), len(acc[0])
    return [
        {
            k: np.stack([np.stack([acc[c][e][s][k] for e in range(E)]) for c in range(C)])
            for k in ("obj", "box", "cls")
        }
        for s in range(len(acc[0][0]))
    ]


def _scene_targets(pool: dict, idx: np.ndarray, grids: list[int], cfg: ArchConfig):
    """Sampled scene indices (C, E, b) -> (images, per-scale grid targets)."""
    C, E, b = idx.shape
    ims = pool["images"][idx]  # (C, E, b, S, S, 3)
    acc = [
        [darknet.build_targets([pool["bboxes"][i] for i in idx[c, e]], grids, cfg.n_heads,
                               cfg.vocab_size, ANCHORS) for e in range(E)]
        for c in range(C)
    ]
    return ims, _stack_targets(acc)


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


def fed_batches(cfg: ArchConfig, fed: FedConfig, batch: int, seq: int, seed: int = 0,
                img_size: int = 96, partition_name: str = "stream", alpha: float = 0.5):
    """Client-stacked batches (C, E, b, ...) for ``core.rounds.build_fed_round``.

    Text archs: per-client Markov drift (``"stream"``) or a ``data.partition``
    scenario over a labeled pool (:func:`partitioned_token_batches`); yolo
    archs: fresh scenes every local step (``"stream"``: images (C, E, b, H,
    W, 3) and three target heads of (C, E, b, ...)) or, under a scenario,
    :func:`detection_suite`'s training batches; audio: ``audio_batches``'
    frames, labels and mask of ``seq`` frames; vlm: ``max(seq - ni, 8)``
    text tokens a sequence beside ``ni = n_image_tokens`` image embeddings
    (C, E, b, ni, d_model), drawn from a second ``default_rng(seed)``. A
    partition scenario applies to text and yolo archs only.
    """
    C, E = fed.n_clients, fed.local_steps
    if partition_name != "stream":
        if cfg.family == "yolo":
            gen, _, _ = detection_suite(cfg, fed, batch, img_size, partition_name, seed, alpha=alpha)
            yield from gen
            return
        if cfg.modality != "text":
            raise ValueError(
                f"partition scenarios only apply to text and yolo archs (got "
                f"modality={cfg.modality!r}); use the default 'stream'")
        yield from partitioned_token_batches(cfg.vocab_size, C, E, batch, seq, partition_name,
                                             seed, alpha=alpha)
        return
    if cfg.modality == "audio":
        yield from synthetic.audio_batches(cfg.d_model, cfg.vocab_size, C, E, batch, seq, seed)
        return
    if cfg.modality == "vlm":
        ni = cfg.n_image_tokens
        rng = np.random.default_rng(seed)
        for tb in synthetic.token_batches(cfg.vocab_size, C, E, batch, max(seq - ni, 8), seed):
            imgs = rng.normal(size=(C, E, batch, ni, cfg.d_model)).astype(np.float32) * 0.1
            yield {"tokens": tb["tokens"], "images": imgs}
    if cfg.family == "yolo":
        # per-step detection scenes: every (client, step) draws a fresh batch
        rng = np.random.default_rng(seed)
        grids = grid_sizes(cfg, img_size)
        while True:
            ims = np.empty((C, E, batch, img_size, img_size, 3), np.float32)
            acc = [[None] * E for _ in range(C)]
            for c in range(C):
                for e in range(E):
                    im, boxes = synthetic.scene_images(rng, batch, img_size, cfg.vocab_size)
                    ims[c, e] = im
                    acc[c][e] = darknet.build_targets(boxes, grids, cfg.n_heads, cfg.vocab_size,
                                                      ANCHORS)
            yield {"images": ims, "targets": _stack_targets(acc)}
    yield from synthetic.token_batches(cfg.vocab_size, C, E, batch, seq, seed)
