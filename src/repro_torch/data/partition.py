"""Federated data partitioning — horizontal (sample-space) splits (Eq. 1);
a NumPy copy of ``repro/data/partition.py``, bit-identical for one seed.

HFL requires identical feature/label spaces with disjoint sample ids across
parties. The non-IID scenario suite (FedCV-style; He et al. 2021):

- `dirichlet_partition`  — label skew: per class, proportions ~ Dir(alpha);
- `quantity_skew_partition` — size skew: client sizes ~ LogNormal(0, sigma);
- `class_shard_partition` — pathological label shards (McMahan et al. 2017):
  sort by label, deal each client `shards_per_client` contiguous shards;
- `iid_partition` — the control.

`make_scenario` is the string-keyed dispatcher `launch/train.py` uses.
Every split is a pure function of the passed Generator, so a fixed seed
reproduces the exact partition.
"""
from __future__ import annotations

import numpy as np

SCENARIOS = ("iid", "dirichlet", "shards", "quantity")


def iid_partition(n_samples: int, n_clients: int, rng: np.random.Generator) -> list[np.ndarray]:
    perm = rng.permutation(n_samples)
    return [np.sort(s) for s in np.array_split(perm, n_clients)]


def _ensure_min(out: list[np.ndarray], min_per_client: int) -> list[np.ndarray]:
    """Donor rebalance to a fixed point: move samples from the largest
    client to the smallest until every client holds >= min_per_client (so
    every client can form a batch). Each move shrinks the total deficit, so
    this terminates whenever the floor is feasible at all."""
    total = sum(len(s) for s in out)
    if min_per_client * len(out) > total:
        raise ValueError(
            f"min_per_client={min_per_client} infeasible: {total} samples "
            f"across {len(out)} clients"
        )
    while True:
        i = int(np.argmin([len(s) for s in out]))
        if len(out[i]) >= min_per_client:
            return out
        donor = int(np.argmax([len(s) for s in out]))
        need = min_per_client - len(out[i])
        take = out[donor][-need:]
        out[donor] = out[donor][:-need]
        out[i] = np.sort(np.concatenate([out[i], take]))


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float, rng: np.random.Generator, min_per_client: int = 1) -> list[np.ndarray]:
    """Label-skewed split: per class, proportions ~ Dir(alpha) over clients."""
    n_classes = int(labels.max()) + 1
    shards: list[list[int]] = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for shard, part in zip(shards, np.split(idx, cuts)):
            shard.extend(part.tolist())
    return _ensure_min([np.asarray(sorted(s), int) for s in shards], min_per_client)


def quantity_skew_partition(n_samples: int, n_clients: int, rng: np.random.Generator, sigma: float = 1.0, min_per_client: int = 1) -> list[np.ndarray]:
    """Size-skewed IID split: client shares ~ LogNormal(0, sigma), labels IID.

    sigma=0 reduces to `iid_partition`'s equal sizes; sigma~1 gives a
    realistic long-tail where a few clients hold most of the data.
    """
    raw = rng.lognormal(0.0, sigma, n_clients) if sigma > 0 else np.ones(n_clients)
    props = raw / raw.sum()
    cuts = np.clip((np.cumsum(props) * n_samples).astype(int)[:-1], 0, n_samples)
    perm = rng.permutation(n_samples)
    return _ensure_min([np.sort(s) for s in np.split(perm, cuts)], min_per_client)


def class_shard_partition(labels: np.ndarray, n_clients: int, shards_per_client: int, rng: np.random.Generator) -> list[np.ndarray]:
    """Pathological non-IID (McMahan et al. 2017): sort by label, cut into
    n_clients * shards_per_client contiguous shards, deal shards_per_client
    to each client — every client sees only a few classes."""
    order = np.argsort(labels, kind="stable")
    n_shards = n_clients * shards_per_client
    if n_shards > len(labels):
        raise ValueError(
            f"class_shard_partition: {n_shards} shards > {len(labels)} samples"
        )
    shards = np.array_split(order, n_shards)
    deal = rng.permutation(n_shards)
    return [
        np.sort(np.concatenate([shards[deal[c * shards_per_client + j]] for j in range(shards_per_client)]))
        for c in range(n_clients)
    ]


def make_scenario(
    name: str,
    labels: np.ndarray,
    n_clients: int,
    rng: np.random.Generator,
    *,
    alpha: float = 0.5,
    shards_per_client: int = 2,
    sigma: float = 1.0,
) -> list[np.ndarray]:
    """String-keyed scenario dispatch (see SCENARIOS). Deterministic in rng."""
    if name == "iid":
        return iid_partition(len(labels), n_clients, rng)
    if name == "dirichlet":
        return dirichlet_partition(labels, n_clients, alpha, rng)
    if name == "shards":
        return class_shard_partition(labels, n_clients, shards_per_client, rng)
    if name == "quantity":
        return quantity_skew_partition(len(labels), n_clients, rng, sigma)
    raise ValueError(f"unknown partition scenario {name!r}; known: {SCENARIOS}")


def scale_skew_stats(parts: list[np.ndarray], gt_boxes: np.ndarray, gt_valid: np.ndarray) -> dict:
    """Box-scale skew of a partitioned detection scene pool.

    The detection suite ties box scale to the dominant class
    (`data.synthetic.detection_scene_pool`), so a label-skewed
    `make_scenario` split also skews object sizes per client — this is the
    measurement. gt_boxes (P, G, 4) center-format, gt_valid (P, G) 0/1.
    Returns per-client mean sqrt-box-area plus a spread ratio (max/min of
    the client means; 1.0 == no scale skew).
    """
    scale = np.sqrt(np.maximum(gt_boxes[..., 2] * gt_boxes[..., 3], 0.0))  # (P, G)
    means = []
    for p in parts:
        v = gt_valid[p]
        means.append(float((scale[p] * v).sum() / max(v.sum(), 1.0)))
    means_arr = np.asarray(means)
    return {
        "mean_scale": means_arr,
        "spread": float(means_arr.max() / max(means_arr.min(), 1e-9)),
    }


def partition_stats(parts: list[np.ndarray], labels: np.ndarray) -> dict:
    n_classes = int(labels.max()) + 1
    hist = np.stack([np.bincount(labels[p], minlength=n_classes) for p in parts])
    frac = hist / np.maximum(hist.sum(1, keepdims=True), 1)
    uniform = np.full(n_classes, 1.0 / n_classes)
    tv = 0.5 * np.abs(frac - uniform).sum(1)  # total-variation from uniform
    return {"sizes": [len(p) for p in parts], "label_hist": hist, "skew_tv": tv}
