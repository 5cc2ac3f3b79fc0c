"""Secure aggregation — pairwise additive masking (port of
``repro/core/secure_agg.py``; Bonawitz et al. 2017).

The paper: clients send "encrypted model parameters ... to the server in a
secure encrypted manner" and cite Bonawitz et al.'s system design. Every
client pair (i, j) derives a shared mask m_ij from a common seed; client i
adds +m_ij for j > i and -m_ji for j < i to its update. Masks cancel in the
SUM, so the server learns only the aggregate — individual updates stay
hidden. Out of scope, as in the reference: the dropout-recovery
secret-sharing layer.

This is the tree-level construction over a param tree (dicts and tuples of
tensors, as ``rounds.unpacked_params`` returns them), float arithmetic;
the packed ``secure`` aggregator (``core/aggregators/secure.py``, K8) is a
different, integer one. ``pair_seed`` is the reference's bit for bit. The
PRG is ``torch.randn`` on one ``torch.Generator`` per pair, seeded with
``pair_seed`` on the leaves' device and drawn leaf by leaf in the
reference's flattening order (dict keys sorted). ``jax.random``'s threefry
stream has no torch twin, so the masks are not the reference's numbers;
they cancel all the same, and the mean is what is held against it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.params import flatten_with_paths, unflatten

PyTree = Any


def _mix32(h: int) -> int:
    """murmur3 fmix32 finalizer on Python ints (masked to 32 bits)."""
    h &= 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def pair_seed(i: int, j: int, round_idx: int, session: int = 0) -> int:
    """Shared seed for the (unordered) client pair at a given round.

    In deployment this comes from a Diffie-Hellman exchange; here both
    parties can derive it because they share the session key. A stable
    fmix32 chain, NOT ``hash()``: tuple hashing is salted per process under
    PYTHONHASHSEED, so two worker processes would derive DIFFERENT masks
    for the same pair and nothing would cancel.
    """
    a, b = (i, j) if i < j else (j, i)
    h = _mix32((session & 0xFFFFFFFF) + 0x9E3779B9)
    h = _mix32(h ^ _mix32((round_idx & 0xFFFFFFFF) + 0x9E3779B9))
    h = _mix32(h + (a & 0xFFFFFFFF) * 0x9E3779B1)
    h = _mix32(h ^ ((b & 0xFFFFFFFF) * 0x85EBCA77 & 0xFFFFFFFF))
    return h & 0x7FFFFFFF


def _masks(template: PyTree, seed: int, scale: float):
    """Yield ``(path, mask)`` leaf by leaf: ``scale * N(0, 1)`` f32 of each
    leaf's shape, drawn from one generator seeded with ``seed``."""
    gens: dict[torch.device, torch.Generator] = {}
    for path, leaf in flatten_with_paths(template):
        g = gens.get(leaf.device)
        if g is None:
            g = gens[leaf.device] = torch.Generator(device=leaf.device).manual_seed(seed)
        m = torch.randn(leaf.shape, generator=g, dtype=torch.float32, device=leaf.device)
        yield path, m.mul_(scale)


def _mask_tree(template: PyTree, seed: int, scale: float) -> PyTree:
    return unflatten(template, dict(_masks(template, seed, scale)))


def mask_update(update: PyTree, client: int, n_clients: int, round_idx: int, *,
                scale: float = 1.0, session: int = 0) -> PyTree:
    """Client-side: add pairwise masks (+ for higher peers, − for lower)."""
    out = {path: x.to(torch.float32, copy=True) for path, x in flatten_with_paths(update)}
    for peer in range(n_clients):
        if peer == client:
            continue
        seed = pair_seed(client, peer, round_idx, session)
        for path, m in _masks(update, seed, scale):  # one leaf's mask at a time
            if peer > client:
                out[path].add_(m)
            else:
                out[path].sub_(m)
    return unflatten(update, out)


def aggregate_masked(masked_updates: list[PyTree]) -> PyTree:
    """Server-side: plain sum — the pairwise masks cancel exactly."""
    total = {path: x.clone() for path, x in flatten_with_paths(masked_updates[0])}
    for u in masked_updates[1:]:
        for path, x in flatten_with_paths(u):
            total[path].add_(x)
    return unflatten(masked_updates[0], total)


def secure_fedavg(updates: list[PyTree], round_idx: int, *, scale: float = 100.0,
                  session: int = 0) -> PyTree:
    """End-to-end: mask every client's update, sum at the server, divide.

    The server never sees an unmasked individual update.
    """
    n = len(updates)
    masked = [
        mask_update(u, i, n, round_idx, scale=scale, session=session)
        for i, u in enumerate(updates)
    ]
    total = aggregate_masked(masked)
    del masked
    return unflatten(total, {path: x.div_(n) for path, x in flatten_with_paths(total)})
