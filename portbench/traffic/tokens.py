"""Per-client token streams (a copy of the port's ``data/synthetic.py::
MarkovTokens`` and ``token_batches``).

Client c reads an order-1 Markov chain over min(vocab, 64) latent states
that emit fixed token ids; its transition matrix drifts from the shared one
by ``non_iid_drift * c / (C - 1)``, so the clients' data differ.
"""
from __future__ import annotations

import numpy as np
import torch


class MarkovTokens:
    def __init__(self, vocab: int, seed: int, drift: float = 0.0):
        rng = np.random.default_rng(seed)
        k = min(vocab, 64)
        base = rng.dirichlet([0.3] * k, size=k)
        if drift:
            base = (1 - drift) * base + drift * rng.dirichlet([0.3] * k, size=k)
        self.vocab, self.k, self.trans = vocab, k, base
        self.emit = rng.integers(0, vocab, size=k)

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), np.int32)
        state = rng.integers(0, self.k, size=batch)
        cum = np.cumsum(self.trans, axis=1)
        for t in range(seq):
            out[:, t] = self.emit[state] % self.vocab
            state = (cum[state] > rng.random((batch, 1))).argmax(axis=1)
        return out


def pool(mix: dict, sizes: dict, seed: int, device) -> list[dict]:
    """``mix["pool_rounds"]`` distinct rounds of {"tokens" (C, E, b, S)
    int32} on ``device``."""
    P, C, E, b, S = (mix[k] for k in ("pool_rounds", "clients", "local_steps", "batch", "seq"))
    drift = mix.get("non_iid_drift", 0.5)
    sources = [MarkovTokens(sizes["vocab_size"], seed + c, drift * c / max(C - 1, 1))
               for c in range(C)]
    rng = np.random.default_rng(seed + 999)
    rounds = []
    for _ in range(P):
        toks = np.stack([np.stack([s.sample(rng, b, S) for _ in range(E)]) for s in sources])
        rounds.append({"tokens": torch.from_numpy(toks).to(device)})
    return rounds
