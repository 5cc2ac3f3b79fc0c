"""FL_CLIENT — client-side control surface (port of ``repro/core/client.py``;
paper component #6).

"hosts the Task Manager and Explorer components and performs local model
training." Local training runs inside the server's flat round
(``core.rounds``); this class is the *control plane* view of one client:
its data shard, its Explorer reports, and its reconnection/participation
state (the paper's Configuration module exposes reconnection counts).
NumPy only: the same client id draws the same reports as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np

PyTree = Any


@dataclasses.dataclass
class ClientConfig:
    client_id: int
    max_reconnects: int = 3  # paper Configuration: "number of reconnections"


class FLClient:
    def __init__(self, config: ClientConfig, data: Iterator[PyTree] | None = None, rng=None):
        self.cfg = config
        self.data = data
        self._rng = rng or np.random.default_rng(config.client_id)
        self.reconnects = 0
        self.connected = True

    def resource_report(self) -> float:
        """Load in [0,1] for the Explorer feed (simulated per client)."""
        return float(np.clip(self._rng.uniform(0.0, 0.8), 0.0, 1.0))

    def next_batch(self) -> PyTree:
        if self.data is None:
            raise RuntimeError("client has no data pipeline attached")
        return next(self.data)

    def drop(self) -> bool:
        """Simulate a disconnect; returns False when out of reconnect budget."""
        self.reconnects += 1
        self.connected = self.reconnects <= self.cfg.max_reconnects
        return self.connected

    def reconnect(self) -> None:
        if self.reconnects <= self.cfg.max_reconnects:
            self.connected = True
