"""Explorer — client-side resource monitor (port of
``repro/core/explorer.py``; paper component #4).

"monitors the resource utilization situation on the client side (e.g., CPU
usage, memory usage, network load) so as to inform the Task Scheduler."

/proc-based (no external deps). In the simulated platform every client
shares one host, so :func:`monitor` returns the host telemetry,
:func:`simulated_loads` draws i.i.d. per-client loads for quick
experiments, and :class:`ClientLoadModel` is the persistent heterogeneous
straggler model whose per-round reports feed the Task Scheduler. A NumPy
copy: the same seed gives the same loads.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np


@dataclasses.dataclass
class ResourceReport:
    cpu_frac: float
    mem_frac: float
    load1: float
    timestamp: float


def _read_cpu_times() -> tuple[float, float]:
    with open("/proc/stat") as f:
        parts = f.readline().split()[1:]
    vals = [float(x) for x in parts]
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0.0)
    return sum(vals), idle


def monitor(sample_interval: float = 0.05) -> ResourceReport:
    t0, i0 = _read_cpu_times()
    time.sleep(sample_interval)
    t1, i1 = _read_cpu_times()
    dt, di = t1 - t0, i1 - i0
    cpu = 1.0 - di / dt if dt > 0 else 0.0
    total = avail = 1.0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = float(line.split()[1])
            elif line.startswith("MemAvailable:"):
                avail = float(line.split()[1])
    with open("/proc/loadavg") as f:
        load1 = float(f.read().split()[0])
    return ResourceReport(cpu, 1.0 - avail / total, load1, time.time())


def simulated_loads(n_clients: int, rng: np.random.Generator, base: ResourceReport | None = None) -> np.ndarray:
    """Per-client load in [0,1]: host load plus client-specific jitter."""
    host = base.cpu_frac if base else 0.2
    return np.clip(host + rng.uniform(-0.1, 0.6, n_clients), 0.0, 1.0)


@dataclasses.dataclass
class LoadModelConfig:
    straggler_frac: float = 0.25  # fraction of chronically overloaded clients
    straggler_load: float = 0.85  # their baseline load
    base_load: float = 0.25  # everyone else's baseline
    base_spread: float = 0.1  # per-client baseline spread
    persistence: float = 0.8  # AR(1) pull toward the baseline, per sim second
    jitter: float = 0.08  # AR(1) innovation scale, per sqrt(sim second)
    spike_prob: float = 0.05  # transient spike probability per sim second
    spike_load: float = 1.0  # spike level (device fully busy)
    spike_duration_s: float = 1.0  # how long a spike pins the load, sim seconds


class ClientLoadModel:
    """Persistent per-client load process: stragglers + AR(1) drift + spikes.

    A fixed straggler subset sits near ``straggler_load`` every round, the
    rest drift around their own baseline, and any client can transiently
    spike to ``spike_load``. ``step(dt)`` advances ``dt`` simulated seconds;
    the AR(1) pull and innovation scale with dt and a spike pins the load
    for ``spike_duration_s``. ``step()`` (dt = 1) is one sync round.
    Deterministic under a fixed seed.
    """

    def __init__(self, n_clients: int, seed: int = 0, config: LoadModelConfig | None = None):
        self.cfg = config or LoadModelConfig()
        self.n = n_clients
        self._rng = np.random.default_rng(seed)
        n_strag = int(round(self.cfg.straggler_frac * n_clients))
        self.stragglers = self._rng.choice(n_clients, size=n_strag, replace=False)
        self.baseline = np.clip(
            self.cfg.base_load + self.cfg.base_spread * self._rng.standard_normal(n_clients),
            0.05,
            0.6,
        )
        self.baseline[self.stragglers] = self.cfg.straggler_load
        self.loads = self.baseline.copy()
        self.t = 0.0  # simulated seconds of process time advanced so far
        self._spike_until = np.full(n_clients, -np.inf)  # spike end times

    def step(self, dt: float = 1.0) -> np.ndarray:
        """Advance ``dt`` simulated seconds; returns the (n,) load in [0, 1]."""
        if dt < 0:
            raise ValueError(f"load model cannot run backwards (dt={dt})")
        c = self.cfg
        self.t += dt
        rho = c.persistence ** dt
        # AR(1)-consistent innovation for a dt-second step (exactly jitter
        # at dt = 1; the random-walk limit is sqrt(dt))
        r2 = c.persistence ** 2
        scale = c.jitter * (
            math.sqrt(dt) if r2 >= 1.0 else math.sqrt((1.0 - r2 ** dt) / (1.0 - r2))
        )
        innov = scale * self._rng.standard_normal(self.n)
        ar = rho * self.loads + (1 - rho) * self.baseline + innov
        # spike arrivals at a per-second rate, the window capped at the
        # spike duration; a window of exactly 1 keeps the literal spike_prob
        win = min(dt, c.spike_duration_s)
        p = c.spike_prob if win == 1.0 else 1.0 - (1.0 - c.spike_prob) ** win
        fired = self._rng.random(self.n) < p
        self._spike_until = np.where(fired, self.t + c.spike_duration_s, self._spike_until)
        active = fired | (self.t < self._spike_until)
        self.loads = np.where(active, c.spike_load, ar)
        self.loads = np.clip(self.loads, 0.0, 1.0)
        return self.loads.copy()
