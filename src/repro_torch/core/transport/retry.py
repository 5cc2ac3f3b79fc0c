"""Deterministic retry and backoff for the wire transport (port of
``repro/core/transport/retry.py``; DESIGN.md §16).

A copy of the reference's pure-Python module (the port never imports the
JAX package): the same ``(base, cap, attempts, jitter, seed)`` gives the
same delays, bit for bit.

A worker that races the server's bind, or outlives a server crash, retries
instead of dying on one ``socket.create_connection``. `Backoff` is the one
retry policy both ends share: exponential delays with *deterministic*
jitter (a seeded fmix32 hash of ``(seed, attempt)``, never host
randomness), capped per delay and bounded in attempts, so two runs of one
scenario sleep the same schedule and the chaos tests can pin reconnect
behaviour exactly. C workers restarted together compute *different* delay
sequences (seed = client id), which spreads the reconnect stampede after a
server restart.
"""
from __future__ import annotations

import socket
import time


def _fmix32(x: int) -> int:
    """Murmur3 finalizer — the same integer mixer the quant codec uses for
    its deterministic rotation; good avalanche from consecutive seeds."""
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x


class Backoff:
    """Bounded exponential backoff with seeded deterministic jitter.

    delay(k) = min(base * 2^k, cap) * (1 - jitter * u_k) where u_k in
    [0, 1) is the fmix32 hash of (seed, k) — pure, replayable, no RNG
    state. ``attempts`` bounds how many delays exist; iterating past the
    bound raises ``RetriesExhausted``.
    """

    def __init__(self, *, base: float = 0.05, cap: float = 2.0,
                 attempts: int = 8, jitter: float = 0.5, seed: int = 0):
        if base <= 0 or cap < base:
            raise ValueError(f"need 0 < base <= cap, got base={base} cap={cap}")
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.base, self.cap, self.attempts = base, cap, attempts
        self.jitter, self.seed = jitter, seed

    def delay(self, attempt: int) -> float:
        """Seconds to sleep after failed attempt `attempt` (0-based)."""
        raw = min(self.base * (2.0 ** attempt), self.cap)
        u = _fmix32(self.seed * 0x9E3779B9 + attempt) / float(1 << 32)
        return raw * (1.0 - self.jitter * u)

    def delays(self) -> list[float]:
        """The full deterministic sleep schedule (attempts - 1 entries: no
        sleep follows the final attempt)."""
        return [self.delay(k) for k in range(self.attempts - 1)]


class RetriesExhausted(ConnectionError):
    """Every attempt in the backoff schedule failed; carries the last error."""


def connect_with_retry(host: str, port: int, backoff: Backoff, *,
                       timeout: float = 10.0,
                       sleep=time.sleep) -> socket.socket:
    """`socket.create_connection` under the backoff schedule. Retries
    ConnectionRefusedError/timeouts/transient OSErrors; raises
    `RetriesExhausted` (chaining the last failure) once the schedule runs
    out. ``sleep`` is injectable so tests measure the schedule without
    serving real seconds."""
    last: Exception | None = None
    for attempt in range(backoff.attempts):
        try:
            sock = socket.create_connection((host, port), timeout=timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock
        except OSError as e:
            last = e
            if attempt < backoff.attempts - 1:
                sleep(backoff.delay(attempt))
    raise RetriesExhausted(
        f"connect to {host}:{port} failed after {backoff.attempts} attempts"
    ) from last
