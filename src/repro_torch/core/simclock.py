"""SimClock — the platform's shared simulated wall clock (DESIGN.md §12).

A copy of ``repro/core/simclock.py`` (pure Python; the port never imports
the JAX package).

One monotonic simulated-seconds counter shared by everything that models
time: the async round engine's event queue (`core.async_engine`), the
Explorer's load process (`explorer.ClientLoadModel.step(dt)` — AR(1) drift
and spike *durations* are measured in simulated seconds, not step counts),
and the Task Manager's shared-clock interleaving of concurrent tasks.

The clock is deliberately dumb: it only moves forward, and it never reads
host time. Everything observable about the async engine (event order,
staleness, time-to-loss benches) is a deterministic function of the seeds
and this counter, so simulations replay exactly.
"""
from __future__ import annotations


class SimClock:
    """Monotonic simulated wall clock, in seconds."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        """Move `dt` simulated seconds forward; returns the new time."""
        if dt < 0:
            raise ValueError(f"SimClock cannot go backwards (dt={dt})")
        self._t += dt
        return self._t

    def advance_to(self, t: float) -> float:
        """Jump to absolute simulated time `t` (>= now); returns elapsed dt."""
        dt = t - self._t
        if dt < -1e-12:
            raise ValueError(
                f"SimClock cannot go backwards (now={self._t}, target={t})"
            )
        dt = max(dt, 0.0)
        self._t = t if dt else self._t
        return dt

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SimClock(t={self._t:.3f})"


class WallClock(SimClock):
    """SimClock slaved to the host's monotonic clock (DESIGN.md §14).

    The wire transport's landing loop runs in real time, but the arrival
    engine speaks the SimClock interface — `sync()` pulls the clock forward
    to ``monotonic() - t0`` (relative seconds since construction) and
    returns it. Times read off a WallClock are what a wire run records into
    its arrival schedule; replaying advances a plain SimClock to those same
    stamps, so a recorded run and its replay agree on every ``sim_time``.
    Only `sync` reads host time; between syncs the clock is as dumb and
    monotonic as its parent.

    A recovered server passes ``start=`` (the snapshot's clock time) so the
    resumed run's recorded times continue monotonically from where the
    crashed run stopped — the combined pre-crash + post-restore schedule
    must still be a valid (monotonic) `ArrivalSchedule`.
    """

    def __init__(self, start: float = 0.0):
        import time

        super().__init__(start)
        self._mono = time.monotonic
        self._t0 = self._mono() - start

    def sync(self) -> float:
        """Advance to now (relative host seconds); returns the new time.
        Only the landing loop — the single engine-owning thread — may call
        this; concurrent syncs could race the monotonicity check."""
        t = self._mono() - self._t0
        if t > self.now():
            self.advance_to(t)
        return self.now()

    def peek(self) -> float:
        """Relative host seconds WITHOUT advancing the clock — safe from
        any thread (reader threads stamp `last_seen` with this)."""
        return max(self.now(), self._mono() - self._t0)
