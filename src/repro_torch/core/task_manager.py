"""Task Manager — coordinates concurrent federated training tasks (port of
``repro/core/task_manager.py``, line for line: it is pure Python).

Paper component #3: "when multiple model algorithms are being trained
concurrently by the clients, this component coordinates the concurrent
federated model training processes." Round-robin fair-share over registered
tasks with per-task state and status tracking.

Shared-clock mode (DESIGN.md §12): construct the manager with the
platform's `core.simclock.SimClock` and give tasks a ``next_time``
callback — the simulated time their next round would complete (an async
task reports its earliest queued completion,
`BufferedAsyncEngine.next_completion_time`; a sync task reports
``clock.now() + round_duration``, see `async_engine.sync_round_seconds`).
`step_shared_clock` then advances the ONE runnable task that finishes
earliest, so an async task's flushes interleave with sync tasks' rounds in
simulated-time order instead of lockstep round-robin. Each task's
``run_round`` is responsible for advancing the shared clock by the time it
consumed (the async engine does this internally).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable

from repro_torch.core.simclock import SimClock


class TaskStatus(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    PAUSED = "paused"
    DONE = "done"
    FAILED = "failed"


@dataclasses.dataclass
class FederatedTask:
    task_id: str
    arch: str
    total_rounds: int
    run_round: Callable[[int], dict]  # round_idx -> metrics
    rounds_done: int = 0
    status: TaskStatus = TaskStatus.PENDING
    history: list = dataclasses.field(default_factory=list)
    # shared-clock mode: simulated completion time of this task's next
    # round; required on every task once the manager carries a SimClock
    # (step_shared_clock rejects None rather than starve clocked tasks)
    next_time: Callable[[], float] | None = None


class TaskManager:
    def __init__(self, clock: SimClock | None = None):
        self.tasks: dict[str, FederatedTask] = {}
        self.clock = clock

    def register(self, task: FederatedTask) -> None:
        if task.task_id in self.tasks:
            raise ValueError(f"duplicate task id {task.task_id}")
        self.tasks[task.task_id] = task

    def runnable(self) -> list[FederatedTask]:
        return [
            t
            for t in self.tasks.values()
            if t.status in (TaskStatus.PENDING, TaskStatus.RUNNING) and t.rounds_done < t.total_rounds
        ]

    def _advance(self, t: FederatedTask) -> dict[str, dict]:
        """Run one round of one task with the shared status bookkeeping."""
        out = {}
        t.status = TaskStatus.RUNNING
        try:
            metrics = t.run_round(t.rounds_done)
        except Exception as e:  # noqa: BLE001 - platform surface
            t.status = TaskStatus.FAILED
            out[t.task_id] = {"error": str(e)}
            return out
        t.rounds_done += 1
        t.history.append(metrics)
        out[t.task_id] = metrics
        if t.rounds_done >= t.total_rounds:
            t.status = TaskStatus.DONE
        return out

    def step_all(self) -> dict[str, dict]:
        """One fair-share scheduling pass: each runnable task advances one round."""
        out = {}
        for t in self.runnable():
            out.update(self._advance(t))
        return out

    def step_shared_clock(self) -> dict[str, dict]:
        """Advance the one runnable task whose next round completes earliest
        on the shared simulated clock (ties break by task id — the same
        determinism contract as the async engine's event queue).

        Every task needs a ``next_time``: a task without one would report
        "ready now" forever, always undercut the clocked tasks' future
        completion times, and silently serialize the interleave — better to
        fail loudly than to starve the clocked tasks."""
        if self.clock is None:
            raise RuntimeError("step_shared_clock needs a TaskManager(clock=SimClock())")
        cands = self.runnable()
        if not cands:
            return {}
        missing = [t.task_id for t in cands if t.next_time is None]
        if missing:
            raise RuntimeError(
                f"shared-clock scheduling needs next_time on every task; "
                f"missing on {missing} (use step_all for untimed tasks)"
            )
        return self._advance(min(cands, key=lambda t: (t.next_time(), t.task_id)))

    def run_to_completion(self, max_passes: int = 10_000) -> None:
        step = self.step_shared_clock if self.clock is not None else self.step_all
        for _ in range(max_passes):
            if not self.runnable():
                return
            step()
