"""Task Scheduler — load-balancing client selection (Yu et al. 2017 style);
a NumPy copy of ``repro/core/scheduler.py``: the same reports give the same
selections.

The paper: "The load-balancing approach ... jointly considers clients' local
model quality and the current load on their local computational resources in
an effort to maximize the quality of the resulting federated model."

We implement that as per-round selection maximizing
    score_i = alpha * quality_i - beta * load_i
subject to a participation budget, with a fairness floor so starved clients
eventually re-enter (their data would otherwise never contribute). Quality
is an EMA of each client's local loss improvement; load comes from Explorer
reports (`core.explorer.ClientLoadModel` in the simulated platform).

:meth:`TaskScheduler.participation` is the engine-facing output: a 0/1 mask,
the Eq. 5 weight vector, and (under a static budget) the compact index
vector — exactly the `rounds.participation_input` operands.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SchedulerConfig:
    alpha: float = 1.0  # quality weight
    beta: float = 0.5  # load penalty
    max_participants: int = 0  # 0 -> all
    fairness_rounds: int = 4  # force-include clients idle this many rounds
    quality_ema: float = 0.8


class TaskScheduler:
    def __init__(self, n_clients: int, config: SchedulerConfig | None = None):
        self.cfg = config or SchedulerConfig()
        self.n = n_clients
        self.quality = np.zeros(n_clients)  # EMA of loss/eval improvement
        self.last_loss = np.full(n_clients, np.nan)
        self.last_eval = np.full(n_clients, np.nan)
        self.idle_rounds = np.zeros(n_clients, int)

    def report_quality(self, client: int, loss: float) -> None:
        prev = self.last_loss[client]
        improvement = 0.0 if np.isnan(prev) else prev - loss
        e = self.cfg.quality_ema
        self.quality[client] = e * self.quality[client] + (1 - e) * improvement
        self.last_loss[client] = loss

    def report_eval(self, client: int, score: float) -> None:
        """Task-metric quality signal, higher-is-better (e.g. the client's
        mAP@0.5 from `server.evaluate_round`). Mirrors report_quality: the
        quality EMA tracks the *improvement* of the score, so a client
        whose detection quality is climbing outranks one that plateaued —
        loss- and eval-derived signals share one EMA and are comparable.
        """
        prev = self.last_eval[client]
        improvement = 0.0 if np.isnan(prev) else score - prev
        e = self.cfg.quality_ema
        self.quality[client] = e * self.quality[client] + (1 - e) * improvement
        self.last_eval[client] = score

    def participation(self, loads: np.ndarray, k_static: int | None = None) -> dict[str, np.ndarray]:
        """One round of selection. loads: (n,) in [0,1] from the Explorer.

        Returns {"mask": (n,) f32 0/1, "weights": (n,) f32 summing to 1 over
        participants, ["idx": (k_static,) int32]}.

        Without ``k_static`` the participant count is dynamic: the top
        ``max_participants`` by score, *plus* every client whose idle streak
        hit the fairness floor. With ``k_static`` (compact rounds need a
        static shape) exactly k_static clients are returned and the fairness
        floor *preempts* the budget instead of growing it: longest-idle
        floored clients claim slots first, best-scoring clients fill the
        rest.
        """
        loads = np.asarray(loads, float)
        score = self.cfg.alpha * self.quality - self.cfg.beta * loads
        order = np.argsort(-score)
        floored = [i for i in range(self.n) if self.idle_rounds[i] >= self.cfg.fairness_rounds]
        if k_static is None:
            k = min(self.cfg.max_participants or self.n, self.n)
            chosen = set(order[:k].tolist())
            chosen.update(floored)
        else:
            k = min(k_static, self.n)
            picked = sorted(floored, key=lambda i: (-self.idle_rounds[i], i))[:k]
            for i in order:
                if len(picked) >= k:
                    break
                if i not in picked:
                    picked.append(int(i))
            chosen = set(picked)
        mask = np.zeros(self.n, np.float32)
        mask[list(chosen)] = 1.0
        for i in range(self.n):
            self.idle_rounds[i] = 0 if mask[i] else self.idle_rounds[i] + 1
        total = float(mask.sum())
        weights = mask.astype(float) / total if total else np.full(self.n, 1.0 / self.n)
        out = {"mask": mask, "weights": weights}
        if k_static is not None:
            out["idx"] = np.asarray(sorted(chosen), np.int32)
        return out

    def select(self, loads: np.ndarray) -> np.ndarray:
        """loads: (n,) in [0,1] from Explorer. Returns weights (n,), sum 1.

        The weights-only form; the round engine consumes
        :meth:`participation`'s mask and weights.
        """
        return self.participation(loads)["weights"].astype(float)
