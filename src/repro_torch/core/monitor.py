"""Round-monitoring view (port of ``repro/core/monitor.py``: ``sparkline``,
``top_clients``, ``render_task``; paper Fig. 9, "Monitoring multiple rounds
of federated model training on FedVision").

Renders per-task progress — round, loss sparkline, participation, mAP —
as the text analogue of the platform's dashboard. Per-client detail is
capped at a top-k (``top_clients``). The async, wire, serving and JSON
views belong to later slices.
"""
from __future__ import annotations

from typing import Sequence

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[float], width: int = 32) -> str:
    if not values:
        return ""
    vals = list(values)[-width:]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))] for v in vals)


def top_clients(history, n_clients: int, eval_history=None, k: int = 8) -> list[int]:
    """The k clients worth per-client lines: ranked by the latest
    per-client mAP when evals exist (quality is what the dashboard
    watches), else by participation frequency. O(C log C) host-side once
    per render — never O(C) render/export rows downstream."""
    k = max(0, min(k, n_clients))
    if eval_history:
        per = eval_history[-1].per_client_map
        order = sorted(range(min(n_clients, len(per))), key=lambda c: (-per[c], c))
    else:
        freq = [0] * n_clients
        for r in history:
            for c, w in enumerate(r.weights[:n_clients]):
                if w > 0:
                    freq[c] += 1
        order = sorted(range(n_clients), key=lambda c: (-freq[c], c))
    return order[:k]


def render_task(task_id: str, history, n_clients: int, upload_bytes_per_round: float = 0.0, eval_history=None, top_k: int = 4) -> str:
    if not history:
        return f"[{task_id}] no rounds yet"
    losses = [r.loss for r in history]
    last = history[-1]
    parts = sum(1 for w in last.weights if w > 0)
    lines = [
        f"[{task_id}] round {last.round_idx + 1}/{len(history)} complete",
        f"  loss     {losses[0]:.4f} → {losses[-1]:.4f}   {sparkline(losses)}",
        f"  clients  {parts}/{n_clients} participating   round wall {last.seconds:.2f}s",
    ]
    if eval_history:
        # per-round detection quality (server.evaluate_round trajectory)
        maps = [e.map50 for e in eval_history]
        spread = max(eval_history[-1].per_client_map) - min(eval_history[-1].per_client_map)
        lines.append(
            f"  mAP@0.5  {maps[0]:.3f} → {maps[-1]:.3f}   {sparkline(maps)}"
            f"   client spread {spread:.3f}"
        )
        # top-k per-client trajectories only: the render stays O(k) lines
        for c in top_clients(history, n_clients, eval_history, k=top_k):
            traj = [e.per_client_map[c] for e in eval_history if c < len(e.per_client_map)]
            lines.append(
                f"    client {c:<5d} mAP {traj[-1]:.3f}   {sparkline(traj)}"
            )
    if upload_bytes_per_round:
        lines.append(
            f"  upload   {upload_bytes_per_round / 1e6:.2f} MB/client/round "
            f"({upload_bytes_per_round * parts / 1e6:.2f} MB total)"
        )
    return "\n".join(lines)
