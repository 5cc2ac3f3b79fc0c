"""Plain reference of a federated round (frozen copies, plain PyTorch f32):
each client's local steps (its loss and gradient over its own row, then the
mix's optimizer), then the mix's aggregate. The model family's loss, the
optimizer and the aggregate are each a module of their own, found by name:
``portbench/reference/<family>.py``, ``optim/<name>.py``, ``agg/<name>.py``.

``follow`` runs the first rounds of a cell from the benchmark's initial row
and batches and returns what the check compares: each round's loss, each
client's first update per leaf, and the parameters' change per leaf.
"""
from __future__ import annotations

import contextlib
import importlib

import torch

from portbench import weights
from portbench.reference import layout


def views(row: torch.Tensor, leaves: list[layout.Leaf]) -> dict[str, torch.Tensor]:
    parts = torch.split(row, [leaf.size for leaf in leaves])
    return {leaf.name: part.view(leaf.shape) for leaf, part in zip(leaves, parts)}


def grad(family: str, row: torch.Tensor, leaves, batch: dict, sizes: dict):
    """(loss, gradient as one row) of one step at ``row``."""
    flat = row.detach().requires_grad_(True)
    loss = layout.family(family).loss(views(flat, leaves), batch, sizes)
    (g,) = torch.autograd.grad(loss, flat)
    return loss.detach(), g


def make_optimizer(opt: dict):
    """The mix's optimizer, ``portbench/reference/optim/<name>.py``, found by
    name."""
    kw = {k: v for k, v in opt.items() if k != "name"}
    return importlib.import_module(f"portbench.reference.optim.{opt['name']}").Optimizer(**kw)


def _half(batch):
    """The first half of a batch's samples."""
    if isinstance(batch, dict):
        return {k: _half(v) for k, v in batch.items()}
    if isinstance(batch, list):
        return [_half(v) for v in batch]
    return batch[: batch.shape[0] // 2]


def _pick(batch, c: int, e: int):
    if isinstance(batch, dict):
        return {k: _pick(v, c, e) for k, v in batch.items()}
    if isinstance(batch, list):
        return [_pick(v, c, e) for v in batch]
    return batch[c, e]


@contextlib.contextmanager
def precision(mode: str, device):
    """``"f32"``: f32 products with TF32 off (the configurations'
    precision); ``"tf32"``: TF32 on (the control's, the nearest precision
    below, on the card); ``"bf16"``: products autocast to bfloat16 (the
    control where no TF32 exists, the CPU)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        with torch.autocast(torch.device(device).type, dtype=torch.bfloat16,
                            enabled=mode == "bf16"):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def follow(family: str, sizes: dict, mix: dict, batches: list[dict], seed: int, device, *,
           mode: str = "f32", fault: str | None = None) -> dict:
    """Run ``len(batches)`` rounds of the cell from the initial row of
    ``seed``. -> {"loss": [per round], "first_update": (C, L) norms of each
    client's first update per leaf, "first_change" and "change": (L,) norms
    of the parameters' change per leaf over all rows after the first round
    and after the last}, host f64 tensors. ``mode``:
    the precision of the products (:func:`precision`). ``fault="half_batch"``: every step sees the first half of its batch
    only, as a program that dropped half of it would."""
    leaves = layout.leaves_of(family, sizes)
    C, E = mix["clients"], mix["local_steps"]
    losses, first = [], None
    with precision(mode, device):
        r0 = weights.initial_row(leaves, seed, device)
        rows = [r0] + [r0.clone() for _ in range(C - 1)]
        opts = [make_optimizer(mix["optimizer"]) for _ in range(C)]
        agg = importlib.import_module(f"portbench.reference.agg.{mix['agg']}")
        agg_state = agg.init(r0, leaves, sizes, C)
        for r, batch in enumerate(batches):
            client_loss = []
            for c in range(C):
                step_losses = []
                for e in range(E):
                    b = _pick(batch, c, e)
                    loss, g = grad(family, rows[c], leaves,
                                   _half(b) if fault == "half_batch" else b, sizes)
                    with torch.no_grad():
                        u = opts[c].step(rows[c], g)
                    if r == 0 and e == 0:
                        norms = leaf_norms(u[None], leaves)
                        first = norms if first is None else torch.cat([first, norms])
                    step_losses.append(loss)
                    del g, u
                client_loss.append(torch.stack(step_losses).mean())
            losses.append(float(torch.stack(client_loss).mean()))
            with torch.no_grad():
                agg_state = agg.aggregate(rows, agg_state, leaves, sizes, mix)
                if r == 0:
                    first_change = weights.change_norms(_Rows(rows), leaves, seed)
        change = weights.change_norms(_Rows(rows), leaves, seed)
    return {"loss": torch.tensor(losses, dtype=torch.float64), "first_update": first,
            "first_change": first_change, "change": change}


class _Rows:
    """``rows[:, lo:hi]`` over a list of rows, without stacking them."""

    def __init__(self, rows: list[torch.Tensor]):
        self.rows, self.device = rows, rows[0].device

    def __getitem__(self, idx):
        _, cols = idx
        return torch.stack([r[cols] for r in self.rows])


def leaf_norms(rows: torch.Tensor, leaves) -> torch.Tensor:
    """(R, N) -> (R, L) f64 norms of each row's segment of each leaf."""
    return torch.stack([torch.linalg.vector_norm(rows[:, leaf.offset:leaf.offset + leaf.size],
                                                 dim=1) for leaf in leaves], dim=1).double().cpu()
