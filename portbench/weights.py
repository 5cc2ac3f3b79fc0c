"""The initial global row, drawn from the run's seed on the device.

Every leaf is drawn in blocks of ``BLOCK`` elements, each block from a
generator of its own whose seed mixes the run's seed, the leaf and the
block. So the row is made in a few large calls, and any block of it can be
drawn again alone: the readings of the parameters' change and the plain
reference regenerate the row block by block instead of holding a second
copy of it.
"""
from __future__ import annotations

import torch

from portbench.reference.layout import Leaf

BLOCK = 1 << 26  # elements a draw: 256 MiB of f32


def _block_seed(seed: int, leaf: int, block: int) -> int:
    return (seed * 1_000_003 + leaf * 65_537 + block) % (1 << 63)


def blocks(leaves: list[Leaf]):
    """(leaf index, leaf, block index, start, stop) over the row, ``start``
    and ``stop`` counted in the row."""
    for j, leaf in enumerate(leaves):
        for k, lo in enumerate(range(0, leaf.size, BLOCK)):
            yield j, leaf, k, leaf.offset + lo, leaf.offset + min(lo + BLOCK, leaf.size)


def fill_block(out: torch.Tensor, seed: int, j: int, leaf: Leaf, k: int) -> torch.Tensor:
    """Draw block ``k`` of leaf ``j`` into ``out`` (a 1-D f32 tensor)."""
    if leaf.init == "zeros":
        return out.zero_()
    if leaf.init == "ones":
        return out.fill_(1.0)
    gen = torch.Generator(device=out.device).manual_seed(_block_seed(seed, j, k))
    torch.randn(out.shape, generator=gen, out=out)
    return out.mul_(leaf.std)


def fill_row(row: torch.Tensor, leaves: list[Leaf], seed: int) -> torch.Tensor:
    """Draw the whole (N,) row in place."""
    for j, leaf, k, lo, hi in blocks(leaves):
        fill_block(row[lo:hi], seed, j, leaf, k)
    return row


def initial_row(leaves: list[Leaf], seed: int, device) -> torch.Tensor:
    n = leaves[-1].offset + leaves[-1].size
    return fill_row(torch.empty(n, dtype=torch.float32, device=device), leaves, seed)


def change_norms(rows: torch.Tensor, leaves: list[Leaf], seed: int) -> torch.Tensor:
    """Per leaf, the L2 norm over all rows of ``rows - initial row``: the
    parameters' change since the start, (L,) f64 on the host. The initial
    row is drawn again block by block."""
    sq = torch.zeros(len(leaves), dtype=torch.float64, device=rows.device)
    for j, leaf, k, lo, hi in blocks(leaves):
        r0 = fill_block(torch.empty(hi - lo, dtype=torch.float32, device=rows.device), seed, j,
                        leaf, k)
        sq[j] += torch.linalg.vector_norm(rows[:, lo:hi] - r0).double() ** 2
        del r0
    return sq.sqrt().cpu()
