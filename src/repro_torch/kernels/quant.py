"""Legacy block quantizers K12a/K12b (port of ``repro/kernels/quant.py``).

:func:`quantize` and :func:`dequantize` are the per-leaf int8 transport of
``kernels.ops.quantize_tree`` / ``dequantize_tree``: one flat leaf, one
scale per ``block`` elements, the ragged tail zero-padded for the scale.
They are the row quantizers of ``csrc/row_quant.cu`` at C = 1.
:func:`dequantize_tree` decodes every leaf of a tree (block 1024) with one
launch of that file's tree dequantizer per :data:`TREE_CAPACITY` leaves,
over a table of the leaves' pointers and unit offsets (:func:`tree_launches`
plans it). For tensors on the card they launch the kernels; for tensors on
the CPU they run the plain versions ``kernels.ref.quantize`` /
``dequantize``. A CUDA tensor never takes the plain version: the kernel
launches or the call raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, pack, ref

# leaves one launch of the tree dequantizer takes (csrc/row_quant.cu
# kTreeCapacity: the table of 48-byte rows is a kernel parameter, under 4 KB)
TREE_CAPACITY = 64
# the tree's scale block, which is also the kernel's unit of work
TREE_BLOCK = 1024


class TreeLeaf(ctypes.Structure):
    """One row of the tree dequantizer's table (``csrc/row_quant.cu``
    ``TreeLeaf``)."""
    _fields_ = [("q", ctypes.c_void_p), ("scales", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("unit0", ctypes.c_longlong), ("dtype", ctypes.c_int),
                ("pad", ctypes.c_int)]


def _flat(what: str, x: torch.Tensor) -> None:
    if x.dim() != 1:
        raise ValueError(f"{what} takes a 1-D tensor, got {tuple(x.shape)}")


def quantize(x: torch.Tensor, *, block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N,) f32 -> (q int8 (N,), scales f32 (ceil(N/block),)). Counts its
    CUDA launches in ``quantize.launches``."""
    _flat("quantize", x)
    if x.device.type == "cpu":
        return ref.quantize(x, block)
    q, scales = pack.launch_quantize_rows("quantize", x[None], block)
    quantize.launches += 1
    return q[0], scales[0]


quantize.launches = 0


def dequantize(q: torch.Tensor, scales: torch.Tensor, *, dtype: torch.dtype = torch.float32,
               block: int = 1024) -> torch.Tensor:
    """q (N,) int8, scales (ceil(N/block),) f32 -> (N,) ``q * scale`` in
    ``dtype`` (float32 or bfloat16). Counts its CUDA launches in
    ``dequantize.launches``."""
    _flat("dequantize", q)
    pack.check_dequant_dtype("dequantize", dtype)
    if q.device.type == "cpu":
        return ref.dequantize(q, scales, block, dtype)
    out = pack.launch_dequantize_rows("dequantize", q[None], scales[None], dtype, block)
    dequantize.launches += 1
    return out[0]


dequantize.launches = 0


def tree_launches(ns: list[int], dtypes: list[torch.dtype]) -> list[tuple[list[tuple[int, int, int]], int]]:
    """Plan the tree dequantizer's launches for leaves of ``ns`` elements
    decoded into ``dtypes`` -> one ``(rows, units)`` per launch, each row
    ``(leaf index, dtype code, first unit)``. A leaf takes ceil(n / 1024)
    units (its scale blocks), numbered from 0 in each launch, leaf after
    leaf; an empty leaf takes no row; a launch holds at most
    :data:`TREE_CAPACITY` rows."""
    plan, rows, units = [], [], 0
    for i, (n, dtype) in enumerate(zip(ns, dtypes, strict=True)):
        if n == 0:
            continue
        if len(rows) == TREE_CAPACITY:
            plan.append((rows, units))
            rows, units = [], 0
        rows.append((i, pack.DEQUANT_DTYPES[dtype], units))
        units += -(-n // TREE_BLOCK)
    if rows:
        plan.append((rows, units))
    return plan


def dequantize_tree(qs: list[torch.Tensor], scales: list[torch.Tensor],
                    dtypes: list[torch.dtype]) -> list[torch.Tensor]:
    """Leaves q (n,) int8 with scales (ceil(n/1024),) f32 -> their (n,)
    ``q * scale`` in ``dtypes`` (float32 or bfloat16). On the card one launch
    per :data:`TREE_CAPACITY` non-empty leaves, counted in
    ``dequantize_tree.launches``; on the CPU the plain version per leaf."""
    for q, dtype in zip(qs, dtypes, strict=True):
        _flat("dequantize_tree", q)
        pack.check_dequant_dtype("dequantize_tree", dtype)
    if all(q.device.type == "cpu" for q in qs):
        return [ref.dequantize(q, s, TREE_BLOCK, dt) for q, s, dt in zip(qs, scales, dtypes, strict=True)]
    device = qs[0].device
    for q, s in zip(qs, scales, strict=True):
        if q.device != device or s.device != device or device.type != "cuda":
            raise ValueError(f"dequantize_tree runs on one cuda device or the cpu, got {q.device} "
                             f"and {s.device}")
        if q.dtype != torch.int8 or s.dtype != torch.float32:
            raise TypeError(f"dequantize_tree takes int8 q and float32 scales, got {q.dtype} "
                            f"and {s.dtype}")
        if s.shape != (-(-q.numel() // TREE_BLOCK),) or not (q.is_contiguous() and s.is_contiguous()):
            raise ValueError(f"dequantize_tree: q {tuple(q.shape)} needs contiguous scales of "
                             f"({-(-q.numel() // TREE_BLOCK)},), got {tuple(s.shape)}")
    plan = tree_launches([q.numel() for q in qs], dtypes)
    outs = [torch.empty(q.numel(), dtype=dt, device=device) for q, dt in zip(qs, dtypes)]
    for rows, units in plan:
        table = (TreeLeaf * len(rows))(*[
            TreeLeaf(qs[i].data_ptr(), scales[i].data_ptr(), outs[i].data_ptr(), qs[i].numel(),
                     unit0, code, 0) for i, code, unit0 in rows])
        _build.launch("dequantize_tree_launch", device, ctypes.addressof(table), len(rows), units)
        dequantize_tree.launches += 1
    return outs


dequantize_tree.launches = 0
