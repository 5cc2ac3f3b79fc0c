"""Mamba2 SSD intra-chunk block (port of ``repro/kernels/ssd_scan.py``, K10).

:func:`ssd_chunk_scan` is the prefill's intra-chunk pass under
``ssm_impl="kernel"`` (``models.mamba2.mamba2_block`` through
``kernels.ops.ssd_full``). For tensors on the card it launches the
hand-written CUDA kernel ``csrc/ssd_scan.cu``; for tensors on the CPU it runs
the plain version ``kernels.ref.ssd_chunk_scan``. A CUDA tensor never takes
the plain version: the kernel launches or the call raises. On the ``meta``
device (the launch plans' dry-run) it returns empty outputs of the kernel's
shapes and launches nothing; on the card and on ``meta`` it reports its work
to the op counter (``kernels.costs``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs, ref

MAX_DIM = 128  # the kernel's bound on the chunk, state and head widths
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_chunk_scan(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
                   chunk: int = 128):
    """xdt (B, S, H, P), dA (B, S, H), Bm/Cm (B, S, N), S % chunk == 0 ->
    float32 (y_diag (B, S, H, P), states (B, nc, H, P, N), chunk_decay (B,
    nc, H), exp_cum (B, S, H)). On the card chunk, N and P are at most 128;
    xdt, Bm and Cm of mixed dtypes are read as float32 (as the TPU kernel
    reads every operand). Counts its CUDA launches in
    ``ssd_chunk_scan.launches``. A forward pass: under grad it raises
    (``kernels.ops.ssd_full_trainable`` is the training form)."""
    _build.forward_only("ssd_chunk_scan", xdt, dA, Bm, Cm)
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    if dA.shape != (B, S, H) or Bm.shape != (B, S, N) or Cm.shape != (B, S, N):
        raise ValueError(f"expected xdt (B, S, H, P), dA (B, S, H), Bm/Cm (B, S, N), got "
                         f"{tuple(xdt.shape)}, {tuple(dA.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    if xdt.device.type == "cpu":
        return ref.ssd_chunk_scan(xdt, dA, Bm, Cm, chunk)
    if xdt.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_chunk_scan runs on cuda, cpu or meta tensors, not {xdt.device}")
    if any(t.device != xdt.device for t in (dA, Bm, Cm)):
        raise ValueError("xdt, dA, Bm and Cm must be on one device")
    if max(chunk, N, P) > MAX_DIM or B > 65535 or H > 65535:
        raise ValueError(f"the kernel takes chunk, N and P up to {MAX_DIM}, got {chunk}, {N}, {P}")
    dtype = xdt.dtype if xdt.dtype == Bm.dtype == Cm.dtype else torch.float32
    if dtype not in DTYPES:
        raise TypeError(f"ssd_chunk_scan takes float32 or bfloat16 operands, got {dtype}")
    esize = torch.empty((), dtype=dtype).element_size()
    costs.report("ssd_chunk_scan", *costs.ssd_chunk_scan(B, S, H, P, N, chunk, esize),
                 "tf32x3" if dtype == torch.float32 else "bf16")
    nc = S // chunk
    f32 = dict(dtype=torch.float32, device=xdt.device)
    if xdt.device.type == "meta":
        return (torch.empty((B, S, H, P), **f32), torch.empty((B, nc, H, P, N), **f32),
                torch.empty((B, nc, H), **f32), torch.empty((B, S, H), **f32))
    # contiguous and 16-byte aligned, as the kernel's cp.async copies need
    xdt, Bm, Cm = (t.to(dtype).contiguous() for t in (xdt, Bm, Cm))
    xdt, Bm, Cm = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (xdt, Bm, Cm))
    dA = dA.float().contiguous()
    y = torch.empty((B, S, H, P), **f32)
    states = torch.empty((B, nc, H, P, N), **f32)
    decay = torch.empty((B, nc, H), **f32)
    exp_cum = torch.empty((B, S, H), **f32)
    _build.launch("ssd_chunk_scan_launch", xdt.device, xdt.data_ptr(), dA.data_ptr(),
                  Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), states.data_ptr(), decay.data_ptr(),
                  exp_cum.data_ptr(), DTYPES[dtype], B, S, H, P, N, chunk)
    ssd_chunk_scan.launches += 1
    return y, states, decay, exp_cum


ssd_chunk_scan.launches = 0
