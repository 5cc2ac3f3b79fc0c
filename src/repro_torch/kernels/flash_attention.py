"""Flash attention, forward (port of ``repro/kernels/flash_attention.py``, K9).

:func:`flash_attention` is the prefill's causal GQA attention under
``attention_impl="kernel"`` (``models.attention.attention_block``). For
tensors on the card it launches the hand-written CUDA kernel
``csrc/flash_attention.cu``; for tensors on the CPU it runs the plain
version ``kernels.ref.flash_attention``. A CUDA tensor never takes the plain
version: the kernel launches or the call raises. On the ``meta`` device (the
launch plans' dry-run) it returns an empty output of the kernel's shape and
dtype and launches nothing; on the card and on ``meta`` it reports its work
to the op counter (``kernels.costs``). The kernel reads q, k and v
through their strides, so the model's (B, S, H, hd) projections need no
copy, and it writes a (B, S, H, hd) buffer returned as its (B, H, S, hd)
view. Like the TPU kernel it is a forward pass only; training reaches it
through ``kernels.ops.flash_attention_trainable``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, costs, ref

BLOCK = 64  # key rows per tile of the CUDA kernel; S must be a multiple
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every (batch, head, position) row of ``t`` starts 16-byte aligned, as
    the kernel's 16-byte loads and ``cp.async`` copies need."""
    return t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q (B, H, S, hd), k/v (B, Hkv, S, hd), float32 or bfloat16 (one dtype)
    -> (B, H, S, hd) in q's dtype. On the card S must be a multiple of 64 and
    hd a multiple of 16 up to 128. Counts its CUDA launches in
    ``flash_attention.launches``. A forward pass: under grad it raises
    (``kernels.ops.flash_attention_trainable`` is the training form)."""
    _build.forward_only("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal, window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta tensors, not {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, H, S, hd) and k, v (B, Hkv, S, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != hd or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not pair as GQA heads")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if S % BLOCK or hd % 16 or hd > 128 or B > 65535 or H > 65535:
        raise ValueError(f"the kernel needs S % {BLOCK} == 0 and hd a multiple of 16 up to 128, "
                         f"got S={S}, hd={hd}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    costs.report("flash_attention", *costs.flash_attention(B, H, Hkv, S, hd, causal, window,
                                                           q.element_size()),
                 "tf32x3" if q.dtype == torch.float32 else "bf16")
    if q.device.type == "meta":
        return torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    q, k, v = (t if t.stride(-1) == 1 and _rows_aligned(t)
               else t.clone(memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    _build.launch("flash_attention_launch", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), DTYPES[q.dtype], B, H, Hkv, S, hd, strides, int(causal),
                  int(window), 1.0 / (hd ** 0.5))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
