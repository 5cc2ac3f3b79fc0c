"""The port's LM kernels, flash attention (K9) and the Mamba2 SSD chunk scan
(K10), held against the reference.

On the CPU the port's wrappers run their plain versions
(``repro_torch.kernels.ref``); those must match the reference's Pallas
kernels run in interpret mode (``repro.kernels.ops``, 64-row blocks for K9)
at the reference's own tolerances (tests/test_kernels.py): K9 rtol = atol =
2e-4 in float32 and 3e-2 in bfloat16, K10 2e-4 on all four outputs, and the
full SSD (kernel plus the inter-chunk recurrence) 2e-4 against both the
reference's ``ops.ssd_full`` and its plain ``mamba2.ssd_chunked``. The cases
that run the CUDA kernels themselves against their plain versions need a
card and skip without one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.models import mamba2 as jm2
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.models import mamba2 as m2

# (B, H, Hkv, S, hd), causal, window, dtype
FLASH_CASES = [
    ((1, 4, 2, 128, 64), True, 0, "float32"),
    ((2, 4, 2, 128, 32), True, 64, "float32"),
    ((1, 2, 1, 128, 64), False, 0, "float32"),
    ((1, 2, 2, 128, 128), True, 0, "float32"),
    ((1, 4, 1, 192, 64), True, 128, "float32"),
    ((1, 4, 2, 128, 64), True, 0, "bfloat16"),
    ((1, 2, 2, 128, 32), False, 64, "bfloat16"),
]
# (B, S, H, P, N, Q): the reference test's shapes and the reduced mamba2's
SSD_CASES = [(1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16), (1, 128, 1, 64, 16, 32),
             (2, 128, 16, 32, 16, 8)]
TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _arr(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _flash_inputs(shape, dtype, seed=0):
    B, H, Hkv, S, hd = shape
    rng = np.random.default_rng(seed)
    q, k, v = _arr(rng, (B, H, S, hd)), _arr(rng, (B, Hkv, S, hd)), _arr(rng, (B, Hkv, S, hd))
    if dtype == "bfloat16":  # round once, so both packages read the same bf16 values
        q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v))
    return q, k, v


@pytest.mark.parametrize("shape,causal,window,dtype", FLASH_CASES)
def test_flash_attention_plain_matches_reference_kernel(shape, causal, window, dtype):
    q, k, v = _flash_inputs(shape, dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jops.flash_attention(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                                causal=causal, window=window, block_q=64, block_k=64)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)  # CPU: the plain version
    forced = ops.flash_attention(tq, tk, tv, causal=causal, window=window, impl="ref")
    assert got.dtype == td and got.shape == tq.shape
    assert torch.equal(got, forced)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_flash_attention_wrapper_counts_no_cpu_launch_and_rejects_other_devices():
    q = torch.zeros((1, 2, 64, 16))
    before = kflash.flash_attention.launches
    ops.flash_attention(q, q, q)
    assert kflash.flash_attention.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        kflash.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, q, q, impl="pallas")


@pytest.mark.parametrize("B,S,H,P,N,Q", SSD_CASES)
def test_ssd_chunk_scan_plain_matches_reference_kernel(B, S, H, P, N, Q):
    rng = np.random.default_rng(S + H)
    xdt, dA = _arr(rng, (B, S, H, P), 0.1), -np.abs(_arr(rng, (B, S, H), 0.1))
    Bm, Cm = _arr(rng, (B, S, N)), _arr(rng, (B, S, N))
    want = jops.ssd_chunk_scan(*(jnp.asarray(a) for a in (xdt, dA, Bm, Cm)), chunk=Q)
    t = [torch.from_numpy(a) for a in (xdt, dA, Bm, Cm)]
    got = ops.ssd_chunk_scan(*t, chunk=Q)
    forced = ops.ssd_chunk_scan(*t, chunk=Q, impl="ref")
    nc = S // Q
    shapes = [(B, S, H, P), (B, nc, H, P, N), (B, nc, H), (B, S, H)]
    for g, f, w, shp in zip(got, forced, want, shapes):
        assert g.dtype == torch.float32 and tuple(g.shape) == shp
        assert torch.equal(g, f)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,S,H,P,N,Q", SSD_CASES)
def test_ssd_full_matches_reference_full_and_chunked(B, S, H, P, N, Q):
    rng = np.random.default_rng(S * H)
    xdt, dA = _arr(rng, (B, S, H, P), 0.1), -np.abs(_arr(rng, (B, S, H), 0.1))
    Bm, Cm = _arr(rng, (B, S, N)), _arr(rng, (B, S, N))
    j = [jnp.asarray(a) for a in (xdt, dA, Bm, Cm)]
    y_k, st_k = jops.ssd_full(*j, chunk=Q)
    y_r, st_r = jm2.ssd_chunked(*j, Q)
    t = [torch.from_numpy(a) for a in (xdt, dA, Bm, Cm)]
    y, st = ops.ssd_full(*t, chunk=Q)
    y_c, st_c = m2.ssd_chunked(*t, Q)
    for got in ((y, st), (y_c, st_c)):
        for g, a, b in zip(got, (y_k, st_k), (y_r, st_r)):
            np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(g.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)


def test_ssd_chunk_scan_rejects_ragged_and_foreign_operands():
    x = torch.zeros((1, 12, 2, 4))
    dA, Bm = torch.zeros((1, 12, 2)), torch.zeros((1, 12, 3))
    with pytest.raises(ValueError, match="multiple of chunk"):
        kssd.ssd_chunk_scan(x, dA, Bm, Bm, chunk=8)
    with pytest.raises(ValueError, match="expected"):
        kssd.ssd_chunk_scan(x, dA[:, :4], Bm, Bm, chunk=4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kssd.ssd_chunk_scan(*(t.to("meta") for t in (x, dA, Bm, Bm)), chunk=4)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,dtype", FLASH_CASES)
def test_cuda_flash_attention_matches_plain_on_card(shape, causal, window, dtype):
    dev = _card()
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dev, td) for a in _flash_inputs(shape, dtype))
    before = kflash.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ops.flash_attention(q, k, v, causal=causal, window=window, impl="ref")
    torch.cuda.synchronize()
    assert kflash.flash_attention.launches == before + 1 and got.dtype == td
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,Q", SSD_CASES)
def test_cuda_ssd_chunk_scan_matches_plain_on_card(B, S, H, P, N, Q):
    dev = _card()
    rng = np.random.default_rng(S + H)
    t = [torch.from_numpy(a).to(dev) for a in (
        _arr(rng, (B, S, H, P), 0.1), -np.abs(_arr(rng, (B, S, H), 0.1)),
        _arr(rng, (B, S, N)), _arr(rng, (B, S, N)))]
    before = kssd.ssd_chunk_scan.launches
    got = ops.ssd_chunk_scan(*t, chunk=Q)
    want = ops.ssd_chunk_scan(*t, chunk=Q, impl="ref")
    torch.cuda.synchronize()
    assert kssd.ssd_chunk_scan.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)
