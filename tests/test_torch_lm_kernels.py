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

The CUDA kernels run their products on the tensor cores through a 3xTF32
split (``csrc/mma_tf32.cuh``). The precision tests emulate it here: each
f32 operand a becomes hi = a rounded to tf32 (to nearest, ties away, as
``cvt.rna.tf32.f32`` rounds: add 0x1000 to the bit pattern, clear the low
13 bits) and lo = a - hi, read by the tensor core truncated to tf32 (or,
as a second case, rounded like hi); a.b is summed in f32 as lo.hi' + hi.lo'
+ hi.hi'. The plain K9 and K10 arithmetic on split operands, at full
hd = 128 and Q = N = 128, must hold 2e-4 against the f32 plain versions and
the reference's own ``repro.kernels.ref``; single-pass TF32 is recorded
beside it (``record_property``), not asserted.
"""
import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
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


class _ForeignDevice(torch.Tensor):
    """A host tensor that reports a device the kernel wrappers do not serve."""

    @property
    def device(self):
        return torch.device("xpu")


def test_flash_attention_wrapper_counts_no_cpu_launch_and_rejects_other_devices():
    q = torch.zeros((1, 2, 64, 16))
    before = kflash.flash_attention.launches
    ops.flash_attention(q, q, q)
    m = q.to("meta")  # the launch plans' dry-run: the output's shape, no launch
    out = kflash.flash_attention(m, m, m)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
    assert kflash.flash_attention.launches == before
    f = q.as_subclass(_ForeignDevice)
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        kflash.flash_attention(f, f, f)
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
    before = kssd.ssd_chunk_scan.launches
    got = kssd.ssd_chunk_scan(*(t.to("meta") for t in (x, dA, Bm, Bm)), chunk=4)
    assert [tuple(t.shape) for t in got] == [(1, 12, 2, 4), (1, 3, 2, 4, 3), (1, 3, 2), (1, 12, 2)]
    assert kssd.ssd_chunk_scan.launches == before  # meta launches nothing
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        kssd.ssd_chunk_scan(*(t.as_subclass(_ForeignDevice) for t in (x, dA, Bm, Bm)), chunk=4)


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


# --- the 3xTF32 precision decision, emulated on the CPU -------------------

def _tf32(a, rounding="rna"):
    """a (f32) as tf32: rounded to nearest, ties away ("rna": add 0x1000 to
    the bit pattern, clear the low 13 bits), or truncated ("rz")."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    if rounding == "rna":
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul(a, b, passes, lo_rounding):
    """a @ b (f32) as the tensor cores compute it: one tf32 pass, or the
    3xTF32 split lo.hi' + hi.lo' + hi.hi' with f32 sums."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah, lo_rounding), _tf32(b - bh, lo_rounding)
    return (al @ bh + ah @ bl) + ah @ bh


def _flash_tc(q, k, v, causal, window, passes, lo_rounding):
    """K9's arithmetic with its two products on the emulated tensor cores:
    q scaled by 1/sqrt(hd) when staged, masked scores -1e30, p = exp(s - m)
    zeroed where masked, out = (p v) / sum(p)."""
    B, H, S, hd = q.shape
    group = H // k.shape[1]
    pos = np.arange(S)
    vis = np.ones((S, S), bool)
    if causal:
        vis &= pos[:, None] >= pos[None, :]
    if window:
        vis &= pos[:, None] - pos[None, :] < window
    out = np.empty_like(q)
    for b in range(B):
        for h in range(H):
            qs = q[b, h] * np.float32(1.0 / np.sqrt(hd))
            s = np.where(vis, _matmul(qs, k[b, h // group].T, passes, lo_rounding), np.float32(-1e30))
            p = np.where(vis, np.exp(s - s.max(-1, keepdims=True)), np.float32(0.0))
            out[b, h] = _matmul(p, v[b, h // group], passes, lo_rounding) / p.sum(-1, keepdims=True)
    return out


def _ssd_tc(xdt, dA, Bm, Cm, Q, passes, lo_rounding):
    """K10's arithmetic (y_diag, states) with its three products on the
    emulated tensor cores: G = C B^T, y = (G * L) xdt, states = (xdt * decay)^T B."""
    B, S, H, P = xdt.shape
    y = np.empty_like(xdt)
    states = np.empty((B, S // Q, H, P, Bm.shape[-1]), np.float32)
    for b in range(B):
        for c in range(S // Q):
            rows = slice(c * Q, (c + 1) * Q)
            G = _matmul(Cm[b, rows], Bm[b, rows].T, passes, lo_rounding)
            for h in range(H):
                cum = np.cumsum(dA[b, rows, h], dtype=np.float32)
                L = np.where(np.tri(Q, dtype=bool), np.exp(cum[:, None] - cum[None, :]), np.float32(0))
                x = xdt[b, rows, h]
                y[b, rows, h] = _matmul(G * L, x, passes, lo_rounding)
                dec = np.exp(cum[-1] - cum)
                states[b, c, h] = _matmul((x * dec[:, None]).T, Bm[b, rows], passes, lo_rounding)
    return y, states


@pytest.mark.parametrize("lo_rounding", ["rz", "rna"])
def test_flash_attention_3xtf32_split_holds_the_f32_tolerance(lo_rounding, record_property):
    q, k, v = _flash_inputs((1, 2, 1, 256, 128), "float32", seed=3)
    want = ref.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), True, 0).numpy()
    want_jax = np.asarray(jref.flash_attention(*(jnp.asarray(a) for a in (q, k, v))))
    got = _flash_tc(q, k, v, True, 0, 3, lo_rounding)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want_jax, rtol=2e-4, atol=2e-4)
    one = _flash_tc(q, k, v, True, 0, 1, lo_rounding)
    record_property("max_abs_err_3xtf32", float(np.abs(got - want).max()))
    record_property("max_abs_err_tf32_single_pass", float(np.abs(one - want).max()))


@pytest.mark.parametrize("lo_rounding", ["rz", "rna"])
def test_ssd_chunk_scan_3xtf32_split_holds_the_f32_tolerance(lo_rounding, record_property):
    B, S, H, P, N, Q = 1, 256, 2, 64, 128, 128
    rng = np.random.default_rng(7)
    xdt, dA = _arr(rng, (B, S, H, P), 0.1), -np.abs(_arr(rng, (B, S, H), 0.1))
    Bm, Cm = _arr(rng, (B, S, N)), _arr(rng, (B, S, N))
    want = ref.ssd_chunk_scan(*(torch.from_numpy(a) for a in (xdt, dA, Bm, Cm)), Q)
    got = _ssd_tc(xdt, dA, Bm, Cm, Q, 3, lo_rounding)
    for g, w in zip(got, want[:2]):
        np.testing.assert_allclose(g, w.numpy(), rtol=2e-4, atol=2e-4)
    for c in range(S // Q):
        rows = slice(c * Q, (c + 1) * Q)
        y_j, st_j, _ = jref.ssd_chunk(*(jnp.asarray(a[0, rows]) for a in (xdt, dA, Bm, Cm)))
        np.testing.assert_allclose(got[0][0, rows], np.asarray(y_j), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got[1][0, c], np.asarray(st_j), rtol=2e-4, atol=2e-4)
    one = _ssd_tc(xdt, dA, Bm, Cm, Q, 1, lo_rounding)
    for name, g, o, w in zip(("y", "states"), got, one, want[:2]):
        record_property(f"{name}_max_abs_err_3xtf32", float(np.abs(g - w.numpy()).max()))
        record_property(f"{name}_max_abs_err_tf32_single_pass", float(np.abs(o - w.numpy()).max()))
