"""The port's compressed, secure and edge-grouped uplink (``repro_torch``:
the counter hash, the fused quant8/quant4 transports K4/K7, the grouped
reduce K6, the masked modular sum K8, and the quant8, quant4, secure,
topk_ef, hier, fedavgm, fedadam and trimmed_mean aggregators) held against
the reference on identical NumPy inputs from ``default_rng``.

Tolerances, each stated where it is used:

- hash bits, integer sums, masks and every plain version's chain against
  the reference's jnp twin of the same chain: bitwise;
- K7's plain version against ``ref.quant4_reduce_np``: equal values, with
  the sign of zero free (the NumPy oracle accumulates from +0.0, the chain
  starts from the first client's product, so -0.0 may come out as +0.0);
- a plain version against the reference's Pallas kernel in interpret mode:
  the reference's own rtol 1e-5 / atol 1e-6 (its kernel sums each client
  block with ``jnp.sum`` in no fixed order);
- two rounds of the flat engine per mode: ``tests/test_torch_aggregation_rounds.py``.
"""
import dataclasses

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.core import packing as jpacking
from repro.core import rounds as jrounds
from repro.kernels import mask as jmask
from repro.kernels import pack as jpack
from repro.kernels import quant4 as jquant4
from repro.kernels import ref as jref
from repro_torch.configs import get_arch
from repro_torch.core import packing, rounds
from repro_torch.core.aggregators import sparse
from repro_torch.kernels import mask as kmask
from repro_torch.kernels import ops
from repro_torch.kernels import pack as kpack
from repro_torch.kernels import quant4 as kquant4
from repro_torch.launch import train
from repro_torch.models import convert

JCFG = dataclasses.replace(jget_arch("fedyolov3").reduced(), d_model=8, n_layers=3)
TCFG = dataclasses.replace(get_arch("fedyolov3").reduced(), d_model=8, n_layers=3)
IMG = 32
# uint32 values at the edges of the ring
EDGES = np.array([0, 1, 2, 0xFFFF, 0x10000, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1,
                  0xDEADBEEF, 0x9E3779B9], np.uint32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _delta(C, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, N)).astype(np.float32)
    x[:, ::97] = 0.0  # exact zeros and whole blocks of small values
    x[0, : min(N, 64)] *= 1e-30
    return x, rng.random(C).astype(np.float32)


# ------------------------------ hash bits -----------------------------------

def test_fmix32_round_key_and_counter_uniform_match_oracles_near_2_32():
    rng = np.random.default_rng(0)
    h = np.concatenate([EDGES, rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)])
    ours = packing.fmix32(t(h.astype(np.int64))).numpy()
    assert np.array_equal(ours, jref.fmix32_np(h).astype(np.int64))
    assert all(packing.fmix32(int(v)) == int(jref.fmix32_np(v)) for v in EDGES)
    for seed in (0, 7, 2 ** 32 - 1, 2 ** 40 + 3):
        for r in (0, 1, 99, 2 ** 31, 2 ** 32 - 1):
            assert packing.round_key(seed, r) == int(jref.round_key_np(seed, r)), (seed, r)
    key = int(jref.round_key_np(3, 4))
    c = EDGES[:, None]
    n = np.concatenate([EDGES, np.arange(64, dtype=np.uint32)])[None, :]
    u = packing.counter_uniform(key, t(c.astype(np.int64)), t(n.astype(np.int64))).numpy()
    assert same_bits(u, jref.counter_uniform_np(key, c, n))
    assert u.dtype == np.float32 and (u >= 0).all() and (u < 1).all()


# ------------------------------ K4 ------------------------------------------

def _hold_pallas(ours, pallas, oracle):
    """The port against the reference's Pallas kernel in interpret mode at its
    rtol 1e-5 / atol 1e-6, except where that kernel misses the reference's
    own oracle (``oracle``, which the caller holds the port to exactly) at
    the same tolerance. Jitted on the CPU, XLA computes one of the kernel's
    divisions as a multiply by the reciprocal, 1 ulp off, which flips an
    x/scale within an ulp of a half step (measured: one element of
    2,265,604 at C = 3, x/s = -4.5000005). At most one element in 10^5 may
    be such a flip, so none in a row shorter than 100,000."""
    pallas = np.asarray(pallas)
    flips = ~np.isclose(pallas, oracle, rtol=1e-5, atol=1e-6)
    assert flips.sum() <= ours.size // 100_000, int(flips.sum())
    np.testing.assert_allclose(ours[~flips], pallas[~flips], rtol=1e-5, atol=1e-6)


# (C, N, block) edges of the card kernel's tiling (csrc/quant_reduce.cu): C = 17,
# N one whole persistent grid stride on an H100 (132 SMs x 16 warps x 1024),
# N with a partial last stride and a partial last block, blocks 4 and 4096
# at C = 1 (the generic kernel)
TILE_STRIDE_N = 132 * kpack.QUANT_TILE_WARPS_PER_SM * kpack.QUANT_TILE_BLOCK
QUANT_EDGES = [(17, 5000, 1024), (3, TILE_STRIDE_N, 1024), (3, TILE_STRIDE_N + 100 * 1024 + 516, 1024),
               (1, 5000, 4), (1, 5003, 4096)]


@pytest.mark.parametrize("C,N,block", [(6, 2500, 256), (3, 5000, 1024), (2, 77, 64), *QUANT_EDGES])
def test_quant8_reduce_plain_version_matches_reference(C, N, block):
    x, w = _delta(C, N, N)
    before = kpack.quant8_reduce.launches
    ours = kpack.quant8_reduce(t(x), t(w), block=block)
    assert kpack.quant8_reduce.launches == before  # the CPU takes the plain version
    twin = np.asarray(jpacking.quant8_mean_ref(jnp.asarray(x), jnp.asarray(w), block))
    assert same_bits(ours.numpy(), twin)
    assert same_bits(packing.quant8_mean_ref(t(x), t(w), block).numpy(), ours.numpy())
    pallas = jpack.quant8_reduce(jnp.asarray(x), jnp.asarray(w), block=block, interpret=True)
    _hold_pallas(ours.numpy(), pallas, twin)


# ------------------------------ K7 ------------------------------------------

@pytest.mark.parametrize("mode", ["nearest", "stochastic"])
@pytest.mark.parametrize("C,N,block", [(6, 2500, 256), (3, 5000, 1024), (2, 77, 64), *QUANT_EDGES])
def test_quant4_reduce_plain_version_matches_reference(C, N, block, mode):
    x, w = _delta(C, N, N + 1)
    key = int(jref.round_key_np(11, 2))
    ours = kquant4.quant4_reduce(t(x), t(w), key, mode=mode, block=block).numpy()
    oracle = jref.quant4_reduce_np(x, w, block, mode=mode, key=key)
    np.testing.assert_array_equal(ours, oracle)  # values; the oracle's zeros are +0.0
    twin = jpacking.quant4_mean_ref(jnp.asarray(x), jnp.asarray(w), block, key=jnp.uint32(key), mode=mode)
    assert same_bits(ours, np.asarray(twin))
    assert same_bits(packing.quant4_mean_ref(t(x), t(w), block, key=key, mode=mode).numpy(), ours)
    pallas = jquant4.quant4_reduce(jnp.asarray(x), jnp.asarray(w), jnp.uint32(key), mode=mode,
                                   block=block, interpret=True)
    _hold_pallas(ours, pallas, oracle)
    # the dequantized rows a client uploads: quant4_blocks_np -> dequant4_blocks_np
    # (through int8, so its zeros are +0.0), and the jnp twin bit for bit
    rows = packing.quant4_dequant_rows_ref(t(x), block, key=key, mode=mode).numpy()
    for c in range(C):
        q, s = jref.quant4_blocks_np(x[c], block, mode=mode, key=key, c=c)
        np.testing.assert_array_equal(rows[c], jref.dequant4_blocks_np(q, s, block)[:N])
    jrows = jpacking.quant4_dequant_rows_ref(jnp.asarray(x), block, key=jnp.uint32(key), mode=mode)
    assert same_bits(rows, np.asarray(jrows))


def test_quant_wrappers_reject_bad_arguments():
    x, w = _delta(2, 16, 0)
    with pytest.raises(ValueError, match="mode"):
        kquant4.quant4_reduce(t(x), t(w), 0, mode="skip")
    with pytest.raises(ValueError, match="uint32"):
        kquant4.quant4_reduce(t(x), t(w), 2 ** 32)
    with pytest.raises(ValueError, match="impl"):
        ops.quant8_reduce(t(x), t(w), impl="pallas")


# ------------------------------ K8 ------------------------------------------

@pytest.mark.parametrize("part", [[1, 1, 1, 1, 1], [1, 0, 1, 1, 0], [0, 0, 1, 0, 0], [0, 0, 0, 0, 0]])
def test_masked_u32_sum_and_secure_masks_match_reference(part):
    part = np.array(part, np.float32)
    rng = np.random.default_rng(int(part.sum()))
    q = rng.integers(-127, 128, (5, 777)).astype(np.int32)
    q[:, :4] = [[127], [-127], [0], [-1], [1]]
    rk = int(jref.round_key_np(9, 4))
    masks = packing.secure_client_masks(rk, t(part), q.shape[1])
    jm = np.asarray(jpacking.secure_client_masks(jnp.uint32(rk), jnp.asarray(part), q.shape[1]))
    assert np.array_equal(masks.numpy(), jm.astype(np.int64))
    masked = np.asarray(jref.secure_masked_rows_np(q, part, rk))
    rows = packing.to_int32_bits((t(q).long() + masks) & packing.U32)
    assert same_bits(rows.numpy()[part > 0], masked[part > 0])
    before = kmask.masked_u32_sum.launches
    total = kmask.masked_u32_sum(rows, t(part)).numpy()
    assert kmask.masked_u32_sum.launches == before
    oracle = jref.secure_sum_np(q, part, rk)
    assert same_bits(total, oracle)
    assert same_bits(total, jref.secure_sum_np(q, part, rk, use_masks=False))  # masks cancel
    assert same_bits(packing.secure_sum_ref(t(q), t(part), rk).numpy(), oracle)
    pallas = jmask.masked_u32_sum(jnp.asarray(masked), jnp.asarray(part), interpret=True)
    assert same_bits(total, np.asarray(pallas))


def test_masked_u32_sum_wraps_near_0_and_2_32():
    rows = np.array([[2 ** 32 - 1, 2 ** 31, 5, 0], [1, 2 ** 31, 2 ** 32 - 5, 0],
                     [2 ** 32 - 1, 2 ** 32 - 1, 2 ** 32 - 1, 1]], np.uint32)
    part = np.array([1, 1, 0.5], np.float32)
    ours = kmask.masked_u32_sum(t(rows.view(np.int32)), t(part)).numpy()
    want = (rows.astype(np.uint64).sum(axis=0) % 2 ** 32).astype(np.uint32)
    assert np.array_equal(ours.view(np.uint32), want)
    pallas = jmask.masked_u32_sum(jnp.asarray(rows), jnp.asarray(part), interpret=True)
    assert np.array_equal(ours.view(np.uint32), np.asarray(pallas))


# ------------------------------ K6 ------------------------------------------

@pytest.mark.parametrize("G", [2, 4, 8, 32])
def test_grouped_reduce_plain_version_matches_reference(G):
    C, N = 32, 2100
    rng = np.random.default_rng(G)
    x = rng.normal(size=(C, N)).astype(np.float32)
    w = rng.random(C).astype(np.float32)
    mask = (rng.random(C) > 0.3).astype(np.float32)
    mask[:G] = 0.0  # the first group is empty: a zero row, den 0
    jrows, jden = jpacking.grouped_weighted_mean(jnp.asarray(x), jnp.asarray(w), G, jnp.asarray(mask))
    before = kpack.grouped_reduce.launches
    rows, den = packing.grouped_weighted_mean(t(x), t(w), G, t(mask), impl="kernel")
    assert kpack.grouped_reduce.launches == before
    assert same_bits(rows.numpy(), np.asarray(jrows)) and same_bits(den.numpy(), np.asarray(jden))
    assert not rows[0].any() and den[0] == 0
    ref_rows, _ = packing.grouped_weighted_mean(t(x), t(w), G, t(mask), impl="ref")
    assert same_bits(ref_rows.numpy(), rows.numpy())
    wn = (w * mask).reshape(C // G, G)
    wn = wn / np.maximum(wn.sum(1), np.float32(1e-12))[:, None]
    pallas = jpack.grouped_reduce(jnp.asarray(x), jnp.asarray(wn), interpret=True)
    np.testing.assert_allclose(rows.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-6)


# ------------------------------ card-only -----------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# the card cases: the main path's shape, ragged ones, the tiling's edges, and
# rows 4 bytes off a 16-byte boundary (the generic kernel's scalar path at
# block 1024, which the whole-tile kernel takes on aligned rows)
CARD_QUANT_CASES = [(3, 13_312_864, 1024, 0), (6, 2500, 256, 0), (9, 5001, 1024, 0), (1, 77, 64, 0),
                    *[(C, N, block, 0) for C, N, block in QUANT_EDGES], (3, 5000, 1024, 1)]


def _card_delta(C, N, offset, dev):
    """_delta on the card, its rows starting ``offset`` floats into a buffer."""
    x, w = _delta(C, N, N)
    buf = torch.empty(C * N + offset, device=dev)
    xd = buf[offset:].view(C, N)
    xd.copy_(t(x))
    return xd, t(w).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("C,N,block,offset", CARD_QUANT_CASES)
def test_quant8_reduce_cuda_kernel_equals_plain_version_on_card(C, N, block, offset):
    x, w = _card_delta(C, N, offset, _card())
    assert torch.equal(ops.quant8_reduce(x, w, block=block).view(torch.int32),
                       ops.quant8_reduce(x, w, block=block, impl="ref").view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("C,N,block,offset", CARD_QUANT_CASES)
def test_quant4_reduce_cuda_kernel_equals_plain_version_on_card(C, N, block, offset):
    x, w = _card_delta(C, N, offset, _card())
    for mode, key in (("nearest", 0), ("stochastic", 12345), ("stochastic", 2 ** 32 - 1)):
        k = ops.quant4_reduce(x, w, key, mode=mode, block=block)
        p = ops.quant4_reduce(x, w, key, mode=mode, block=block, impl="ref")
        assert torch.equal(k.view(torch.int32), p.view(torch.int32)), (C, N, mode, key)


@pytest.mark.cuda
def test_grouped_reduce_cuda_kernel_equals_plain_version_on_card():
    dev = _card()
    for C, G, N in [(4, 2, 13_312_864), (32, 8, 2101), (9, 3, 77), (2, 1, 1000)]:
        x = torch.randn((C, N), generator=torch.Generator().manual_seed(N)).to(dev)
        wn = torch.rand((C // G, G), generator=torch.Generator().manual_seed(G)).to(dev)
        assert torch.equal(ops.grouped_reduce(x, wn).view(torch.int32),
                           ops.grouped_reduce(x, wn, impl="ref").view(torch.int32))


@pytest.mark.cuda
def test_masked_u32_sum_cuda_kernel_equals_plain_version_on_card():
    dev = _card()
    for C, N, part in [(3, 13_313_024, [1, 0, 1]), (9, 5003, [1] * 9), (1, 64, [1]), (3, 10, [0, 0, 0])]:
        g = torch.Generator().manual_seed(C)
        rows = torch.randint(-2 ** 31, 2 ** 31, (C, N), generator=g, dtype=torch.int64)
        rows = rows.to(torch.int32).to(dev)
        pm = torch.tensor(part, dtype=torch.float32, device=dev)
        assert torch.equal(ops.masked_u32_sum(rows, pm), ops.masked_u32_sum(rows, pm, impl="ref"))


# ------------------------------ aggregator invariants -----------------------

def _agg(mode, impl="kernel", C=3, **kw):
    fed = rounds.FedConfig(n_clients=C, aggregation=mode, client_axis="data", data_axis=None,
                           agg_impl=impl, **kw)
    return rounds.make_aggregator(TCFG, fed)


@pytest.mark.parametrize("domain", ["int8", "int4"])
@pytest.mark.parametrize("mask", [None, [1, 0, 1, 1]])
def test_secure_masked_equals_unmasked_bitwise(domain, mask):
    C = 4
    N = _agg("dense").ctx.spec.n_total
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(C, N)).astype(np.float32)
    x = x0 + (rng.normal(size=(C, N)) * 0.01).astype(np.float32)
    w = np.full(C, 0.25, np.float32)
    m = None if mask is None else t(np.array(mask, np.float32))
    outs = []
    for on in (True, False):
        agg = _agg("secure", C=C, secure_domain=domain, secure_mask=on, secure_session=2)
        out, st = agg.aggregate(t(x.copy()), t(w), agg.init_state(t(x0)), m)
        outs.append(out)
        assert st["round"] == 1
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))


@pytest.mark.parametrize("quant", ["none", "quant4"])
def test_topk_ef_split_is_exact_and_masked_rows_keep_their_residual(quant):
    agg = _agg("topk_ef", topk_frac=0.05, topk_quant=quant, quant4_mode="stochastic")
    N = agg.ctx.spec.n_total
    rng = np.random.default_rng(8)
    x0 = rng.normal(size=(3, N)).astype(np.float32)
    state = agg.init_state(t(x0))
    state["ef"] = t((rng.normal(size=(3, N)) * 1e-3).astype(np.float32))
    state["round"] = 2
    x = t(x0 + (rng.normal(size=(3, N)) * 0.01).astype(np.float32))
    acc, sel, up, residual = agg.split(x, state)
    base = state["base"][None, :]
    assert int(sel.sum(1).min()) >= sparse.topk_count(0.05, N)  # ties may select more
    if quant == "none":
        # the disjoint split: the uploaded part and the residual recompose
        # the compensated delta bit for bit
        assert torch.equal(residual.view(torch.int32), torch.where(sel, 0.0, acc).view(torch.int32))
        assert torch.equal(torch.where(sel, acc, residual).view(torch.int32), acc.view(torch.int32))
        assert torch.equal(up.view(torch.int32), torch.where(sel, x + state["ef"], base).view(torch.int32))
    else:  # the residual absorbs the quantization error too, one rounding
        vq = packing.quant4_dequant_rows_ref(torch.where(sel, acc, 0.0), agg.ctx.fed.quant_block,
                                             key=packing.round_key(0, 2), mode="stochastic")
        assert torch.equal(residual.view(torch.int32), (acc - vq).view(torch.int32))
        assert torch.equal(up.view(torch.int32), (base + vq).view(torch.int32))
    mask = t(np.array([1, 0, 1], np.float32))
    _, st = agg.aggregate(x.clone(), t(np.full(3, 0.5, np.float32)), state, mask)
    assert torch.equal(st["ef"][1].view(torch.int32), state["ef"][1].view(torch.int32))
    assert torch.equal(st["ef"][0].view(torch.int32), residual[0].view(torch.int32))
    assert st["round"] == 3


# ------------------------------ state carry-over ----------------------------

@pytest.mark.parametrize("mode,kw", [("quant4", {}), ("topk_ef", {}), ("fedadam", {}),
                                     ("fedavgm", {}), ("secure", {}),
                                     ("hier", dict(n_clients=4, group_size=2, hier_base="eq6"))])
def test_agg_state_round_trips_bit_exact(mode, kw):
    kw = {"n_clients": 3, **kw}
    jfed = jrounds.FedConfig(aggregation=mode, client_axis="data", data_axis=None, **kw)
    jagg = jrounds.make_aggregator(JCFG, jfed)
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(kw["n_clients"], jagg.ctx.spec.n_total)).astype(np.float32)
    jst = jax.tree.map(np.asarray, jagg.init_state(jnp.asarray(x0)))
    # a state with every leaf moved off its initial value
    jst = jax.tree.map(lambda a: a + np.asarray(3, a.dtype), jst)
    ours = convert.agg_state_from_reference(jst)
    if "round" in jst:
        assert ours["round"] == 3
    back = convert.agg_state_to_reference(ours)
    ref_leaves, ref_def = jax.tree.flatten(jst)
    back_leaves, back_def = jax.tree.flatten(back)
    assert back_def == ref_def
    for a, b in zip(back_leaves, ref_leaves):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the port's own init_state has the reference's keys, shapes and dtypes
    agg = _agg(mode, impl="ref", C=kw["n_clients"], **{k: v for k, v in kw.items() if k != "n_clients"})
    mine = convert.agg_state_to_reference(agg.init_state(t(x0)))
    mine_leaves, mine_def = jax.tree.flatten(mine)
    assert mine_def == ref_def
    for a, b in zip(mine_leaves, ref_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype


# ------------------------------ launcher ------------------------------------

@pytest.mark.parametrize("flags", [["--agg", "quant8"], ["--agg", "quant4", "--quant4-mode", "nearest"],
                                   ["--agg", "secure", "--secure-domain", "int4"],
                                   ["--agg", "topk_ef", "--topk-quant", "quant4"],
                                   ["--agg", "hier", "--clients", "4", "--group-size", "2",
                                    "--hier-base", "eq6"],
                                   ["--agg", "fedavgm"], ["--agg", "fedadam"],
                                   ["--agg", "trimmed_mean", "--clients", "4"]])
def test_launcher_runs_every_uplink_mode(flags, capsys):
    summary = train.main(["--task", "detection", "--device", "cpu", "--rounds", "1", "--img-size", "32",
                          "--batch", "2", "--clients", "3", "--optimizer", "sgd", "--lr", "1e-3",
                          "--participation", "masked", "--max-participants", "2", *flags])
    assert summary["rounds"] == 1 and np.isfinite(summary["final_loss"])
    assert '"final_loss"' in capsys.readouterr().out.splitlines()[-1]


def test_launcher_rejects_group_flags_without_hier():
    with pytest.raises(ValueError, match="--agg hier"):
        train.main(["--device", "cpu", "--rounds", "1", "--agg", "dense", "--group-size", "2"])
