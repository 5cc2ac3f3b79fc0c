"""The port's row quantizers K5a/K5b (``kernels.pack.quantize_rows`` /
``dequantize_rows``), the legacy block quantizers K12a/K12b
(``kernels.quant.quantize`` / ``dequantize``) and their tree forms, and the
gathered quant8 transport they feed, held against the reference on the CPU.

The reference's side is its jnp oracles (``core/packing.py::
quantize_rows_ref``, ``dequantize_rows_ref``, ``dequant_reduce_ref``) and its
Pallas kernels in interpret mode, as its own tests run them. Inputs come
from NumPy seeds. This is the integer quant8 path (``clip(round(x/s))``
with one IEEE division per element), so ``q``, the scales, the dequantized
values and the decoded sums are held bitwise against the oracles and the
dequantizing Pallas kernels, bf16 outputs included (one
round-to-nearest-even cast on both sides). One exception, the reference's
own: its quantizing Pallas kernels (K5a, K12a), jitted for interpret mode,
sometimes compute ``amax / 127`` as a multiply by the rounded reciprocal
(measured: 1 ulp off in 1 of 30 blocks), so against them ``q`` is held
exactly and the scales at the reference's rtol 1e-6
(``tests/test_aggregators.py``).
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
from repro.kernels import ops as jops
from repro.kernels import pack as jpack
from repro.kernels import quant as jquant
from repro.models import params as jparams
from repro.models import yolov3 as jyolo
from repro_torch.configs import get_arch
from repro_torch.core import packing, rounds
from repro_torch.kernels import ops
from repro_torch.kernels import pack as kpack
from repro_torch.kernels import quant as kquant
from repro_torch.launch import train
from repro_torch.models import convert, params

# (C, N, block): the reference tests' shapes (tests/test_aggregators.py,
# tests/test_flat_engine.py), N off the block and off 4, C = 1 and 9, the
# smallest and largest blocks
ROW_CASES = [(3, 2500, 256), (5, 3333, 128), (1, 77, 64), (9, 5001, 1024), (2, 4096 * 3 + 8, 4096),
             (3, 1030, 1024), (4, 1024, 4)]
# (N, block): tests/test_kernels.py::test_quant_roundtrip's, and ragged ones
BLOCK_CASES = [(1024, 256), (5000, 1024), (256, 256), (77, 64), (1, 4), (4097, 1024)]
# (C, N, block) edges of the card's whole-tile quantizer (csrc/row_quant.cu,
# block 1024, N % 4 == 0), whose persistent grid walks the (row, scale block)
# units of all rows, on an H100 (132 SMs): C = 17 (680 units); the smallest
# launch it takes (132 x 4 units) and one unit less (the generic kernel's);
# N one whole grid stride (132 x 16 units) at C = 1; a partial last stride
# and block at C = 2, where a row ends inside a warp's walk
TILE_STRIDE_N = 132 * kpack.QUANT_TILE_WARPS_PER_SM * kpack.QUANT_TILE_BLOCK
TILE_MIN_N = 132 * kpack.QUANT_TILE_WARPS_PER_CTA * kpack.QUANT_TILE_BLOCK
ROW_TILE_EDGES = [(17, 40_000, 1024), (1, TILE_MIN_N, 1024), (1, TILE_MIN_N - 1024, 1024),
                  (1, TILE_STRIDE_N, 1024), (2, TILE_STRIDE_N + 100 * 1024 + 516, 1024)]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize and np.array_equal(
        a.view(f"u{a.dtype.itemsize}"), b.view(f"u{b.dtype.itemsize}"))


def _rows(C, N, seed):
    """Normal rows with exact zeros, a block of tiny values, and (where the
    row is long enough) an all-zero block: its scale is the 1e-12 floor."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, N)).astype(np.float32)
    x[:, ::97] = 0.0
    x[0, : min(N, 64)] *= 1e-30
    if N >= 2048:
        x[-1, 1024:2048] = 0.0
    return x


def _ties(block=256):
    """Rows whose scale is exactly 1 (amax 127): x/s lands on .5 ties (half to
    even decides), on +-127 and next to it, and a row near +-127 s."""
    halves = np.arange(-126.5, 127.0, 1.0, dtype=np.float32)  # 254 exact ties
    row0 = np.concatenate([halves, [127.0, -127.0]]).astype(np.float32)[:block]
    row1 = np.float32(127.0) * np.linspace(-1, 1, block, dtype=np.float32)
    row1[::7] = np.nextafter(np.float32(127.0), np.float32(0.0))
    row1[1] = -127.0
    return np.stack([row0, row1])


@pytest.mark.parametrize("C,N,block", ROW_CASES + ROW_TILE_EDGES)
def test_quantize_rows_plain_version_matches_reference_and_pallas(C, N, block):
    x = _rows(C, N, seed=C * N)
    before = kpack.quantize_rows.launches
    q, s = kpack.quantize_rows(t(x), block=block)
    assert kpack.quantize_rows.launches == before  # the CPU takes the plain version
    assert q.dtype == torch.int8 and q.shape == (C, N) and s.shape == (C, -(-N // block))
    qr, sr = jpacking.quantize_rows_ref(jnp.asarray(x), block)
    assert same_bits(q.numpy(), qr) and same_bits(s.numpy(), sr), (C, N, block)
    qp, sp = jpack.quantize_rows(jnp.asarray(x), block=block, interpret=True)
    assert same_bits(q.numpy(), qp), (C, N, block)
    np.testing.assert_allclose(s.numpy(), np.asarray(sp), rtol=1e-6, atol=0)


def test_quantize_rows_half_ties_round_to_even_and_clip():
    x = _ties()
    q, s = kpack.quantize_rows(t(x), block=256)
    assert float(s[0, 0]) == 1.0
    qr, sr = jpacking.quantize_rows_ref(jnp.asarray(x), 256)
    assert same_bits(q.numpy(), qr) and same_bits(s.numpy(), sr)
    # -126.5 -> -126, -125.5 -> -126: half to even, never away from zero
    assert q[0, :4].tolist() == [-126, -126, -124, -124]
    assert int(q.abs().max()) == 127


def test_zero_block_scale_is_the_floor():
    q, s = kpack.quantize_rows(torch.zeros(2, 2048), block=1024)
    assert torch.equal(q, torch.zeros(2, 2048, dtype=torch.int8))
    assert torch.equal(s, torch.full((2, 2), np.float32(1e-12) / np.float32(127.0)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_rows_plain_version_matches_reference_and_pallas(dtype):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for C, N, block in ROW_CASES + [(2, 256, 256)]:
        x = _ties() if (C, N) == (2, 256) else _rows(C, N, seed=C + N)
        q, s = kpack.quantize_rows(t(x), block=block)
        before = kpack.dequantize_rows.launches
        back = kpack.dequantize_rows(q, s, dtype=dtype, block=block)
        assert kpack.dequantize_rows.launches == before
        assert back.dtype == dtype and back.shape == (C, N)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        got = back.view(bits).numpy()
        want = jpacking.dequantize_rows_ref(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), block,
                                            jdtype)
        assert same_bits(got, np.asarray(want).view(got.dtype)), (C, N, block)
        pallas = jpack.dequantize_rows(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                                       dtype=jdtype, block=block, interpret=True)
        assert same_bits(got, np.asarray(pallas).view(got.dtype)), (C, N, block)


def test_dequantize_rows_refuses_other_dtypes():
    q, s = kpack.quantize_rows(torch.zeros(1, 8), block=4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kpack.dequantize_rows(q, s, dtype=torch.float16, block=4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kquant.dequantize(q[0], s[0], dtype=torch.float64, block=4)


def test_block_quantize_plain_version_matches_reference_kernels():
    rng = np.random.default_rng(11)
    for N, block in BLOCK_CASES:
        x = rng.normal(size=N).astype(np.float32)
        before = kquant.quantize.launches, kquant.dequantize.launches
        q, s = kquant.quantize(t(x), block=block)
        back = kquant.dequantize(q, s, block=block)
        assert (kquant.quantize.launches, kquant.dequantize.launches) == before
        xp = np.pad(x, (0, (-N) % block))[None]  # the reference's zero padding
        qr, sr = jpacking.quantize_rows_ref(jnp.asarray(xp), block)
        assert same_bits(q.numpy(), np.asarray(qr)[0, :N]) and same_bits(s.numpy(), sr[0])
        qp, sp = jquant.quantize(jnp.asarray(x), block=block, interpret=True)
        assert same_bits(q.numpy(), qp), (N, block)
        np.testing.assert_allclose(s.numpy(), np.asarray(sp), rtol=1e-6, atol=0)
        bp = jquant.dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), block=block,
                               interpret=True)
        assert same_bits(back.numpy(), bp), (N, block)
        # and K12 is K5 at C = 1
        qr, sr = kpack.quantize_rows(t(x[None]), block=block)
        assert torch.equal(qr[0], q) and torch.equal(sr[0], s)
    with pytest.raises(ValueError, match="1-D"):
        kquant.quantize(torch.zeros(2, 4))


def test_quantize_tree_round_trips_a_param_tree_like_the_reference():
    jcfg = dataclasses.replace(jget_arch("fedyolov3").reduced(), d_model=8, n_layers=3)
    tree = jax.tree.map(np.asarray, jparams.init_params(jyolo.template(jcfg), jax.random.key(2),
                                                        jnp.float32))
    ttree = convert.lm_params_from_reference(tree)  # the same leaves, as tensors
    qt = ops.quantize_tree(ttree)
    back = ops.dequantize_tree(qt, ttree)
    jqt = jops.quantize_tree(jax.tree.map(jnp.asarray, tree))
    # the reference decodes the port's payload
    jback = jops.dequantize_tree(params.map_tree(lambda x: jnp.asarray(x.numpy()), qt),
                                 jax.tree.map(jnp.asarray, tree))
    jflat = dict(params.flatten_with_paths(jax.tree.map(np.asarray, jqt)))
    for path, leaf in params.flatten_with_paths(qt):
        if path.endswith("/q"):
            assert same_bits(leaf.numpy(), jflat[path]), path
        else:
            np.testing.assert_allclose(leaf.numpy(), jflat[path], rtol=1e-6, atol=0, err_msg=path)
    jb = dict(params.flatten_with_paths(jax.tree.map(np.asarray, jback)))
    for path, leaf in params.flatten_with_paths(back):
        assert leaf.shape == jb[path].shape and same_bits(leaf.numpy(), jb[path]), path
    # the plain and kernel dispatch agree on the CPU
    ref_back = ops.dequantize_tree(ops.quantize_tree(ttree, impl="ref"), ttree, impl="ref")
    for (_, a), (_, b) in zip(params.flatten_with_paths(back), params.flatten_with_paths(ref_back)):
        assert torch.equal(a, b)


# leaves of the tree dequantizer's tests: one element, a ragged few, one short
# of and one past a scale block, an empty leaf, several whole blocks
TREE_SIZES = [1, 3, 1023, 1025, 0, 4096, 5000]


def test_tree_launch_plan_counts_units_and_splits_past_capacity():
    """kernels.quant.tree_launches: a leaf takes ceil(n / 1024) units (its
    scale blocks), numbered from 0 in each launch, leaf after leaf; an empty
    leaf takes no row; a launch holds at most TREE_CAPACITY rows; dtype codes
    are csrc/row_quant.cu's (0 float32, 1 bfloat16)."""
    f32, bf16 = torch.float32, torch.bfloat16
    plan = kquant.tree_launches(TREE_SIZES, [f32, bf16] * 3 + [f32])
    assert plan == [([(0, 0, 0), (1, 1, 1), (2, 0, 2), (3, 1, 3), (5, 1, 5), (6, 0, 9)], 14)]
    assert kquant.tree_launches([], []) == [] and kquant.tree_launches([0, 0], [f32, f32]) == []
    cap = kquant.TREE_CAPACITY
    ns = [1 + (i % 3) * 1024 for i in range(2 * cap + 3)]  # 1, 1025, 2049 elements in turn
    ns[cap] = 0  # an empty leaf at the first launch's edge takes no row
    plan = kquant.tree_launches(ns, [bf16] * len(ns))
    assert [len(rows) for rows, _ in plan] == [cap, cap, 2]
    leaves = [i for rows, _ in plan for i, _, _ in rows]
    assert leaves == [i for i, n in enumerate(ns) if n]
    for rows, units in plan:
        blocks = [-(-ns[i] // kquant.TREE_BLOCK) for i, _, _ in rows]
        assert [u for _, _, u in rows] == list(np.cumsum([0] + blocks[:-1]))
        assert units == sum(blocks) and all(code == 1 for _, code, _ in rows)
    with pytest.raises(ValueError):
        kquant.tree_launches([1, 2], [f32])


def test_dequantize_tree_on_the_cpu_matches_the_reference_per_leaf():
    """The tree dequantizer on CPU tensors takes the plain version per leaf
    (no launch counted) and equals the reference's Pallas ``dequantize``
    (interpret mode) leaf by leaf, bitwise, in float32 and bfloat16."""
    rng = np.random.default_rng(5)
    qs = [t(rng.integers(-127, 128, n).astype(np.int8)) for n in TREE_SIZES]
    scales = [t(rng.random(-(-n // 1024)).astype(np.float32)) for n in TREE_SIZES]
    dtypes = [(torch.float32, torch.bfloat16)[i % 2] for i in range(len(qs))]
    before = kquant.dequantize_tree.launches
    outs = kquant.dequantize_tree(qs, scales, dtypes)
    assert kquant.dequantize_tree.launches == before
    for q, s, dtype, out in zip(qs, scales, dtypes, outs):
        assert out.dtype == dtype and out.shape == q.shape
        if not q.numel():
            continue
        jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        want = jquant.dequantize(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), dtype=jdtype,
                                 interpret=True)
        assert same_bits(out.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).numpy(),
                         np.asarray(want).view(np.int16 if dtype == torch.bfloat16 else np.int32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kquant.dequantize_tree(qs[:1], scales[:1], [torch.float16])
    with pytest.raises(ValueError, match="1-D"):
        kquant.dequantize_tree([qs[0][None]], scales[:1], [torch.float32])


@pytest.mark.parametrize("C,N,block", [(3, 2500, 256), (4, 5001, 1024), (70, 300, 128)])
def test_gathered_decode_reduce_equals_the_fused_transport(C, N, block):
    """dequant_reduce_ref over quantize_rows' payload == quant8_mean_ref (the
    fused K4 path's plain arithmetic) == the reference's dequant_reduce_ref,
    bitwise; C = 70 takes the contraction beyond CHAIN_MAX_CLIENTS."""
    x = _rows(C, N, seed=N)
    w = np.random.default_rng(C).random(C).astype(np.float32)
    q, s = packing.quantize_rows_ref(t(x), block)
    gathered = packing.dequant_reduce_ref(q, s, t(w), block)
    fused = packing.quant8_mean_ref(t(x), t(w), block)
    ref = jpacking.dequant_reduce_ref(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                                      jnp.asarray(w), block)
    assert same_bits(gathered.numpy(), fused.numpy())
    if C <= packing.CHAIN_MAX_CLIENTS:  # XLA's contraction sums in its own order
        assert same_bits(gathered.numpy(), ref)
    else:
        np.testing.assert_allclose(gathered.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_quant8_on_a_one_rank_mesh_equals_the_meshless_transport():
    """The launcher's quant8 (the 1 x 1 client mesh: K5a, the int8 and scale
    all-gathers, the decode-reduce) against the fused meshless K4 path, from
    one buffer with a client masked out: the dispatch and the carried base
    bitwise equal, one K5a launch's worth of work and no K4."""
    cfg = get_arch("qwen3-1.7b").reduced()
    mesh = train.client_mesh(torch.device("cpu"))
    fed = rounds.FedConfig(n_clients=4, aggregation="quant8", client_axis="data", data_axis=None,
                           agg_impl="kernel")
    with_mesh = rounds.make_aggregator(cfg, fed, mesh)
    meshless = rounds.make_aggregator(cfg, fed)
    N = with_mesh.ctx.spec.n_total
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=N).astype(np.float32)
    x = (x0[None] + 1e-3 * rng.normal(size=(4, N))).astype(np.float32)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    w = mask / mask.sum()
    st0 = {"base": t(x0)}
    a, sa = with_mesh.aggregate(t(x.copy()), w, st0, mask)
    b, sb = meshless.aggregate(t(x.copy()), w, st0, mask)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(sa["base"].view(torch.int32), sb["base"].view(torch.int32))


def _wide_rows(C, N, seed):
    """Rows whose 1024-blocks have an amax of 1.5 * 2^E, E in [-60, 125) (so
    scales above 2^100), elements 0-70 binades below it (some below 2^-90,
    some subnormal), exact zeros, and elements on half steps k + 1/2 of the
    block's scale: the whole-tile kernel's division in and out of the range
    where it runs fast (chip_smoke.py's ``wide_rows``)."""
    rng = np.random.default_rng(seed)
    nb = -(-N // 1024)
    top = rng.integers(-60, 125, (C, nb, 1)).astype(np.float32)
    x = np.exp2(top - np.float32(70) * rng.random((C, nb, 1024), dtype=np.float32))
    x = np.where(rng.random(x.shape) < 0.5, -x, x).astype(np.float32)
    amax = np.float32(1.5) * np.exp2(top[..., 0])
    x[..., 0] = amax
    k = rng.integers(-7, 7, (C, nb, 16)).astype(np.float32) + np.float32(0.5)
    x[..., 1:17] = (k * 18) * (amax / np.float32(127))[..., None]
    x[..., 17::97] = 0.0
    return np.ascontiguousarray(x.reshape(C, -1)[:, :N])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _hold_on_card(x, block):
    """K5a and K5b on the card rows ``x``, and K12a/K12b on its row 0, against
    their plain versions on the card, bitwise."""
    q, s = ops.quantize_rows(x, block=block)
    qr, sr = ops.quantize_rows(x, block=block, impl="ref")
    assert torch.equal(q, qr) and torch.equal(s.view(torch.int32), sr.view(torch.int32))
    for dtype in (torch.float32, torch.bfloat16):
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        a = ops.dequantize_rows(q, s, dtype=dtype, block=block)
        b = ops.dequantize_rows(q, s, dtype=dtype, block=block, impl="ref")
        assert torch.equal(a.view(bits), b.view(bits))
    q1, s1 = ops.quantize(x[0], block=block)
    qr1, sr1 = ops.quantize(x[0], block=block, impl="ref")
    assert torch.equal(q1, qr1) and torch.equal(s1.view(torch.int32), sr1.view(torch.int32))
    assert torch.equal(ops.dequantize(q1, s1, block=block),
                       ops.dequantize(q1, s1, block=block, impl="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "main", "tile_edges", "unaligned", "wide"])
def test_row_and_block_quantizer_kernels_equal_plain_versions_on_card(case):
    """K5a, K5b, K12a and K12b on the card against their plain versions on
    the card, bitwise: ragged shapes, ties and both output dtypes; the quant8
    round's (3, 13,312,864); the whole-tile kernel's edges at the card's SM
    count; rows 4 bytes off a 16-byte boundary (the generic kernel at block
    1024); rows spanning 2^-130 to 2^125 with ties."""
    dev = _card()
    if case == "ragged":
        for C, N, block in ROW_CASES:
            _hold_on_card(t(_rows(C, N, seed=C * N)).to(dev), block)
        _hold_on_card(t(_ties()).to(dev), 256)
        for N, block in BLOCK_CASES:
            x = t(np.random.default_rng(N).normal(size=N).astype(np.float32)).to(dev)
            _hold_on_card(x[None], block)
    elif case == "main":
        _hold_on_card(t(_rows(3, 13_312_864, seed=3)).to(dev), 1024)
    elif case == "tile_edges":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        least = sms * kpack.QUANT_TILE_WARPS_PER_CTA * 1024
        stride = sms * kpack.QUANT_TILE_WARPS_PER_SM * 1024
        for C, N in [(17, 40_000), (1, least), (1, least - 1024), (1, stride),
                     (2, stride + 100 * 1024 + 516)]:
            _hold_on_card(t(_rows(C, N, seed=N)).to(dev), 1024)
    elif case == "unaligned":
        for C, N, block in [(3, 5000, 1024), (2, 4096 * 3, 4096)]:
            buf = torch.empty(C * N + 1, device=dev)
            x = buf[1:].view(C, N).copy_(t(_rows(C, N, seed=N)))
            assert x.data_ptr() % 16 == 4
            _hold_on_card(x, block)
    else:
        for C, N in [(3, 65536 + 12), (2, 1 << 20), (3, 5001)]:
            _hold_on_card(t(_wide_rows(C, N, seed=N)).to(dev), 1024)


@pytest.mark.cuda
def test_tree_dequantizer_kernel_equals_the_plain_version_on_card():
    """K12b's grouped launch on the card against ``impl="ref"``, bitwise: a
    reduced fedyolov3 tree through ``ops.dequantize_tree`` in one launch, and
    a tree of more leaves than one launch's table, f32 and bf16 in turn,
    empty, ragged and 1-byte-misaligned leaves, one launch per
    TREE_CAPACITY non-empty leaves."""
    dev = _card()
    cfg = get_arch("fedyolov3").reduced()
    from repro_torch.models import yolov3
    tree = params.init_params(yolov3.template(cfg), torch.Generator().manual_seed(0))
    tree = params.map_tree(lambda x: x.to(dev), tree)
    qt = ops.quantize_tree(tree)
    before = kquant.dequantize_tree.launches
    back = ops.dequantize_tree(qt, tree)
    assert kquant.dequantize_tree.launches == before + 1
    want = ops.dequantize_tree(qt, tree, impl="ref")
    for (_, a), (_, b) in zip(params.flatten_with_paths(back), params.flatten_with_paths(want)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    rng = np.random.default_rng(8)
    n_leaves = 2 * kquant.TREE_CAPACITY + 5
    sizes = [TREE_SIZES[i % len(TREE_SIZES)] for i in range(n_leaves)]
    qs = [t(rng.integers(-127, 128, n + 1).astype(np.int8)).to(dev) for n in sizes]
    qs = [q[1:] if i == 9 else q[:-1] for i, q in enumerate(qs)]  # leaf 9 sits 1 byte off 16
    scales = [t(rng.random(-(-n // 1024)).astype(np.float32)).to(dev) for n in sizes]
    dtypes = [(torch.float32, torch.bfloat16)[i % 2] for i in range(n_leaves)]
    before = kquant.dequantize_tree.launches
    outs = kquant.dequantize_tree(qs, scales, dtypes)
    torch.cuda.synchronize()
    nonempty = sum(n > 0 for n in sizes)
    assert kquant.dequantize_tree.launches - before == -(-nonempty // kquant.TREE_CAPACITY)
    for q, s, dtype, out in zip(qs, scales, dtypes, outs):
        plain = ops.dequantize(q, s, dtype=dtype, impl="ref")
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert out.shape == q.shape and torch.equal(out.view(bits), plain.view(bits))
