"""The port's legacy tree path (``repro_torch``: the per-leaf Eq. 6 and int8
helpers of ``core.compression``, ``core.fedavg``, the ``state_layout="tree"``
rounds, ``FLServer`` over a tree state and the tree carriers of
``models.convert``) held against the reference on identical inputs and
against the port's own flat engine.

Models: the reduced qwen3-1.7b narrowed to d_model 64, d_ff 128 and a
vocabulary of 128 (2 layers, so 3 score buckets: eq6 and static_topn really
choose; the tree-against-flat matrix cuts it to 1 layer at d_model 32, 2
buckets and top 1), the reduced gemma3-27b's template (grouped layers and a tail: the
``stack2`` leaves and the tail's bucket offset) and fedyolov3 cut to base
width 8 and 3 stages at 32x32 images (every leaf in the one misc bucket).
Inputs come from NumPy seeds. Tolerances, each stated where it is used:

- ``layer_sums`` and ``apply_layer_mask``: rtol 1e-6 (sums over up to 16k
  elements add in another order; an atol of 1e-6 of the sum of magnitudes
  covers cancellation); ``quantize`` and ``dequantize``: bit for bit;
- ``core.fedavg`` against the reference's: 1e-5 (``tests/test_aggregators.py``),
  eq6's new sums within 1e-6 relative and its upload choices equal, quant8
  within one quantization step of each leaf;
- the packed aggregators against ``core.fedavg`` inside the port: 1e-5;
- a tree round against the port's flat round: bit for bit, state and
  metrics;
- two tree rounds carried across from the reference against its tree
  engine: the flat round's bounds of ``tests/test_torch_train_rounds.py`` (loss
  rtol 1e-5, params rtol 1e-4 / atol 1e-6, moments rtol 1e-4 / atol 1e-5,
  prev_sums rtol 1e-5 / atol 1e-4); under quant8 the packages' local
  training differs by about 1e-7 relative, which flips a rounding that
  sits that close to a half step: at most 1 element in 10^4 may then be
  off, by at most one weighted quantization step (1e-4, the rule of
  ``tests/test_torch_participation.py``'s quant8 rounds).

The tree rounds on (1, 2) and (2, 1) gloo groups and ``aggregate_quant8``
on two client shards run in ``tests/test_torch_sharded.py``'s rank
processes.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.core import compression as jcomp
from repro.core import fedavg as jfedavg
from repro.core import rounds as JR
from repro.data import pipeline as jpipeline
from repro.models import params as jparams
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro_torch.configs import get_arch
from repro_torch.core import fedavg, packing, rounds
from repro_torch.core import compression as comp
from repro_torch.core.server import FLServer
from repro_torch.data import pipeline
from repro_torch.models import convert
from repro_torch.models.params import flatten_with_paths, map_tree
from repro_torch.optim import adamw, sgd

NARROW = dict(d_model=64, d_ff=128, vocab_size=128)
LM = (dataclasses.replace(jget_arch("qwen3-1.7b").reduced(), **NARROW),
      dataclasses.replace(get_arch("qwen3-1.7b").reduced(), **NARROW))
# the port-only tree-against-flat matrix: 1 layer (2 buckets, top 1 uploaded), narrower
TINY = dataclasses.replace(get_arch("qwen3-1.7b").reduced(), d_model=32, d_ff=64, vocab_size=64,
                           n_heads=2, n_kv_heads=1, head_dim=16, n_layers=1)
YOLO = (dataclasses.replace(jget_arch("fedyolov3").reduced(), d_model=8, n_layers=3),
        dataclasses.replace(get_arch("fedyolov3").reduced(), d_model=8, n_layers=3))
GEMMA = (jget_arch("gemma3-27b").reduced(), get_arch("gemma3-27b").reduced())
C = 4
WEIGHTS = np.array([0.4, 0.1, 0.3, 0.2], np.float32)


def _fed(pkg, aggregation="eq6", **kw):
    base = dict(n_clients=C, local_steps=1, aggregation=aggregation, topn=2, client_axis="data",
                data_axis=None, state_layout="tree")
    base.update(kw)
    return (rounds.FedConfig if pkg == "torch" else JR.FedConfig)(**base)


def _trees(cfgs, seed=7, noise=0.01):
    """(reference tree, port tree) pairs of client-stacked (C, *shape)
    leaves: ``base`` one model in every row, ``stacked`` it plus noise."""
    rng = np.random.default_rng(seed)
    tpl = rounds.make_template(cfgs[1])
    one = map_tree(lambda i: rng.normal(size=i.shape).astype(np.float32), tpl)
    base = map_tree(lambda x: np.repeat(x[None], C, axis=0), one)
    stacked = map_tree(lambda x: (x + noise * rng.normal(size=x.shape)).astype(np.float32), base)
    return base, stacked


def _jtree(cfg, tree):
    """A tree of NumPy leaves keyed like the port -> the reference template's
    container (tuples where it has tuples) of JAX arrays."""
    flat = dict(flatten_with_paths(tree))
    jtpl = JR.make_template(cfg)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jtpl, is_leaf=jparams.is_info)
    key = lambda p: "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[key(p)]) for p, _ in leaves])


def _t(tree):
    return map_tree(torch.from_numpy, tree)


def _assert_trees(ours, ref, rtol=0.0, atol=0.0):
    """A port tree against a reference tree, leaf by leaf in one order."""
    ref_leaves = dict(flatten_with_paths(jax.tree.map(np.asarray, ref)))
    for path, x in flatten_with_paths(ours):
        np.testing.assert_allclose(x.numpy(), ref_leaves[path], rtol=rtol, atol=atol, err_msg=path)


def _sums_atol(stacked) -> float:
    """1e-6 of the largest client's sum of magnitudes: signed sums that
    cancel keep the rounding of the magnitudes they added."""
    return 1e-6 * float(sum(np.abs(x).reshape(C, -1).sum(1) for _, x in flatten_with_paths(stacked)).max())


# ------------------------------ compression ---------------------------------

@pytest.mark.parametrize("which", ["qwen3", "gemma3", "fedyolov3"])
def test_layer_sums_and_layer_mask_match_reference(which):
    cfgs = {"qwen3": LM, "gemma3": GEMMA, "fedyolov3": YOLO}[which]
    jcfg, cfg = cfgs
    _, stacked = _trees(cfgs)
    tpl, jtpl = rounds.make_template(cfg), JR.make_template(jcfg)
    js = _jtree(jcfg, stacked)
    want = np.asarray(jax.jit(jax.vmap(lambda p: jcomp.layer_sums(jcfg, jtpl, p)))(js))
    got = comp.layer_sums(cfg, tpl, _t(stacked))
    assert got.shape == (C, comp.n_score_buckets(cfg)) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=_sums_atol(stacked))
    # one client's tree, no leading dim: the reference's own signature
    one = comp.layer_sums(cfg, tpl, map_tree(lambda x: torch.from_numpy(x[2]), stacked))
    np.testing.assert_allclose(one.numpy(), want[2], rtol=1e-6, atol=_sums_atol(stacked))
    if which == "gemma3":  # the tail's layers land after the grouped ones
        assert (want[:, :cfg.n_layers] != 0).all()
    mask = np.random.default_rng(1).integers(0, 2, (C, comp.n_score_buckets(cfg))).astype(np.float32)
    jm = jax.jit(jax.vmap(lambda p, m: jcomp.apply_layer_mask(jcfg, jtpl, p, m)))(
        js, jnp.asarray(mask))
    _assert_trees(comp.apply_layer_mask(cfg, tpl, _t(stacked), torch.from_numpy(mask)), jm,
                  rtol=1e-6)
    # one client's tree and its (n_layers+1,) mask: the reference's client 1
    one = comp.apply_layer_mask(cfg, tpl, map_tree(lambda x: torch.from_numpy(x[1]), stacked),
                                torch.from_numpy(mask[1]))
    _assert_trees(one, jax.tree.map(lambda x: x[1], jm), rtol=1e-6)


def _quant_inputs():
    rng = np.random.default_rng(3)
    half = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 0.0], np.float32)
    return {"normal": rng.normal(size=(3, 257)).astype(np.float32),
            "half_steps": half,  # scale exactly 1: every value half a step off an integer
            "half_steps_scaled": half * np.float32(0.03125),  # a power of two keeps them halves
            "zeros": np.zeros(5, np.float32),  # amax 0: the 1e-12 floor
            "wide": (rng.normal(size=(64,)) * 10.0 ** rng.integers(-30, 30, 64)).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(_quant_inputs()))
def test_quantize_and_dequantize_match_reference_bit_for_bit(name):
    x = _quant_inputs()[name]
    jq, js = jcomp.quantize(jnp.asarray(x))
    q, s = comp.quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().view(np.int32) == np.asarray(js).view(np.int32)
    if name == "half_steps":  # half to even, as jnp.round
        assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 0]
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = comp.dequantize(q, s, dtype)
        want = np.asarray(jcomp.dequantize(jq, js, jdtype).astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy().view(np.int32), want.view(np.int32))


# ------------------------------ core.fedavg ---------------------------------

@pytest.fixture(scope="module")
def lm_trees():
    base, stacked = _trees(LM)
    return base, stacked, _jtree(LM[0], base), _jtree(LM[0], stacked)


def test_fedavg_modes_and_reexports():
    assert fedavg.AGGREGATION_MODES == jfedavg.AGGREGATION_MODES
    for r in range(4):
        assert fedavg.static_layer_schedule(5, 2, r) == jfedavg.static_layer_schedule(5, 2, r)


def test_fedavg_dense_matches_reference(lm_trees):
    _, stacked, _, js = lm_trees
    out = fedavg.aggregate_dense(_t(stacked), torch.from_numpy(WEIGHTS))
    _assert_trees(out, jax.jit(jfedavg.aggregate_dense)(js, jnp.asarray(WEIGHTS)), atol=1e-5)
    for _, x in flatten_with_paths(out):  # every client row holds the mean
        assert torch.equal(x[0], x[3])


@pytest.mark.parametrize("topn", [1, 2])
def test_fedavg_eq6_matches_reference(lm_trees, topn):
    base, stacked, jb, js = lm_trees
    jcfg, cfg = LM
    jtpl, tpl = JR.make_template(jcfg), rounds.make_template(cfg)
    prev = jax.jit(jax.vmap(lambda p: jcomp.layer_sums(jcfg, jtpl, p)))(jb)
    want, want_sums = jax.jit(lambda s_, w_, p_: jfedavg.aggregate_eq6(jcfg, jtpl, s_, w_, p_, topn))(
        js, jnp.asarray(WEIGHTS), prev)
    got, sums = fedavg.aggregate_eq6(cfg, tpl, _t(stacked), torch.from_numpy(WEIGHTS),
                                     torch.tensor(np.asarray(prev)), topn)
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_sums), rtol=1e-6,
                               atol=_sums_atol(stacked))
    choice = comp.topn_mask(comp.contribution_scores(torch.tensor(np.asarray(prev)), sums), topn)
    jchoice = jax.vmap(lambda s: jcomp.topn_mask(s, topn))(jcomp.contribution_scores(prev, want_sums))
    np.testing.assert_array_equal(choice.numpy(), np.asarray(jchoice))
    assert not choice.all()  # some bucket stays local on some client
    _assert_trees(got, want, atol=1e-5)


@pytest.mark.parametrize("r", [0, 1])
def test_fedavg_static_topn_matches_reference(lm_trees, r):
    _, stacked, _, js = lm_trees
    jcfg, cfg = LM
    sched = fedavg.static_layer_schedule(comp.n_score_buckets(cfg), 2, r)
    jtpl = JR.make_template(jcfg)
    want = jax.jit(lambda s_, w_: jfedavg.aggregate_static_topn(jcfg, jtpl, s_, w_, sched))(
        js, jnp.asarray(WEIGHTS))
    got = fedavg.aggregate_static_topn(cfg, rounds.make_template(cfg), _t(stacked),
                                       torch.from_numpy(WEIGHTS), sched)
    _assert_trees(got, want, atol=1e-5)


def test_fedavg_quant8_matches_reference_within_one_step(lm_trees):
    """The reference on its 1 x 1 CPU mesh, the port without one: one scale
    per leaf over all C rows in both."""
    base, stacked, jb, js = lm_trees
    jcfg = LM[0]
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    w = np.full(C, 1.0 / C, np.float32)
    with jax.set_mesh(mesh):
        specs = JR.stacked_pspecs(JR.make_template(jcfg), "data")
        want = jax.jit(lambda s_, b_, w_: jfedavg.aggregate_quant8(s_, b_, w_, mesh, "data", specs))(
            js, jb, jnp.asarray(w))
    got = fedavg.aggregate_quant8(_t(stacked), _t(base), torch.from_numpy(w))
    ref = dict(flatten_with_paths(jax.tree.map(np.asarray, want)))
    for (path, x), (_, n), (_, b) in zip(flatten_with_paths(got), flatten_with_paths(stacked),
                                         flatten_with_paths(base)):
        step = np.abs(n - b).max() / 127.0  # the leaf's quantization step
        np.testing.assert_allclose(x.numpy(), ref[path], rtol=0, atol=step + 1e-7, err_msg=path)
    two_shards = SimpleNamespace(mesh_dim_names=("data", "model"), size=lambda d: (2, 1)[d])
    with pytest.raises(ValueError, match=r"n_clients \(3\) divisible by the 'data' mesh axis \(2"):
        fedavg.aggregate_quant8(_t(stacked), _t(base), torch.full((3,), 1 / 3), two_shards, "data")


# ----------------------- packed engine == core.fedavg -----------------------

def _packed_vs_legacy(mode, lm_trees, **kw):
    base, stacked, _, _ = lm_trees
    cfg = LM[1]
    agg = rounds.make_aggregator(cfg, _fed("torch", mode, state_layout="flat", **kw))
    spec, tpl = agg.ctx.spec, agg.ctx.template
    w = torch.from_numpy(WEIGHTS)
    st0 = agg.init_state(packing.pack(spec, _t(base)))
    out, st1 = agg.aggregate(packing.pack(spec, _t(stacked)), w, st0)
    return packing.unpack(spec, out, tpl), st0, st1, w


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_packed_dense_and_static_topn_match_legacy(lm_trees, impl):
    _, stacked, _, _ = lm_trees
    cfg = LM[1]
    got, _, _, w = _packed_vs_legacy("dense", lm_trees, agg_impl=impl)
    for (path, a), (_, b) in zip(flatten_with_paths(got),
                                 flatten_with_paths(fedavg.aggregate_dense(_t(stacked), w))):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=path)
    got, _, _, w = _packed_vs_legacy("static_topn", lm_trees, agg_impl=impl, round_idx_static=1)
    sched = fedavg.static_layer_schedule(comp.n_score_buckets(cfg), 2, 1)
    legacy = fedavg.aggregate_static_topn(cfg, rounds.make_template(cfg), _t(stacked), w, sched)
    for (path, a), (_, b) in zip(flatten_with_paths(got), flatten_with_paths(legacy)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=path)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_packed_eq6_matches_legacy(lm_trees, impl):
    base, stacked, _, _ = lm_trees
    cfg = LM[1]
    got, st0, st1, w = _packed_vs_legacy("eq6", lm_trees, agg_impl=impl)
    tpl = rounds.make_template(cfg)
    prev = comp.layer_sums(cfg, tpl, _t(base))
    torch.testing.assert_close(st0["prev_sums"], prev, rtol=1e-5, atol=1e-3)
    legacy, sums = fedavg.aggregate_eq6(cfg, tpl, _t(stacked), w, prev, 2)
    for (path, a), (_, b) in zip(flatten_with_paths(got), flatten_with_paths(legacy)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=path)
    torch.testing.assert_close(st1["prev_sums"], sums, rtol=1e-5, atol=1e-3)


# ----------------------- tree round == flat round ---------------------------

STACKED = {"dense": {}, "eq6": {}, "static_topn": dict(round_idx_static=1), "quant8": {},
           "quant4": dict(quant4_seed=3), "secure": dict(secure_session=5),
           "topk_ef": dict(topk_frac=0.2), "hier": dict(group_size=2, hier_base="eq6"),
           "fedavgm": {}, "fedadam": dict(server_lr=0.02), "trimmed_mean": dict(trim_ratio=0.3)}
PART = {"full": {}, "masked": dict(participation="masked"),
        "compact": dict(participation="compact", max_participants=3)}
OPTS = {"sgd": lambda: sgd(lr=0.05), "adamw": lambda: adamw(lr=3e-3)}


def _toks(r):
    toks = np.random.default_rng(r).integers(0, TINY.vocab_size, (C, 1, 1, 8))
    return {"tokens": torch.from_numpy(toks.astype(np.int64))}


def _part(fed):
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    w = np.array([0.5, 0.0, 0.3, 0.2], np.float32)
    if fed.participation == "full":
        return torch.from_numpy(WEIGHTS)
    return rounds.participation_input(fed, mask, w, np.array([0, 2, 3]))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("part", sorted(PART))
@pytest.mark.parametrize("mode", sorted(STACKED))
def test_tree_round_equals_flat_round_bit_for_bit(mode, part, opt):
    cfg = TINY
    out = {}
    for layout in ("flat", "tree"):
        fed = _fed("torch", mode, topn=1, state_layout=layout, **STACKED[mode], **PART[part])
        state = rounds.make_state(cfg, fed, OPTS[opt](), device="cpu")
        fr = rounds.build_fed_round(cfg, fed, OPTS[opt]())
        for r in range(2):
            state, m = fr(state, _toks(r), _part(fed))
        out[layout] = (state, m, rounds.make_aggregator(cfg, fed))
    (flat, fm, _), (tree, tm, agg) = out["flat"], out["tree"]
    assert not isinstance(tree["params"], torch.Tensor) and tree["round"] == flat["round"] == 2
    for (_, x), (_, info) in zip(flatten_with_paths(tree["params"]),
                                 flatten_with_paths(agg.ctx.template)):
        assert x.shape == (C,) + tuple(info.shape)
    again = rounds.flat_state(agg, tree)
    assert torch.equal(_bits(again["params"]), _bits(flat["params"]))
    assert again["opt"].keys() == flat["opt"].keys()
    for k, v in flat["opt"].items():
        assert torch.equal(_bits(again["opt"][k]), _bits(v)), k
    for (path, a), (_, b) in zip(flatten_with_paths(tree["agg"]), flatten_with_paths(flat["agg"])):
        assert torch.equal(_bits(torch.as_tensor(a)), _bits(torch.as_tensor(b))), path
    assert torch.equal(_bits(tm["loss"]), _bits(fm["loss"]))
    assert torch.equal(_bits(tm["client_loss"]), _bits(fm["client_loss"]))


def test_fedsgd_tree_round_equals_flat_round():
    cfg = TINY
    out = {}
    for layout in ("flat", "tree"):
        fed = _fed("torch", "fedsgd", state_layout=layout)
        state = rounds.make_state(cfg, fed, adamw(3e-3), device="cpu")
        fr = rounds.build_fed_round(cfg, fed, adamw(3e-3))
        for r in range(2):
            state, m = fr(state, rounds.merge_clients(_toks(r)), torch.from_numpy(WEIGHTS))
        out[layout] = state, m
    (flat, fm), (tree, tm) = out["flat"], out["tree"]
    agg = rounds.make_aggregator(cfg, _fed("torch", "fedsgd"))
    for (path, x), (_, i) in zip(flatten_with_paths(tree["params"]),
                                 flatten_with_paths(agg.ctx.template)):
        assert x.shape == tuple(i.shape), path  # one shared copy, no client dim
    assert tree["opt"]["t"].dim() == 0 and int(tree["opt"]["t"]) == 2
    again = rounds.flat_state(agg, tree)
    assert torch.equal(_bits(again["params"]), _bits(flat["params"]))
    for k in ("m", "v"):
        assert torch.equal(_bits(again["opt"][k]), _bits(flat["opt"][k]))
    assert torch.equal(_bits(tm["loss"]), _bits(fm["loss"]))


# ------------------------- the tree state's edges ---------------------------

def test_tree_state_shape_specs_and_edges_are_the_references():
    jcfg, cfg = LM
    for mode, jopt, opt in (("eq6", jadamw(), adamw()), ("dense", jsgd(), sgd()),
                            ("fedsgd", jsgd(), sgd())):
        jfed, fed = _fed("jax", mode), _fed("torch", mode)
        jt = JR.state_template(jcfg, jfed, jopt, jnp.float32)
        t = rounds.state_template(cfg, fed, opt, torch.float32)
        shapes = lambda tree: {p: tuple(x.shape) for p, x in flatten_with_paths(tree)}
        for key in ("params", "opt", "agg"):
            assert shapes(t[key]) == shapes(jax.tree.map(lambda s: s, jt[key])), (mode, key)
        jspecs = JR.state_pspecs(jcfg, jfed, jopt)
        specs = rounds.state_pspecs(cfg, fed, opt)
        ref = _ref_specs(jspecs["params"])
        for path, s in flatten_with_paths(specs["params"]):
            assert tuple(s) == tuple(ref[path]), (mode, path)
        assert specs["opt"].keys() == jspecs["opt"].keys()
    # make_state: the flat state's numbers, as trees; unpacked_params passes it through
    fed = _fed("torch", "eq6")
    tree = rounds.make_state(cfg, fed, adamw(), device="cpu")
    flat = rounds.make_state(cfg, dataclasses.replace(fed, state_layout="flat"), adamw(), device="cpu")
    agg = rounds.make_aggregator(cfg, fed)
    assert torch.equal(packing.pack(agg.ctx.spec, tree["params"]), flat["params"])
    assert torch.equal(tree["agg"]["prev_sums"], flat["agg"]["prev_sums"])
    assert tree["opt"]["t"].shape == (C,)
    assert rounds.unpacked_params(cfg, fed, tree) is tree["params"]
    # a stateless aggregator keeps no aggregator state
    assert rounds.make_state(cfg, _fed("torch", "dense"), sgd(), device="cpu")["agg"] == {}
    with pytest.raises(ValueError, match="flat|tree"):
        rounds.make_aggregator(cfg, _fed("torch", state_layout="packed"))


def _ref_specs(tree) -> dict:
    """path -> entries of each ``PartitionSpec`` of a reference spec tree."""
    from jax.sharding import PartitionSpec

    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(spec)
            for path, spec in leaves}


def test_tree_state_carry_over_round_trips_bit_exact():
    jcfg = LM[0]
    for jopt in (jsgd(1e-2), jadamw(1e-3)):
        st = jax.jit(lambda k: JR.make_state(jcfg, _fed("jax", "dense"), jopt, k))(jax.random.key(0))
        jp, jo = jax.tree.map(np.asarray, st["params"]), jax.tree.map(lambda x: np.asarray(x) + 0.5,
                                                                      st["opt"])
        p, o = convert.tree_state_from_reference(jp, jo)
        back_p, back_o = convert.tree_state_to_reference(p, o)
        for a, b in zip(jax.tree.leaves(back_p), jax.tree.leaves(jp)):
            np.testing.assert_array_equal(a, b)
        assert jax.tree.structure(back_o) == jax.tree.structure(jo)
        for a, b in zip(jax.tree.leaves(back_o), jax.tree.leaves(jo)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        half, _ = convert.tree_state_from_reference(jp, jo, rows=slice(2, 4))
        assert all(x.shape[0] == 2 for _, x in flatten_with_paths(half))


def test_server_runs_tree_rounds_and_serves_row_0():
    """``FLServer`` over a tree state: its records and its global model are
    the flat server's, bit for bit; the async engines refuse the layout."""
    cfg = YOLO[1]
    outs = {}
    for layout in ("flat", "tree"):
        fed = _fed("torch", "eq6", n_clients=3, topn=4, participation="masked",
                   state_layout=layout)
        srv = FLServer(cfg, fed, sgd(1e-2), seed=0, device="cpu")
        gen = pipeline.fed_batches(cfg, fed, batch=1, seq=0, img_size=32)
        recs = [srv.run_round(next(gen)) for _ in range(2)]
        outs[layout] = recs, srv.global_params().state_dict()
    for a, b in zip(outs["tree"][0], outs["flat"][0]):
        assert (a.loss, a.participants, a.weights) == (b.loss, b.participants, b.weights)
    for k, v in outs["flat"][1].items():
        assert torch.equal(outs["tree"][1][k], v), k
    fedsgd = FLServer(cfg, _fed("torch", "fedsgd", n_clients=3), sgd(1e-2), device="cpu")
    assert set(fedsgd.global_params().state_dict()) == set(outs["flat"][1])
    with pytest.raises(ValueError, match="state_layout"):
        FLServer(cfg, _fed("torch", "dense", mode="async", buffer_size=2), sgd(), device="cpu")


# ----------------------- the slice against the reference --------------------

@pytest.mark.parametrize("mode,opt", [("eq6", "adamw"), ("quant8", "sgd")])
def test_two_tree_rounds_match_reference(mode, opt):
    """fedyolov3, C 3, 2 local steps, from the reference's tree state."""
    jcfg, cfg = YOLO
    kw = dict(n_clients=3, local_steps=2, topn=4)
    jfed, fed = _fed("jax", mode, **kw), _fed("torch", mode, **kw)
    jopt, topt = (jadamw(1e-3), adamw(1e-3)) if opt == "adamw" else (jsgd(1e-2), sgd(1e-2))
    st = jax.jit(lambda k: JR.make_state(jcfg, jfed, jopt, k))(jax.random.key(0))
    p, o = convert.tree_state_from_reference(jax.tree.map(np.asarray, st["params"]),
                                             jax.tree.map(np.asarray, st["opt"]))
    state = {"params": p, "opt": o, "round": 0,
             "agg": convert.agg_state_from_reference(jax.tree.map(np.asarray, st["agg"]))}
    jround = jax.jit(JR.build_fed_round(jcfg, jfed, jopt))
    tround = rounds.build_fed_round(cfg, fed, topt)
    gen, _, _ = jpipeline.detection_suite(jcfg, jfed, batch=2, img_size=32, pool_scenes=24)
    w = rounds.uniform_weights(3)
    for r in range(2):
        b = next(gen)
        st, jm = jround(st, jax.tree.map(jnp.asarray, b), jnp.asarray(w.numpy()))
        state, tm = tround(state, rounds.to_device(b, "cpu"), w)
        assert state["round"] == int(st["round"]) == r + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["client_loss"].numpy(), np.asarray(jm["client_loss"]),
                                   rtol=1e-5)
    gp, go = convert.tree_state_to_reference(state["params"], state["opt"])
    a = np.concatenate([x.ravel() for _, x in flatten_with_paths(gp)])
    b = np.concatenate([np.asarray(x).ravel() for _, x in flatten_with_paths(st["params"])])
    off = ~np.isclose(a, b, rtol=1e-4, atol=1e-6)
    print(f"{mode}: {int(off.sum())} of {a.size} params off rtol 1e-4 / atol 1e-6")
    if mode == "quant8":  # a flipped rounding: 1 in 10^4 elements, one weighted step
        assert off.sum() <= 1e-4 * a.size
        np.testing.assert_allclose(a[off], b[off], rtol=0, atol=1e-4)
    else:
        assert not off.any()
    assert go.keys() == st["opt"].keys()
    for a, b in zip(jax.tree.leaves(go), jax.tree.leaves(st["opt"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    if mode == "eq6":
        np.testing.assert_allclose(state["agg"]["prev_sums"].numpy(),
                                   np.asarray(st["agg"]["prev_sums"]), rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_allclose(state["agg"]["base"].numpy(), np.asarray(st["agg"]["base"]),
                                   rtol=1e-4, atol=1e-6)
