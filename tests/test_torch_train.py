"""The port's training path (``repro_torch``: loss, optimizers, K1,
aggregators, the flat round, the server and the launcher) held against the
reference on identical inputs.

Both packages start from the reference's own initial state, carried across
by ``models.convert.state_from_reference``; data comes from the same NumPy
seeds. The model is fedyolov3 cut to base width 8 and 3 stages, at 32x32
images, 3 clients. Tolerances, each stated where it is used:

- the loss and its gradients: two f32 convolution implementations sum in
  different orders (rtol 1e-4 on the loss, atol 2e-4 on gradients);
- optimizer steps on identical inputs: rtol 1e-6 / atol 1e-7 (the global
  norm is summed in another order);
- K1's plain version against the reference and its Pallas kernel: the
  reference's own rtol 1e-5 / atol 1e-5 (``tests/test_aggregators.py``);
  an all-ones mask against None: bitwise;
- aggregators: rtol 1e-5 / atol 1e-6 (the weighted chains round
  differently from XLA's fused ones); state rows (base, ef, server moments)
  likewise, round counters exactly; topk_ef at frac 1.0 and quant4 skip
  against dense: bitwise;
- whole rounds: loss rtol 1e-5, params atol 1e-6 / rtol 1e-4 (gradient
  differences after two local steps and two rounds, measured max 5e-8 on
  weights of size 0.6).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.core import aggregators as jaggregators
from repro.core import packing as jpacking
from repro.core import rounds as jrounds
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.core.scheduler import TaskScheduler as JTaskScheduler
from repro.core.server import FLServer as JFLServer
from repro.data import darknet as jdarknet
from repro.data import pipeline as jpipeline
from repro.kernels import pack as jpack
from repro.kernels import ref as jref
from repro.models import params as jparams
from repro.models import yolov3 as jyolo
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro_torch.configs import get_arch
from repro_torch.core import aggregators, packing, rounds
from repro_torch.core.scheduler import SchedulerConfig, TaskScheduler
from repro_torch.core.server import FLServer
from repro_torch.data import pipeline
from repro_torch.kernels import pack as kpack
from repro_torch.kernels import ref as kref
from repro_torch.launch import train
from repro_torch.models import convert, params, yolov3
from repro_torch.optim import adamw, sgd

JCFG = dataclasses.replace(jget_arch("fedyolov3").reduced(), d_model=8, n_layers=3)
TCFG = dataclasses.replace(get_arch("fedyolov3").reduced(), d_model=8, n_layers=3)
IMG = 32
C = 3


def _fed(pkg, **kw):
    base = dict(n_clients=C, local_steps=2, aggregation="eq6", topn=4,
                client_axis="data", data_axis=None)
    base.update(kw)
    return (rounds.FedConfig if pkg == "torch" else jrounds.FedConfig)(**base)


def _ref_tree(seed=0):
    p = jparams.init_params(jyolo.template(JCFG), jax.random.key(seed), jnp.float32)
    return jax.tree.map(np.asarray, p)


def _step_batch(seed=0, b=2):
    """One local step's batch as NumPy: images + per-scale targets."""
    rng = np.random.default_rng(seed)
    from repro.data import synthetic as jsynthetic

    imgs, boxes = jsynthetic.scene_images(rng, b, IMG, JCFG.vocab_size)
    tgts = jdarknet.build_targets(boxes, jyolo.grid_sizes(JCFG, IMG), JCFG.n_heads,
                                  JCFG.vocab_size, jyolo.ANCHORS)
    return {"images": imgs, "targets": tgts}


def _spec():
    return packing.build_pack_spec(TCFG, yolov3.template(TCFG))


def _jpack_row(tree):
    """A reference tree -> its packed (N,) row."""
    return np.array(jpacking.pack(jpacking.build_pack_spec(JCFG, jyolo.template(JCFG)),
                                  jax.tree.map(lambda x: x[None], tree)))[0]


# ------------------------------ loss ----------------------------------------

def test_yolo_loss_value_and_grads_match_reference():
    tree, batch = _ref_tree(1), _step_batch(1)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jyolo.yolo_loss(p, jax.tree.map(jnp.asarray, batch), JCFG), has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    spec = _spec()
    flat = torch.tensor(_jpack_row(tree), requires_grad=True)
    loss, metrics = yolov3.yolo_loss(packing.unpack_views(spec, flat, yolov3.template(TCFG)),
                                     rounds.to_device(batch, "cpu"), TCFG)
    (g,) = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    jg = _jpack_row(jax.tree.map(np.asarray, jgrads))
    assert np.abs(jg).max() > 1.0  # the gradient is not trivially small
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-3, atol=2e-4)


def test_iou_matches_reference():
    rng = np.random.default_rng(2)
    a = np.concatenate([rng.uniform(0, 1, (5, 7, 2)), rng.uniform(-0.1, 0.5, (5, 7, 2))], -1)
    b = np.concatenate([rng.uniform(0, 1, (5, 7, 2)), rng.uniform(-0.1, 0.5, (5, 7, 2))], -1)
    a, b = a.astype(np.float32), b.astype(np.float32)
    np.testing.assert_array_equal(yolov3.iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(jyolo.iou(a, b)))
    np.testing.assert_allclose(
        yolov3.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jyolo.pairwise_iou(a, b)), rtol=1e-6, atol=1e-7)


# ------------------------------ optimizers ----------------------------------

@pytest.mark.parametrize("name", ["sgd", "sgd_m0", "adamw", "adamw_wd_clip"])
def test_optimizer_two_steps_match_reference(name):
    make = {
        "sgd": (lambda m: m.sgd(1e-2)),
        "sgd_m0": (lambda m: m.sgd(1e-2, momentum=0.0)),
        "adamw": (lambda m: m.adamw(1e-3)),
        "adamw_wd_clip": (lambda m: m.adamw(1e-3, weight_decay=0.1, clip_norm=1.0)),
    }[name]
    jopt, opt = make(SimpleNamespace(sgd=jsgd, adamw=jadamw)), make(SimpleNamespace(sgd=sgd, adamw=adamw))
    tree = _ref_tree(2)
    rng = np.random.default_rng(3)
    # norms about 30: the sgd clip (10) and the adamw clip (1) both bite
    grads = [jax.tree.map(lambda x: (rng.normal(size=x.shape) * 0.2).astype(np.float32), tree)
             for _ in range(2)]
    jp, js = jax.tree.map(jnp.asarray, tree), None
    js = jopt.init(jp)
    packed = torch.from_numpy(_jpack_row(tree))[None].clone()
    state = opt.init(packed)
    for g in grads:
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, g), js)
        opt.update(packed[0], torch.from_numpy(_jpack_row(g)), {k: v[0] for k, v in state.items()})
    np.testing.assert_allclose(packed[0].numpy(), _jpack_row(jax.tree.map(np.asarray, jp)),
                               rtol=1e-6, atol=1e-7)
    for k, v in state.items():
        ref = js[k]
        if v.dim() == 2:
            ref = _jpack_row(jax.tree.map(np.asarray, ref))
            np.testing.assert_allclose(v[0].numpy(), ref, rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            assert int(v[0]) == int(ref) == 2, k


# ------------------------------ K1 ------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("Cn,N,B", [(4, 3000, 3), (3, 1024, 5), (2, 77, 2)])
def test_bucket_reduce_plain_version_matches_reference(Cn, N, B, masked):
    rng = np.random.default_rng(N)
    x = rng.normal(size=(Cn, N)).astype(np.float32)
    wm = rng.random((Cn, B)).astype(np.float32)
    ids = rng.integers(0, B, N).astype(np.int32)
    mask = (np.arange(Cn) % 2 == 0).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    r_num, r_den = jref.packed_bucket_reduce(jnp.asarray(x), jnp.asarray(wm), jnp.asarray(ids), jm)
    k_num, k_den = jpack.packed_bucket_reduce(jnp.asarray(x), jnp.asarray(wm), jnp.asarray(ids), jm,
                                              block_n=256, interpret=True)
    tm = None if mask is None else torch.from_numpy(mask)
    before = kpack.packed_bucket_reduce.launches
    num, den = kpack.packed_bucket_reduce(torch.from_numpy(x), torch.from_numpy(wm),
                                          torch.from_numpy(ids), tm)
    assert kpack.packed_bucket_reduce.launches == before  # the CPU takes the plain version
    for ours, ref in ((num, r_num), (den, r_den), (num, k_num), (den, k_den)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    ones = kref.packed_bucket_reduce(torch.from_numpy(x), torch.from_numpy(wm),
                                     torch.from_numpy(ids), torch.ones(Cn))
    plain = kref.packed_bucket_reduce(torch.from_numpy(x), torch.from_numpy(wm), torch.from_numpy(ids))
    for a, b in zip(ones, plain):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_bucket_reduce_cuda_kernel_equals_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for Cn, N, B, masked in [(4, 3000, 3, False), (3, 1024, 5, True), (2, 77, 2, True),
                             (3, 13_312_864, 6, True)]:
        g = torch.Generator().manual_seed(N)
        x = torch.randn((Cn, N), generator=g).cuda()
        wm = torch.rand((Cn, B), generator=g).cuda()
        ids = torch.randint(0, B, (N,), generator=g, dtype=torch.int32).cuda()
        mask = (torch.arange(Cn) % 2 == 0).float().cuda() if masked else None
        kern = kpack.packed_bucket_reduce(x, wm, ids, mask)
        plain = kref.packed_bucket_reduce(x, wm, ids, mask)
        torch.cuda.synchronize()
        for a, b in zip(kern, plain):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (Cn, N, B)
    with pytest.raises(ValueError, match="bucket ids"):
        kpack.packed_bucket_reduce(x, wm, torch.full_like(ids, B), mask)


# ------------------------------ aggregators ---------------------------------

# the FedConfig fields of each aggregator case beside its mode: an int is
# static_topn's round phase, a name one of these variants
VARIANTS = {
    "nearest": dict(quant4_mode="nearest"),
    "stochastic": dict(quant4_mode="stochastic", quant4_seed=3),
    "skip": dict(quant4_mode="skip"),
    "int8": dict(secure_domain="int8", secure_session=5),
    "int4": dict(secure_domain="int4", secure_session=5),
    "int8_nomask": dict(secure_domain="int8", secure_mask=False),
    "int4_nomask": dict(secure_domain="int4", secure_mask=False),
    "none": dict(topk_frac=0.1),
    "quant4": dict(topk_frac=0.2, topk_quant="quant4", quant4_mode="stochastic", quant4_seed=1),
    "frac1": dict(topk_frac=1.0),
    "g2_dense": dict(n_clients=4, group_size=2, hier_base="dense"),
    "g2_eq6": dict(n_clients=4, group_size=2, hier_base="eq6"),
    "g2_quant8": dict(n_clients=4, group_size=2, hier_base="quant8"),
    "g1": dict(group_size=1, hier_base="quant8"),
    "gC": dict(group_size=C, hier_base="eq6"),
    "momentum": dict(server_lr=1.0),
    "adam": dict(server_lr=0.02),
    "trim": dict(trim_ratio=0.34),
}


def _case_kw(mode, r):
    kw = dict(aggregation=mode, topn=2)
    kw.update(VARIANTS[r] if isinstance(r, str) else dict(round_idx_static=r))
    return kw


def _multi_bucket_ctx(mode, impl, r=0):
    cfg = SimpleNamespace(n_layers=5, local_global_period=2)

    def make(P):
        return {"blocks": {"g": P((2, 2, 3, 2), ("group", "layer", None, None)),
                           "w": P((4, 6), ("layer", None))},
                "embed": P((7, 4), (None, None)), "z": P((3,), (None,))}

    kw = _case_kw(mode, r)
    t, j = make(params.ParamInfo), make(jparams.ParamInfo)
    tctx = aggregators.AggContext(cfg=cfg, fed=_fed("torch", agg_impl=impl, **kw), template=t,
                                  spec=packing.build_pack_spec(cfg, t))
    jctx = jaggregators.AggContext(cfg=cfg, fed=_fed("jax", **kw), template=j,
                                   spec=jpacking.build_pack_spec(cfg, j))
    return aggregators.get(mode)(tctx), jaggregators.get(mode)(jctx)


CASES = [("eq6", 0), ("dense", 0), ("static_topn", 0), ("static_topn", 1),
         ("quant8", 0), ("quant4", "nearest"), ("quant4", "stochastic"), ("quant4", "skip"),
         ("secure", "int8"), ("secure", "int4"), ("secure", "int8_nomask"),
         ("secure", "int4_nomask"), ("topk_ef", "none"), ("topk_ef", "quant4"),
         ("topk_ef", "frac1"), ("hier", "g2_dense"), ("hier", "g2_eq6"), ("hier", "g2_quant8"),
         ("hier", "g1"), ("hier", "gC"), ("fedavgm", "momentum"), ("fedadam", "adam"),
         ("trimmed_mean", "trim")]
# weights and partial participation by cohort size: the partial mask of 4
# clients empties the first edge group of 2
WEIGHTS = {3: [0.5, 0.2, 0.3], 4: [0.4, 0.1, 0.3, 0.2]}
PARTIAL = {3: [1, 0, 1], 4: [0, 0, 1, 1]}


def assert_state_close(ours, ref, rtol=1e-5, atol=1e-5):
    """An aggregator state of the port against the reference's: round
    counters exactly, every array at the stated tolerance."""
    assert set(ours) == set(ref), (sorted(ours), sorted(ref))
    for k, v in ref.items():
        if isinstance(v, dict):
            assert_state_close(ours[k], v, rtol, atol)
        elif k == "round":
            assert int(ours[k]) == int(v), k
        else:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(v), rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("mask_kind", ["none", "ones", "partial"])
@pytest.mark.parametrize("which", ["fedyolov3", "multi_bucket"])
@pytest.mark.parametrize("mode,r", CASES)
def test_aggregators_match_reference(mode, r, which, mask_kind):
    """Both reductions: ``agg_impl="ref"`` (plain torch) and ``"kernel"``
    (K1, K4, K6, K7 or K8: their plain versions on the CPU)."""
    kw = _case_kw(mode, r)
    if which == "fedyolov3":
        jagg = jrounds.make_aggregator(JCFG, _fed("jax", **kw))
        aggs = [rounds.make_aggregator(TCFG, _fed("torch", agg_impl=i, **kw)) for i in ("ref", "kernel")]
    else:
        jagg = _multi_bucket_ctx(mode, "ref", r)[1]
        aggs = [_multi_bucket_ctx(mode, i, r)[0] for i in ("ref", "kernel")]
    N, Cn = jagg.ctx.spec.n_total, jagg.ctx.fed.n_clients
    rng = np.random.default_rng(11)
    x0 = rng.normal(size=(Cn, N)).astype(np.float32)
    x = (x0 + rng.normal(size=(Cn, N)) * 0.05).astype(np.float32)
    w = np.array(WEIGHTS[Cn], np.float32)
    mask = {"none": None, "ones": np.ones(Cn, np.float32),
            "partial": np.array(PARTIAL[Cn], np.float32)}[mask_kind]
    jout, jst = jagg.aggregate(jnp.asarray(x), jnp.asarray(w), jagg.init_state(jnp.asarray(x0)),
                               None if mask is None else jnp.asarray(mask))
    tmask = None if mask is None else torch.from_numpy(mask)
    np.testing.assert_array_equal(aggs[0]._masked_weights(torch.from_numpy(w), tmask).numpy(),
                                  np.asarray(jagg._masked_weights(jnp.asarray(w), mask)))
    for agg in aggs:
        packed = torch.from_numpy(x.copy())
        out, st = agg.aggregate(packed, torch.from_numpy(w), agg.init_state(torch.from_numpy(x0)), tmask)
        assert out.data_ptr() == packed.data_ptr()  # the dispatch is written in place
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
        assert_state_close(st, jst)
        if r in ("frac1", "skip"):  # these collapse to dense, bit for bit
            dense = dataclasses.replace(agg.ctx, fed=dataclasses.replace(agg.ctx.fed, aggregation="dense"))
            ref_out, _ = aggregators.get("dense")(dense).aggregate(
                torch.from_numpy(x.copy()), torch.from_numpy(w), {}, tmask)
            assert torch.equal(out.view(torch.int32), ref_out.view(torch.int32))
        if mask_kind == "ones":  # all ones is None, bit for bit
            again, _ = agg.aggregate(torch.from_numpy(x.copy()), torch.from_numpy(w),
                                     agg.init_state(torch.from_numpy(x0)), None)
            assert torch.equal(again.view(torch.int32), out.view(torch.int32))
        if mask_kind == "partial":  # a masked-out row cannot move the aggregate
            junk = x.copy()
            junk[mask == 0] = 1e3
            moved, _ = agg.aggregate(torch.from_numpy(junk), torch.from_numpy(w),
                                     agg.init_state(torch.from_numpy(x0)), tmask)
            np.testing.assert_array_equal(moved.numpy()[mask > 0], out.numpy()[mask > 0])


def test_unported_configurations_raise():
    with pytest.raises(NotImplementedError, match="slice 9"):
        rounds.make_aggregator(TCFG, _fed("torch", state_layout="tree"))
    # fedsgd, compact participation and the client mesh are ported
    # (tests/test_torch_participation.py); a mesh that shards the flat dim is not
    for kw in (dict(aggregation="fedsgd"), dict(participation="compact")):
        assert rounds.make_aggregator(TCFG, _fed("torch", **kw)).ctx.fed == _fed("torch", **kw)
    # microbatches are ported (tests/test_torch_lm_train.py), and so is
    # training every LM family (tests/test_torch_lm_families_train.py)
    moe_cfg = get_arch("granite-moe-1b-a400m").reduced()
    assert rounds.make_aggregator(moe_cfg, _fed("torch")).ctx.cfg == moe_cfg
    with pytest.raises(ValueError, match="microbatches"):
        rounds.make_aggregator(TCFG, _fed("torch", microbatches=0))
    with pytest.raises(ValueError, match="the port has"):
        rounds.make_aggregator(TCFG, _fed("torch", aggregation="no_such_mode"))
    model_axis = SimpleNamespace(mesh_dim_names=("data", "model"), size=lambda d: (1, 2)[d])
    with pytest.raises(NotImplementedError, match="slice 8"):
        rounds.build_fed_round(TCFG, _fed("torch"), sgd(), mesh=model_axis)
    # idx rides only under compact participation
    assert "idx" not in rounds.participation_input(_fed("torch"), np.ones(C), np.ones(C) / C,
                                                   idx=np.arange(C))
    # async mode is ported (tests/test_torch_async.py), and so is a shared
    # clock (tests/test_torch_platform.py): a sync round advances it
    assert FLServer(TCFG, _fed("torch", mode="async", buffer_size=2), sgd(),
                    device="cpu").engine is not None
    from repro_torch.core.simclock import SimClock

    clock = SimClock()
    srv = FLServer(TCFG, _fed("torch", local_steps=1), sgd(), device="cpu", clock=clock)
    assert srv.clock is clock
    srv.run_round(next(pipeline.fed_batches(TCFG, srv.fed, batch=1, seq=0, img_size=IMG)))
    assert clock.now() > 0 and srv.load_model.t == clock.now()


# ------------------------------ state and rounds ----------------------------

def test_state_carry_over_round_trips_bit_exact():
    jspec = jpacking.build_pack_spec(JCFG, jyolo.template(JCFG))
    rng = np.random.default_rng(3)
    stacked = jax.tree.map(lambda i: rng.normal(size=(C,) + i.shape).astype(np.float32),
                           jyolo.template(JCFG), is_leaf=jparams.is_info)
    packed = np.asarray(jpacking.pack(jspec, stacked))
    for jopt in (jsgd(1e-2), jadamw(1e-3), jsgd(1e-2, momentum=0.0)):
        # the reference's client-stacked optimizer state, moments made non-zero
        opt = jax.tree.map(lambda x: np.asarray(x) + 0.5, jax.vmap(jopt.init)(stacked))
        p, o = convert.state_from_reference(TCFG, packed, opt)
        assert p.shape == (C, _spec().n_total)
        assert all(v.shape in ((C, _spec().n_total), (C,)) for v in o.values())
        back_p, back_o = convert.state_to_reference(TCFG, p, o)
        np.testing.assert_array_equal(back_p, packed)
        ref_leaves, ref_def = jax.tree.flatten(opt)
        ours_leaves, ours_def = jax.tree.flatten(back_o)
        assert ours_def == ref_def
        for a, b in zip(ours_leaves, ref_leaves):
            np.testing.assert_array_equal(a, b)
        if "mu" in o:  # a moment's row is the reference's tree, packed
            np.testing.assert_array_equal(o["mu"].numpy(), np.asarray(jpacking.pack(jspec, opt["mu"])))
    # the edge helper: the flat state's client-stacked HWIO tree
    ours = rounds.unpacked_params(TCFG, _fed("torch"), {"params": torch.tensor(packed)})
    ref = jrounds.unpacked_params(JCFG, _fed("jax"), {"params": jnp.asarray(packed)})
    for (path, a), (_, b) in zip(params.flatten_with_paths(ours),
                                 params.flatten_with_paths(jax.tree.map(np.asarray, ref))):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)


def _carried_state(st):
    p, o = convert.state_from_reference(TCFG, np.asarray(st["params"]),
                                        jax.tree.map(np.asarray, st["opt"]))
    agg = {k: torch.tensor(np.asarray(v)) for k, v in st["agg"].items()}
    return {"params": p, "opt": o, "agg": agg, "round": int(st["round"])}


@pytest.mark.parametrize("participation", ["full", "masked"])
def test_two_flat_rounds_match_reference(participation):
    jfed, tfed = _fed("jax", participation=participation), _fed("torch", participation=participation)
    st = jax.jit(lambda k: jrounds.make_state(JCFG, jfed, jsgd(1e-2), k))(jax.random.key(0))
    tstate = _carried_state(st)
    jround = jax.jit(jrounds.build_fed_round(JCFG, jfed, jsgd(1e-2)))
    tround = rounds.build_fed_round(TCFG, tfed, sgd(1e-2))
    gen, _, _ = jpipeline.detection_suite(JCFG, jfed, batch=2, img_size=IMG, pool_scenes=24)
    masks = [np.array([1, 0, 1], np.float32), np.array([0, 1, 1], np.float32)]
    for r in range(2):
        b = next(gen)
        if participation == "full":  # a bare weight vector: mask None
            jpart, tpart = jnp.asarray(rounds.uniform_weights(C).numpy()), rounds.uniform_weights(C)
        else:
            m = masks[r]
            jpart = jrounds.participation_input(jfed, m, m / m.sum())
            tpart = rounds.participation_input(tfed, m, m / m.sum())
        st, jm = jround(st, jax.tree.map(jnp.asarray, b), jpart)
        tstate, tm = tround(tstate, rounds.to_device(b, "cpu"), tpart)
        assert tstate["round"] == int(st["round"]) == r + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["client_loss"].numpy(), np.asarray(jm["client_loss"]), rtol=1e-5)
        if participation == "masked":  # a client that sat out reports loss 0
            assert (tm["client_loss"].numpy()[masks[r] == 0] == 0).all()
        np.testing.assert_allclose(tstate["params"].numpy(), np.asarray(st["params"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tstate["agg"]["prev_sums"].numpy(),
                                   np.asarray(st["agg"]["prev_sums"]), rtol=1e-5, atol=1e-4)
        _, mu = convert.state_to_reference(TCFG, tstate["params"], tstate["opt"])
        for a, b_ in zip(jax.tree.leaves(mu), jax.tree.leaves(st["opt"])):
            np.testing.assert_allclose(a, np.asarray(b_), rtol=1e-4, atol=1e-5)


def test_server_rounds_match_reference():
    sched = dict(max_participants=2, fairness_rounds=2)
    jfed, tfed = _fed("jax", participation="masked"), _fed("torch", participation="masked")
    jsrv = JFLServer(JCFG, jfed, jsgd(1e-2), seed=0,
                     scheduler=JTaskScheduler(C, JSchedulerConfig(**sched)))
    srv = FLServer(TCFG, tfed, sgd(1e-2), seed=0, device="cpu",
                   scheduler=TaskScheduler(C, SchedulerConfig(**sched)))
    srv.state = _carried_state(jsrv.state)
    jgen, jev, _ = jpipeline.detection_suite(JCFG, jfed, batch=2, img_size=IMG, pool_scenes=24)
    gen, ev, _ = pipeline.detection_suite(TCFG, tfed, batch=2, img_size=IMG, pool_scenes=24)
    for _ in range(3):
        jrec = jsrv.run_round(jax.tree.map(jnp.asarray, next(jgen)))
        rec = srv.run_round(next(gen))
        assert rec.participants == jrec.participants
        assert rec.weights == jrec.weights and rec.loads == jrec.loads
        np.testing.assert_allclose(rec.loss, jrec.loss, rtol=1e-5)
    # mAP of the global model on the holdout: the two decodes see weights
    # 1e-6 apart, which leaves ranking, NMS and matching unchanged here
    jrec, rec = jsrv.evaluate_round(jev, max_detections=16), srv.evaluate_round(ev, max_detections=16)
    assert rec.round_idx == jrec.round_idx == 2
    np.testing.assert_allclose(rec.map50, jrec.map50, atol=1e-6)
    np.testing.assert_allclose(rec.per_client_map, jrec.per_client_map, atol=1e-6)
    np.testing.assert_allclose(srv.scheduler.quality, jsrv.scheduler.quality, rtol=1e-4, atol=1e-4)
    # the dispatchable global model is row 0 in the reference's layout
    glob = convert.to_reference(srv.global_params())
    for (path, a), (_, b) in zip(params.flatten_with_paths(glob),
                                 params.flatten_with_paths(jax.tree.map(np.asarray,
                                                                        jsrv.global_params()))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=path)


# ------------------------------ launcher ------------------------------------

def test_launcher_trains_evaluates_checkpoints_and_serves(tmp_path, capsys):
    summary = train.main(["--task", "detection", "--device", "cpu", "--rounds", "6", "--clients", "3",
                          "--img-size", "32", "--batch", "2", "--participation", "masked",
                          "--max-participants", "2", "--fairness-rounds", "3", "--optimizer", "sgd",
                          "--lr", "1e-3", "--topn", "4", "--eval-every", "5",
                          "--store", str(tmp_path / "cos")])
    out = capsys.readouterr().out
    assert summary["rounds"] == 6 and np.isfinite(summary["final_loss"])
    assert summary["stored_rounds"] == [0, 5]
    assert summary["served_version"] == 6
    assert 0.0 <= summary["final_map"] <= 1.0 and len(summary["per_client_map"]) == 3
    assert out.count("mAP@0.5") >= 3  # rounds 0 and 5 and the monitor's line
    assert '"final_loss"' in out.splitlines()[-1]


# the launcher's socket wire and its durability (slice 5), on the host: a
# run of the reduced qwen3-1.7b over 2 worker processes' clients, each with
# one intra-op thread
SOCKET_RUN = ["--device", "cpu", "--arch", "qwen3-1.7b", "--clients", "2", "--buffer-size", "1",
              "--rounds", "2", "--batch", "1", "--seq", "8"]


def _reference_json_keys(function: str) -> set:
    """The keys of the JSON dict the reference launcher's ``function``
    prints, read from its source (running it would start JAX workers)."""
    import ast
    import inspect

    from repro.launch import train as jtrain

    tree = ast.parse(inspect.getsource(getattr(jtrain, function)))
    return {k.value for node in ast.walk(tree) if isinstance(node, ast.Dict) for k in node.keys}


@pytest.mark.parametrize("flags", [["--mode", "async", "--transport", "socket"],
                                   ["--transport", "socket"], ["--restore", "x"],
                                   ["--mode", "async", "--record-schedule", "x"]],
                         ids=["socket", "socket-needs-async", "restore", "record-inproc"])
def test_launcher_paths_of_slice_5(flags, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    record = tmp_path / "run.schedule.json"
    if flags == ["--transport", "socket"]:  # the reference's ap.error, as a ValueError
        with pytest.raises(ValueError, match="pass --mode async"):
            train.main(["--device", "cpu", *flags])
        return
    if flags[0] == "--restore":
        durable = tmp_path / "run"
        run = train.main([*SOCKET_RUN, "--mode", "async", "--transport", "socket", "--rounds", "3",
                          "--durable-dir", str(durable), "--snapshot-every", "1",
                          "--fault-plan", "kill@2"])
        assert run["recovered"] and run["rounds"] == 3 and not run["deadline_hit"]
        assert "CRASHED" in capsys.readouterr().out
        got = train.main(["--device", "cpu", "--restore", str(durable)])
        assert set(got) == _reference_json_keys("_restore") | {"device"}
        assert got["version"] == 3 and got["wal_events"] == run["wal_events"] > 0
        assert got["events_replayed"] <= 1 and got["staged_window"] == []
        return
    if "--transport" not in flags:  # in process: the reference writes no schedule either
        got = train.main([*SOCKET_RUN, *flags[:-2], "--record-schedule", str(record)])
        assert got["mode"] == "async" and got["rounds"] == 2 and not record.exists()
        return
    got = train.main([*SOCKET_RUN, *flags, "--wire-codec", "quant8",
                      "--record-schedule", str(record)])
    out = capsys.readouterr().out
    assert set(got) == _reference_json_keys("_run_socket") | {"device"}
    assert (got["rounds"], got["landed"], got["wire_codec"]) == (2, 2, "quant8")
    assert not got["deadline_hit"] and got["bytes_up"] > 0 and got["device"] == "cpu"
    assert "  wire     2 flushes   2 landed / 0 dropped" in out
    again = train.main(["--device", "cpu", "--replay-schedule", str(record)])
    assert again["flushes"] == 2 and again["deterministic"]
    np.testing.assert_allclose(again["final_loss"], got["final_loss"], rtol=1e-6)


def test_launcher_parsers_take_the_reference_flags_and_defaults(monkeypatch):
    """Every flag of the reference launcher with its default, choices and
    type, ``--print-plan`` included (the launch tooling), plus the port's
    ``--device`` and ``--seed``."""
    import argparse
    import sys

    from repro.launch import train as jtrain

    class Grabbed(Exception):
        pass

    def grab(self, args=None, namespace=None):
        raise Grabbed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        m.setattr(sys, "argv", ["train"])
        with pytest.raises(Grabbed) as ei:
            jtrain.main()
    ref = ei.value.args[0]

    def flags(parser):
        return {a.option_strings[-1]: (a.dest, a.default, a.choices and list(a.choices), a.type,
                                        a.nargs, a.const, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    ours, theirs = flags(train.build_parser()), flags(ref)
    assert set(ours) - set(theirs) == {"--device", "--seed"}
    assert set(theirs) - set(ours) == set()
    for k in set(ours) & set(theirs):
        assert ours[k] == theirs[k], k
