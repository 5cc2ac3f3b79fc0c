"""The port's training path (``repro_torch``: loss, optimizers, K1 and the
aggregators) held against the reference on identical inputs; the rounds,
the server and the launcher are ``tests/test_torch_train_rounds.py``'s.

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
  against dense: bitwise.
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
from repro.core import aggregators as jaggregators
from repro.core import packing as jpacking
from repro.core import rounds as jrounds
from repro.data import darknet as jdarknet
from repro.kernels import pack as jpack
from repro.kernels import ref as jref
from repro.models import params as jparams
from repro.models import yolov3 as jyolo
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro_torch.configs import get_arch
from repro_torch.core import aggregators, packing, rounds
from repro_torch.core.server import FLServer
from repro_torch.data import pipeline
from repro_torch.kernels import pack as kpack
from repro_torch.kernels import ref as kref
from repro_torch.models import params, yolov3
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
    # the tree layout is ported (tests/test_torch_tree.py)
    tree = rounds.make_aggregator(TCFG, _fed("torch", state_layout="tree"))
    assert tree.ctx.fed.state_layout == "tree" and tree.ctx.cols is None
    # fedsgd, compact participation and the client mesh are ported
    # (tests/test_torch_participation.py)
    for kw in (dict(aggregation="fedsgd"), dict(participation="compact")):
        assert rounds.make_aggregator(TCFG, _fed("torch", **kw)).ctx.fed == _fed("torch", **kw)
    # microbatches are ported (tests/test_torch_lm_train_rounds.py), and so is
    # training every LM family (tests/test_torch_lm_families_train.py)
    moe_cfg = get_arch("granite-moe-1b-a400m").reduced()
    assert rounds.make_aggregator(moe_cfg, _fed("torch")).ctx.cfg == moe_cfg
    with pytest.raises(ValueError, match="microbatches"):
        rounds.make_aggregator(TCFG, _fed("torch", microbatches=0))
    with pytest.raises(ValueError, match="the port has"):
        rounds.make_aggregator(TCFG, _fed("torch", aggregation="no_such_mode"))
    # and so is a mesh whose model axis shards the flat dim: the round builds
    # on one (tests/test_torch_sharded.py runs it on 2 and 4 ranks)
    model_axis = SimpleNamespace(mesh_dim_names=("data", "model"), size=lambda d: (1, 2)[d],
                                 get_local_rank=lambda d: 0)
    assert callable(rounds.build_fed_round(TCFG, _fed("torch"), sgd(), mesh=model_axis))
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
