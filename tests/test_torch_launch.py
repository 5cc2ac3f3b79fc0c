"""The port's launch tooling (``repro_torch.launch.{mesh,specs,op_analysis,
roofline,dryrun}``, ``models.shard_ctx``, the plan pieces of
``configs``, ``models.params``, ``core.rounds`` and ``models.serving``, and
the launcher's ``--print-plan``) held against the reference on the CPU.

Exact, field by field or leaf by leaf: the shape matrix, every plan with
its name (every applicable arch x shape x mesh and the variants
``tests/test_launch.py`` builds), every param spec under the default and
FSDP rules, the step inputs' shapes, dtypes and specs, the caches' specs,
the per-device state bytes of every train plan (the port's packed moments
against the reference's moment trees), the model-FLOP arithmetic and the
``--print-plan`` text. The roofline's terms are the reference's scaled by
the ratio of the two chips' constants (rtol 1e-12).

The op counter: the FLOPs of a reduced train round (qwen3, mamba2 and
granite-moe on their plain attention and SSD paths) traced on ``meta``
agree with the reference's ``hlo_analysis.analyze`` of the same jitted
round on a 1-device mesh within 1% (the port's and the reference's
elementwise-free product counts differ by the reference's few fused
reductions: 0.02-0.16% seen); every layer is counted (the trace of n layers
is n times a layer plus the rest, exactly); a round counted on the host
counts what its ``meta`` trace counts; and the ``meta`` branches of K9,
K10 and K1 give their plain versions' shapes and dtypes.
"""
import dataclasses
import json

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.core import rounds as JR
from repro.launch import hlo_analysis as jhlo
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models import params as jparams
from repro.models import serving as jserving
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.core import packing
from repro_torch.core import rounds as R
from repro_torch.kernels import costs as kcosts
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import pack as kpack
from repro_torch.kernels import ref as kref
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import dryrun, mesh, op_analysis, roofline, specs, train
from repro_torch.models import params as mp
from repro_torch.models import serving, shard_ctx
from repro_torch.optim import adamw

ARCHS = [a.name for a in configs.ASSIGNED]
ALL_ARCHS = ARCHS + ["fedyolov3"]
REF_VARIANTS = [("granite-moe-1b-a400m", "train_4k", True, v) for v in
                ("moe_sort", "moe_ep", "moe_sort_ep")] + [
    ("gemma3-27b", "train_4k", False, "zero1"), ("qwen3-1.7b", "train_4k", False, "micro2")]


def _plans():
    for arch in ALL_ARCHS:
        for shape in configs.SHAPES.values():
            if configs.shape_applicable(configs.get_arch(arch), shape)[0]:
                for multi in (False, True):
                    yield arch, shape.name, multi, ""
    yield from REF_VARIANTS


def _ref_leaves(tree):
    """path -> leaf of a reference tree ("a/b/0" paths, the port's order)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[key] = leaf
    return out


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _spec(p) -> tuple:
    return tuple(p)


# ------------------------------ configs and plans ---------------------------

def test_shape_matrix_is_the_references():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in ALL_ARCHS:
        for name in configs.SHAPES:
            assert configs.shape_applicable(configs.get_arch(arch), configs.get_shape(name)) == \
                jconfigs.shape_applicable(jconfigs.get_arch(arch), jconfigs.get_shape(name))
    with pytest.raises(KeyError):
        configs.get_shape("train_8k")


def _same_plan(ours, ref):
    assert ours.name == ref.name
    assert dataclasses.asdict(ours.arch) == dataclasses.asdict(ref.arch)
    assert dataclasses.asdict(ours.shape) == dataclasses.asdict(ref.shape)
    assert (ours.multi_pod, ours.kind, ours.rules, ours.dp_axes, ours.aggregation,
            ours.opt_rules) == (ref.multi_pod, ref.kind, ref.rules, ref.dp_axes,
                                ref.aggregation, ref.opt_rules)
    assert (ours.fed is None) == (ref.fed is None)
    if ours.fed is not None:
        assert dataclasses.asdict(ours.fed) == dataclasses.asdict(ref.fed)


def test_every_plan_is_the_references():
    n = 0
    for arch, shape, multi, variant in _plans():
        _same_plan(specs.make_plan(arch, shape, multi, variant=variant),
                   jspecs.make_plan(arch, shape, multi, variant=variant))
        n += 1
    pairs = sum(jconfigs.shape_applicable(jconfigs.get_arch(a), s)[0]
                for a in ALL_ARCHS for s in jconfigs.SHAPES.values())
    assert n == 2 * pairs + len(REF_VARIANTS) and pairs == 34  # of 44
    for arch in ARCHS:
        assert specs.default_topn(configs.get_arch(arch)) == \
            jspecs.default_topn(jconfigs.get_arch(arch))
    with pytest.raises(ValueError, match="encoder-only"):
        specs.make_plan("hubert-xlarge", "decode_32k", False)


@pytest.mark.parametrize("rules", ["default", "fsdp"])
def test_param_specs_are_the_references_leaf_by_leaf(rules):
    ours_rules = mp.DEFAULT_RULES if rules == "default" else specs.fsdp_rules()
    ref_rules = jparams.DEFAULT_RULES if rules == "default" else jspecs.fsdp_rules()
    assert mp.PROD_AXIS_SIZES == jparams.PROD_AXIS_SIZES and mp._NO_FALLBACK == jparams._NO_FALLBACK
    for arch in ALL_ARCHS:
        ours = dict(mp.flatten_with_paths(mp.pspecs(R.make_template(configs.get_arch(arch)),
                                                    ours_rules)))
        ref = _ref_leaves(jparams.pspecs(JR.make_template(jconfigs.get_arch(arch)), ref_rules))
        assert ours.keys() == ref.keys(), arch
        for path, spec in ours.items():
            assert isinstance(spec, mp.Spec) and tuple(spec) == _spec(ref[path]), (arch, path)


def _same_leaves(ours: dict, ref: dict, ours_specs: dict, ref_specs: dict, what: str):
    assert ours.keys() == ref.keys() == ours_specs.keys() == ref_specs.keys(), what
    for path, t in ours.items():
        r = ref[path]
        if isinstance(t, int):  # the decode position, an abstract int32 scalar there
            assert r.shape == () and tuple(ours_specs[path]) == _spec(ref_specs[path]) == ()
            continue
        assert tuple(t.shape) == tuple(r.shape) and t.device.type == "meta", (what, path)
        assert _dtype_name(t.dtype) == _dtype_name(r.dtype), (what, path)
        assert tuple(ours_specs[path]) == _spec(ref_specs[path]), (what, path)


@pytest.mark.parametrize("multi", [False, True])
def test_input_specs_are_the_references(multi):
    """Serving inputs leaf by leaf; a train plan's state part by part (the
    packed moments segment by segment against the reference's moment
    trees), its batch and weights leaf by leaf."""
    for arch in ARCHS:
        for shape in configs.SHAPES.values():
            if not configs.shape_applicable(configs.get_arch(arch), shape)[0]:
                continue
            plan = specs.make_plan(arch, shape.name, multi)
            args, sp = specs.input_specs(plan)
            jargs, jsp = jspecs.input_specs(jspecs.make_plan(arch, shape.name, multi))
            what = plan.name
            if plan.kind in ("prefill", "decode"):
                assert len(args) == len(jargs)
                for i, (a, s, ja, js) in enumerate(zip(args, sp, jargs, jsp)):
                    ours = dict(mp.flatten_with_paths({"x": a}))
                    oursp = dict(mp.flatten_with_paths({"x": s}))
                    _same_leaves(ours, _ref_leaves({"x": ja}), oursp, _ref_leaves({"x": js}),
                                 f"{what} arg {i}")
                if plan.kind == "decode":
                    cache = serving.cache_spec(plan.arch, shape.global_batch, shape.seq_len,
                                               abstract=True)
                    jcache = jserving.cache_spec(jconfigs.get_arch(arch), shape.global_batch,
                                                 shape.seq_len, abstract=True)
                    _same_leaves(dict(mp.flatten_with_paths(cache)), _ref_leaves(jcache),
                                 dict(mp.flatten_with_paths(specs.cache_pspecs(
                                     plan.arch, shape.global_batch, plan.dp_axes))),
                                 _ref_leaves(jspecs.cache_pspecs(
                                     jconfigs.get_arch(arch), shape.global_batch, plan.dp_axes)),
                                 f"{what} cache")
                continue
            (state, batch, w), (sspec, bspec, wspec) = args, sp
            (jstate, jbatch, jw), (jsspec, jbspec, jwspec) = jargs, jsp
            _same_leaves(dict(mp.flatten_with_paths(batch)), _ref_leaves(jbatch),
                         dict(mp.flatten_with_paths(bspec)), _ref_leaves(jbspec), f"{what} batch")
            assert tuple(w.shape) == jw.shape and tuple(wspec) == _spec(jwspec) == ()
            ref_params = _ref_leaves({"p": jstate["params"]})
            ref_pspec = _ref_leaves({"p": jsspec["params"]})
            if plan.kind == "fedsgd":  # one shared copy: a packed row against the tree
                seg = sspec["params"]
                assert isinstance(seg, packing.SegmentSpec) and tuple(seg.lead) == ()
                assert [(s, tuple(p)) for s, p in seg.segments] == \
                    [(tuple(ref_params[k].shape), _spec(ref_pspec[k])) for k in ref_params]
            else:
                assert tuple(state["params"].shape) == jstate["params"].shape
                assert _dtype_name(state["params"].dtype) == _dtype_name(jstate["params"].dtype)
                assert tuple(sspec["params"]) == _spec(jsspec["params"])
            for k, mspec in sspec["opt"].items():
                if k == "t":
                    assert tuple(state["opt"][k].shape) == jstate["opt"][k].shape
                    assert tuple(mspec) == _spec(jsspec["opt"][k]) == ()
                    continue
                lead = 0 if plan.kind == "fedsgd" else 1
                ref_m = _ref_leaves(jstate["opt"][k])
                ref_ms = _ref_leaves(jsspec["opt"][k])
                assert [(s, tuple(p)) for s, p in mspec.segments] == \
                    [(tuple(ref_m[q].shape[lead:]), _spec(ref_ms[q])[lead:]) for q in ref_m], \
                    (what, k)
                assert tuple(mspec.lead) == tuple(_spec(next(iter(ref_ms.values())))[:lead])
                assert _dtype_name(state["opt"][k].dtype) == \
                    _dtype_name(next(iter(ref_m.values())).dtype)
            _same_leaves(dict(mp.flatten_with_paths(state["agg"])), _ref_leaves(jstate["agg"]),
                         dict(mp.flatten_with_paths(sspec["agg"])), _ref_leaves(jsspec["agg"]),
                         f"{what} agg")
            assert state["round"] == 0 and tuple(sspec["round"]) == _spec(jsspec["round"]) == ()


def _ref_shard_numel(shape, spec, sizes):
    n = 1
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        k = 1
        for name in entry if isinstance(entry, tuple) else (entry,):
            if name is not None:
                k *= sizes.get(name, 1)
        n *= -(-d // k)
    return n


def _ref_state_bytes(jstate, jsspec, sizes) -> int:
    leaves = jax.tree.leaves(jstate)
    pspecs = jax.tree.leaves(jsspec, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(pspecs)
    return sum(_ref_shard_numel(l.shape, tuple(s), sizes) * np.dtype(l.dtype).itemsize
               for l, s in zip(leaves, pspecs))


@pytest.mark.parametrize("multi", [False, True])
def test_per_device_state_bytes_are_the_references(multi):
    sizes = mesh.make_production_mesh(multi_pod=multi)
    for arch in ARCHS:
        plan = specs.make_plan(arch, "train_4k", multi)
        (state, _, _), (sspec, _, _) = specs.input_specs(plan)
        (jstate, _, _), (jsspec, _, _) = jspecs.input_specs(jspecs.make_plan(arch, "train_4k", multi))
        ours = specs.per_device_bytes(state, sspec, sizes)
        assert isinstance(ours, int) and ours == _ref_state_bytes(jstate, jsspec, sizes), arch
        assert dryrun.state_bytes(plan, sizes) == ours


def test_model_flops_arithmetic_is_the_references():
    for arch in ARCHS:
        ours, ref = configs.get_arch(arch), jconfigs.get_arch(arch)
        assert roofline.expert_params(ours) == jroof.expert_params(ref)
        assert roofline.active_params(ours) == jroof.active_params(ref)
        for shape in configs.SHAPES:
            for steps in (1, 2):
                assert roofline.model_flops(ours, configs.get_shape(shape), steps) == \
                    jroof.model_flops(ref, jconfigs.get_shape(shape), steps)


def test_terms_are_the_references_on_h100_constants():
    arch, shape = configs.get_arch("qwen3-1.7b"), configs.get_shape("train_4k")
    jarch, jshape = jconfigs.get_arch("qwen3-1.7b"), jconfigs.get_shape("train_4k")
    coll, cross = {"all-reduce": 1e11, "all-gather": 3e9}, {"all-gather": 5e8}
    ours = roofline.terms(1e15, 1e12, coll, 512, arch, shape, 2, cross)
    ref = jroof.terms(1e15, 1e12, coll, 512, jarch, jshape, 2, cross)
    from repro.launch import mesh as jmesh
    scale = {"compute_s": jmesh.PEAK_FLOPS_BF16 / mesh.BF16_FLOPS,
             "memory_s": jmesh.HBM_BW / mesh.HBM_BW, "collective_s": jmesh.ICI_BW / mesh.NVLINK_BW,
             "cross_node_s": jroof.DCN_BW / mesh.IB_BW}
    ref_keys = {"compute_s": "compute_s", "memory_s": "memory_s", "collective_s": "collective_s",
                "cross_node_s": "cross_pod_s"}
    for key, factor in scale.items():
        np.testing.assert_allclose(getattr(ours, key), getattr(ref, ref_keys[key]) * factor,
                                   rtol=1e-12)
    assert ours.model_flops == ref.model_flops and ours.op_flops_total == ref.hlo_flops_total
    assert ours.useful_ratio == ref.useful_ratio and ours.cross_node_bytes == ref.cross_pod_bytes
    assert ours.dominant == ref.dominant == "compute"
    # each product kind at its own rate; the kernels' other operations on the FP32 units
    by_kind = roofline.terms({"fp32": 66.9e12, "tf32x3": mesh.TF32X3_FLOPS, "bf16": 0.0}, 0.0, {},
                             1, arch, shape, other_ops=66.9e12)
    np.testing.assert_allclose(by_kind.compute_s, 3.0, rtol=1e-12)
    assert (mesh.FP32_FLOPS, mesh.TF32_FLOPS, mesh.BF16_FLOPS, mesh.HBM_BW) == \
        (66.9e12, 494.7e12, 989.4e12, 3.35e12)


def test_print_plan_is_the_references_text(capsys):
    for arch in ALL_ARCHS:
        train.print_plan(arch)
        ours = capsys.readouterr().out
        jtrain.print_plan(arch)
        assert ours == capsys.readouterr().out, arch
    assert train.main(["--arch", "zamba2-2.7b", "--print-plan"]) == {}
    out = capsys.readouterr().out
    assert out.startswith("== zamba2-2.7b--train_4k--singlepod\n") and "{" not in out.splitlines()[0]
    assert train.main(["--task", "detection", "--print-plan"]) == {}
    assert capsys.readouterr().out.startswith("== fedyolov3--train_4k--singlepod")


# ------------------------------ meshes and the activation context -----------

def test_meshes_are_axis_plans_and_the_host_mesh_is_the_launchers():
    assert mesh.make_production_mesh() == {"data": 16, "model": 16}
    assert mesh.make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}
    assert mesh.n_devices(mesh.make_production_mesh(multi_pod=True)) == 512
    host = train.client_mesh(torch.device("cpu"))  # the launcher's 1 x 1, through make_host_mesh
    assert host.mesh_dim_names == ("data", "model") and tuple(host.shape) == (1, 1)
    with pytest.raises(RuntimeError, match="2 x 2 host mesh needs a process group of 4"):
        mesh.make_host_mesh(2, 2)
    from torch.distributed.tensor import Replicate, Shard
    tpl = R.make_template(configs.get_arch("qwen3-1.7b").reduced())
    placements = mp.shardings(tpl, host)
    assert placements["embed"] == [Replicate(), Shard(0)]  # vocab on "model" (1 divides all)
    assert mp.placements(mp.Spec(("data", "model"), None), host) == [Shard(0), Shard(0)]


def test_activation_context_resets_and_constrains_dtensors():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    def current():
        return shard_ctx._ACT_BATCH.get(), shard_ctx._ACT_SEQ.get()

    x = torch.ones(2, 3, 4)
    assert current() == (None, None) and shard_ctx.constrain(x) is x
    with shard_ctx.activation_sharding(("data",), "model"):
        assert current() == (("data",), "model")
        with shard_ctx.activation_sharding(None):
            assert current() == (None, None)
        assert shard_ctx.constrain(x) is x  # a plain tensor: no GSPMD to steer
        host = train.client_mesh(torch.device("cpu"))
        d = distribute_tensor(x, host, [Replicate(), Replicate()])
        got = shard_ctx.constrain(d)
        assert list(got.placements) == [Shard(0), Shard(1)]
        assert torch.equal(got.full_tensor(), x)
    assert current() == (None, None)


# ------------------------------ the op counter ------------------------------

def _round_flops_pair(arch, n_layers=0, C=1, E=1, b=2, S=32, micro=1):
    jcfg, cfg = jconfigs.get_arch(arch).reduced(), configs.get_arch(arch).reduced()
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    kw = dict(n_clients=C, local_steps=E, aggregation="dense", client_axis="data",
              data_axis=None, topn=1, microbatches=micro)
    jfed, fed = JR.FedConfig(**kw), R.FedConfig(**kw)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jstate = JR.state_template(jcfg, jfed, jadamw(), jnp.float32)
    jbatch = {"tokens": jax.ShapeDtypeStruct((C, E, b, S), jnp.int32)}
    with jax.set_mesh(jmesh):
        txt = jax.jit(JR.build_fed_round(jcfg, jfed, jadamw(), jmesh)).lower(
            jstate, jbatch, jax.ShapeDtypeStruct((C,), jnp.float32)).compile().as_text()
    state = R.state_template(cfg, fed, adamw(), torch.float32)
    batch = {"tokens": torch.empty((C, E, b, S), dtype=torch.int32, device="meta")}
    _, costs = op_analysis.count(R.build_fed_round(cfg, fed, adamw()), state, batch,
                                 torch.empty(C, device="meta"))
    return costs, jhlo.analyze(txt)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b", "granite-moe-1b-a400m"])
def test_traced_round_flops_are_the_references_hlo_count(arch):
    assert configs.get_arch(arch).attention_impl == "ref" and configs.get_arch(arch).ssm_impl == "ref"
    costs, ref = _round_flops_pair(arch)
    print(f"{arch}: port {costs.total_flops:.6e}, reference HLO {ref.flops:.6e}, "
          f"ratio {costs.total_flops / ref.flops:.5f}")
    np.testing.assert_allclose(costs.total_flops, ref.flops, rtol=1e-2)
    assert costs.traffic > 0 and costs.peak_bytes > costs.input_bytes > 0 and costs.ops > 100


def test_every_layer_is_counted():
    """The trace of n layers is n times one layer plus the rest: no layer of
    a Python loop or a checkpoint's recompute is missed or counted twice."""
    flops = {}
    for n in (1, 2, 3):
        cfg = dataclasses.replace(configs.get_arch("qwen3-1.7b").reduced(), n_layers=n)
        fed = R.FedConfig(n_clients=1, aggregation="dense", client_axis="data", data_axis=None,
                          topn=1)
        state = R.state_template(cfg, fed, adamw(), torch.float32)
        batch = {"tokens": torch.empty((1, 1, 2, 32), dtype=torch.int32, device="meta")}
        flops[n] = op_analysis.count(R.build_fed_round(cfg, fed, adamw()), state, batch,
                                     torch.empty(1, device="meta"))[1].total_flops
    layer = flops[2] - flops[1]
    assert layer > 0 and flops[3] - flops[2] == layer
    assert flops[3] == 3 * layer + (flops[1] - layer)


def test_a_round_counted_on_the_host_counts_what_its_meta_trace_counts():
    cfg = configs.get_arch("mamba2-1.3b").reduced()
    fed = R.FedConfig(n_clients=2, aggregation="eq6", client_axis="data", data_axis=None, topn=1,
                      microbatches=2)
    fn = R.build_fed_round(cfg, fed, adamw(3e-3))
    meta = R.state_template(cfg, fed, adamw(3e-3), torch.float32)
    host = R.make_state(cfg, fed, adamw(3e-3), device="cpu")
    for k in ("params", "agg"):
        assert mp.map_tree(lambda t: (tuple(t.shape), t.dtype), meta[k]) == \
            mp.map_tree(lambda t: (tuple(t.shape), t.dtype), host[k])
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 1, 4, 16), dtype=np.int32)
    w = R.uniform_weights(2)
    _, on_meta = op_analysis.count(fn, meta, {"tokens": torch.empty((2, 1, 4, 16), dtype=torch.int32,
                                                                     device="meta")},
                                   w.to("meta"))
    _, on_host = op_analysis.count(fn, host, {"tokens": torch.from_numpy(tokens)}, w)
    assert dict(on_host.flops) == dict(on_meta.flops)
    assert on_host.traffic == on_meta.traffic and on_host.ops == on_meta.ops


def test_kernel_meta_branches_give_the_plain_shapes_and_report_their_work():
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 4, 128, 32, generator=g), torch.randn(2, 2, 128, 32, generator=g)
    xdt, dA = torch.randn(2, 128, 4, 16, generator=g), torch.randn(2, 128, 4, generator=g)
    Bm, Cm = torch.randn(2, 128, 8, generator=g), torch.randn(2, 128, 8, generator=g)
    packed, wmask = torch.randn(3, 100, generator=g), torch.rand(3, 5, generator=g)
    ids = torch.arange(100, dtype=torch.int32) % 5
    plain = [kref.flash_attention(q, k, k, True, 16), *kref.ssd_chunk_scan(xdt, dA, Bm, Cm, 64),
             *kref.packed_bucket_reduce(packed, wmask, ids, None)]
    reports = []
    before = (kflash.flash_attention.launches, kssd.ssd_chunk_scan.launches,
              kpack.packed_bucket_reduce.launches)
    m = lambda t: t.to("meta")
    with kcosts.collect(lambda *r: reports.append(r)):
        got = [kflash.flash_attention(m(q), m(k), m(k), window=16),
               *kssd.ssd_chunk_scan(m(xdt), m(dA), m(Bm), m(Cm), chunk=64),
               *kpack.packed_bucket_reduce(m(packed), m(wmask), m(ids))]
    for a, b in zip(got, plain):
        assert a.device.type == "meta" and a.shape == b.shape and a.dtype == b.dtype
    assert before == (kflash.flash_attention.launches, kssd.ssd_chunk_scan.launches,
                      kpack.packed_bucket_reduce.launches)  # no launch is counted
    assert [r[0] for r in reports] == ["flash_attention", "ssd_chunk_scan", "packed_bucket_reduce"]
    # K9 over the band of 16 keys: 16 * 17 / 2 + 112 * 16 pairs per (batch, head)
    pairs = (16 * 17 // 2 + 112 * 16) * 2 * 4
    assert reports[0][1:] == (pairs * 4 * 32, pairs * 3, 4 * (2 * 2 * 4 * 128 * 32 +
                                                            2 * 2 * 2 * 128 * 32), "tf32x3")
    assert kcosts.visible_pairs(128, True, 0) == 128 * 129 // 2
    assert kcosts.visible_pairs(5, False, 2) == sum(1 for i in range(5) for j in range(5)
                                                    if i - j < 2)
    assert reports[2][1:] == (0.0, 4.0 * 300, 4.0 * (300 + 100 + 15 + 3 + 200), "fp32")


# ------------------------------ collectives and the dry-run -----------------

def test_collectives_follow_the_rules_and_the_node_boundary():
    plan = specs.make_plan("qwen3-1.7b", "train_4k", False)
    rows = op_analysis.collectives(plan, 2e9, 2e9, 16 * 4096, mesh.make_production_mesh())
    kinds = {(r["kind"], r["axes"]) for r in rows}
    assert kinds == {("all-reduce", ("model",)), ("all-reduce", ("data",))}
    assert all(r["cross_node"] for r in rows)  # 16 ranks of a 16 x 16 mesh span 2 nodes
    tp = next(r for r in rows if r["axes"] == ("model",))
    assert tp["count"] == 28 * 2 * 8 * 3 and tp["bytes"] == 2 * 4096 * 2048 * 2
    inside = op_analysis.collectives(plan, 2e9, 2e9, 4096, {"data": 1, "model": 8})
    assert inside and not any(r["cross_node"] for r in inside)
    assert op_analysis.collectives(plan, 2e9, 2e9, 4096, {"data": 1, "model": 1}) == []
    big = specs.make_plan("grok-1-314b", "train_4k", False)  # fedsgd over FSDP rules
    kinds = {r["kind"] for r in op_analysis.collectives(big, 1e12, 1e12, 4096,
                                                       mesh.make_production_mesh())}
    assert kinds == {"all-reduce", "all-gather", "reduce-scatter"}
    nbytes, ops, cross = op_analysis.collective_totals(rows)
    assert nbytes["all-reduce"] == sum(r["bytes"] * r["count"] for r in rows) == cross["all-reduce"]


def test_dryrun_records_a_plan_and_the_references_skip(tmp_path):
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "decode_32k", "--mesh", "both",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k", "--mesh", "single",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "mamba2-1.3b--decode_32k--singlepod.json").read_text())
    assert rec["n_devices"] == 256 and rec["kind"] == "decode" and rec["mesh"] == "16x16"
    plan = specs.make_plan("mamba2-1.3b", "decode_32k", False)
    args, sp = specs.input_specs(plan)
    assert rec["memory"]["state_per_device"] == specs.per_device_bytes(args[:2], sp[:2])
    assert rec["op_costs"]["replica_batch"] == 8 and rec["op_costs"]["flops_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective", "cross-node")
    multi = json.loads((tmp_path / "mamba2-1.3b--decode_32k--multipod.json").read_text())
    assert multi["n_devices"] == 512 and multi["op_costs"]["replica_batch"] == 4
    skip = json.loads((tmp_path / "hubert-xlarge--decode_32k--singlepod.json").read_text())
    assert skip["skipped"] == jconfigs.shape_applicable(
        jconfigs.get_arch("hubert-xlarge"), jconfigs.get_shape("decode_32k"))[1]


def test_cards_for_the_state_of_the_two_largest_plans():
    """The card counts the ROADMAP quotes: f32 params and adamw's moments of
    the single-pod train_4k plan (its rules) against 80 GB a card."""
    assert dryrun.cards_for_state("grok-1-314b")["cards"] == 64
    assert dryrun.cards_for_state("gemma3-27b")["cards"] == 8
    one = dryrun.state_bytes(specs.make_plan("gemma3-27b", "train_4k", False),
                             {"data": 1, "model": 4}, torch.float32)
    assert one > dryrun.CARD_BYTES
