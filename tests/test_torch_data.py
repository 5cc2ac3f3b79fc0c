"""The port's host-side data, scheduling and packing held against the
reference.

Every function here is NumPy (or integer bookkeeping) in both packages, so
the same inputs and seeds must give bit-identical outputs: arrays compared
with ``assert_array_equal`` (tolerance: none), partitions and selections
element for element. Inputs are made from fixed NumPy seeds.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import compression as jcomp
from repro.core import explorer as jexplorer
from repro.core import packing as jpacking
from repro.core import scheduler as jscheduler
from repro.core.rounds import FedConfig as JFedConfig
from repro.data import darknet as jdarknet
from repro.data import partition as jpartition
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.models import params as jparams
from repro.models import yolov3 as jyolo
from repro_torch.configs import get_arch
from repro_torch.core import compression, explorer, packing, scheduler
from repro_torch.core.rounds import FedConfig
from repro_torch.data import darknet, partition, pipeline, synthetic
from repro_torch.models import params
from repro_torch.models import yolov3

ANNOTATION = "# camera 0\n0 0.500000 0.500000 0.200000 0.300000\n\n2 0.1 0.9 0.05 0.1\n1 0.25 0.75 1.0 0.5\n"


def _boxes(mod, seed=0, n_images=5):
    """Random BBox lists in the given module's BBox type."""
    rng = np.random.default_rng(seed)
    return [
        [mod.BBox(int(rng.integers(0, 5)), *rng.uniform(0.05, 0.95, 2), *rng.uniform(0.02, 0.6, 2))
         for _ in range(int(rng.integers(0, 4)))]
        for _ in range(n_images)
    ]


def _as_tuples(boxes):
    return [[dataclasses.astuple(b) for b in bs] for bs in boxes]


def test_darknet_parse_write_map_match_reference(tmp_path):
    parsed = darknet.parse_annotation(ANNOTATION)
    assert _as_tuples([parsed]) == _as_tuples([jdarknet.parse_annotation(ANNOTATION)])
    assert darknet.write_annotation(parsed) == jdarknet.write_annotation(
        jdarknet.parse_annotation(ANNOTATION))
    for bad in ("0 0.5 0.5 0.1", "0 1.5 0.5 0.1 0.1", "-1 0.5 0.5 0.1 0.1"):
        with pytest.raises(ValueError):
            darknet.parse_annotation(bad)
    cam = tmp_path / "cam"
    cam.mkdir()
    for i, bs in enumerate(_boxes(darknet, seed=3, n_images=3)):
        (cam / f"frame{i}.txt").write_text(darknet.write_annotation(bs))
    ours = darknet.map_annotations(cam, tmp_path / "train_port")
    ref = jdarknet.map_annotations(cam, tmp_path / "train_ref")
    assert list(ours) == list(ref)
    assert {k: _as_tuples([v]) for k, v in ours.items()} == {k: _as_tuples([v]) for k, v in ref.items()}
    for f in (tmp_path / "train_ref").iterdir():
        assert (tmp_path / "train_port" / f.name).read_text() == f.read_text()


@pytest.mark.parametrize("grids", [[8, 4, 2], [52, 26, 13]])
def test_build_targets_bit_identical(grids):
    ours = darknet.build_targets(_boxes(darknet), grids, 3, 3, yolov3.ANCHORS)
    ref = jdarknet.build_targets(_boxes(jdarknet), grids, 3, 3, jyolo.ANCHORS)
    for o, r in zip(ours, ref):
        for k in ("obj", "box", "cls"):
            assert o[k].dtype == r[k].dtype
            np.testing.assert_array_equal(o[k], r[k])


def test_scene_pool_and_gt_arrays_bit_identical():
    ours = synthetic.detection_scene_pool(12, 32, 3, np.random.default_rng(4), max_boxes=3)
    ref = jsynthetic.detection_scene_pool(12, 32, 3, np.random.default_rng(4), max_boxes=3)
    for k in ("images", "gt_boxes", "gt_cls", "gt_valid", "labels"):
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert _as_tuples(ours["bboxes"]) == _as_tuples(ref["bboxes"])
    for max_boxes in (1, 2, 4):
        for o, r in zip(synthetic.boxes_to_arrays(_boxes(synthetic), max_boxes),
                        jsynthetic.boxes_to_arrays(_boxes(jsynthetic), max_boxes)):
            np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("scenario", ["iid", "dirichlet", "shards", "quantity"])
def test_partition_scenarios_bit_identical(scenario):
    labels = np.random.default_rng(1).integers(0, 4, 200)
    ours = partition.make_scenario(scenario, labels, 5, np.random.default_rng(9), alpha=0.3)
    ref = jpartition.make_scenario(scenario, labels, 5, np.random.default_rng(9), alpha=0.3)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)
    so, sr = partition.partition_stats(ours, labels), jpartition.partition_stats(ref, labels)
    np.testing.assert_array_equal(so["label_hist"], sr["label_hist"])
    np.testing.assert_array_equal(so["skew_tv"], sr["skew_tv"])
    gt = np.random.default_rng(2).uniform(0, 1, (200, 3, 4)).astype(np.float32)
    valid = (np.random.default_rng(3).uniform(size=(200, 3)) > 0.3).astype(np.float32)
    ko, kr = partition.scale_skew_stats(ours, gt, valid), jpartition.scale_skew_stats(ref, gt, valid)
    np.testing.assert_array_equal(ko["mean_scale"], kr["mean_scale"])
    assert ko["spread"] == kr["spread"]
    with pytest.raises(ValueError, match="unknown partition"):
        partition.make_scenario("zipf", labels, 5, np.random.default_rng(0))


def test_detection_suite_bit_identical():
    tcfg, jcfg = get_arch("fedyolov3").reduced(), jget_arch("fedyolov3").reduced()
    tfed, jfed = FedConfig(n_clients=3, local_steps=2), JFedConfig(n_clients=3, local_steps=2)
    gen, ev, stats = pipeline.detection_suite(tcfg, tfed, batch=2, img_size=32, pool_scenes=24)
    jgen, jev, jstats = jpipeline.detection_suite(jcfg, jfed, batch=2, img_size=32, pool_scenes=24)
    for k in ("images", "gt_boxes", "gt_cls", "gt_valid"):
        np.testing.assert_array_equal(ev[k], jev[k], err_msg=k)
    for o, r in zip(stats["parts"], jstats["parts"]):
        np.testing.assert_array_equal(o, r)
    for _ in range(2):
        b, jb = next(gen), next(jgen)
        assert b["images"].shape == (3, 2, 2, 32, 32, 3)
        np.testing.assert_array_equal(b["images"], jb["images"])
        for t, jt in zip(b["targets"], jb["targets"]):
            for k in ("obj", "box", "cls"):
                np.testing.assert_array_equal(t[k], jt[k])


def test_fed_batches_stream_detection_scenes_bit_identical():
    """``fed_batches``' default ``"stream"`` partition for a yolo arch: fresh
    scenes every (client, local step), the three target heads stacked to
    (C, E, b, ...)."""
    tcfg, jcfg = get_arch("fedyolov3").reduced(), jget_arch("fedyolov3").reduced()
    tfed, jfed = FedConfig(n_clients=2, local_steps=2), JFedConfig(n_clients=2, local_steps=2)
    gen = pipeline.fed_batches(tcfg, tfed, batch=2, seq=0, img_size=32)
    jgen = jpipeline.fed_batches(jcfg, jfed, batch=2, seq=0, img_size=32)
    grids = yolov3.grid_sizes(tcfg, 32)
    for _ in range(3):
        b, jb = next(gen), next(jgen)
        assert b["images"].shape == (2, 2, 2, 32, 32, 3) and b["images"].dtype == np.float32
        np.testing.assert_array_equal(b["images"], jb["images"])
        assert len(b["targets"]) == len(jb["targets"]) == 3
        for g, t, jt in zip(grids, b["targets"], jb["targets"]):
            assert t["obj"].shape[:5] == (2, 2, 2, g, g)
            for k in ("obj", "box", "cls"):
                assert t[k].dtype == jt[k].dtype
                np.testing.assert_array_equal(t[k], jt[k], err_msg=k)


def test_scheduler_and_load_model_same_selections():
    cfg = dict(max_participants=2, fairness_rounds=2)
    ours = scheduler.TaskScheduler(5, scheduler.SchedulerConfig(**cfg))
    ref = jscheduler.TaskScheduler(5, jscheduler.SchedulerConfig(**cfg))
    lm, jlm = explorer.ClientLoadModel(5, seed=3), jexplorer.ClientLoadModel(5, seed=3)
    np.testing.assert_array_equal(lm.stragglers, jlm.stragglers)
    rng = np.random.default_rng(0)
    for r in range(12):
        dt = 1.0 if r < 6 else float(rng.uniform(0.1, 3.0))
        loads, jloads = lm.step(dt), jlm.step(dt)
        np.testing.assert_array_equal(loads, jloads)
        k = None if r % 3 else 3
        sel, jsel = ours.participation(loads, k_static=k), ref.participation(jloads, k_static=k)
        assert sel.keys() == jsel.keys()
        for key in sel:
            np.testing.assert_array_equal(sel[key], jsel[key])
        for c in np.nonzero(sel["mask"])[0]:
            loss = float(rng.uniform(0, 10))
            ours.report_quality(int(c), loss)
            ref.report_quality(int(c), loss)
        score = rng.uniform(size=5)
        for c in range(5):
            ours.report_eval(c, float(score[c]))
            ref.report_eval(c, float(score[c]))
        np.testing.assert_array_equal(ours.quality, ref.quality)
    np.testing.assert_array_equal(ours.select(lm.step()), ref.select(jlm.step()))


def _multi_bucket_templates():
    """One template per package: scan-stacked layers (stack1), grouped
    layers (stack2), a tail after the groups and unstacked misc leaves."""
    def make(P):
        return {
            "blocks": {"g": P((2, 2, 3, 2), ("group", "layer", None, None)),
                       "w": P((4, 6), ("layer", None))},
            "embed": P((7, 4), (None, None)),
            "tail": P((1, 5), ("layer", None)),
            "z": P((3,), (None,)),
        }
    return make(params.ParamInfo), make(jparams.ParamInfo)


def _specs(which):
    if which == "fedyolov3":
        tcfg, jcfg = get_arch("fedyolov3"), jget_arch("fedyolov3")
        return (tcfg, packing.build_pack_spec(tcfg, yolov3.template(tcfg)),
                jpacking.build_pack_spec(jcfg, jyolo.template(jcfg)))
    cfg = SimpleNamespace(n_layers=5, local_global_period=2)
    t, j = _multi_bucket_templates()
    return cfg, packing.build_pack_spec(cfg, t), jpacking.build_pack_spec(cfg, j)


@pytest.mark.parametrize("which", ["fedyolov3", "multi_bucket"])
def test_pack_spec_bucket_ids_runs_and_expand_bit_identical(which):
    cfg, spec, jspec = _specs(which)
    assert (spec.n_total, spec.n_buckets) == (jspec.n_total, jspec.n_buckets)
    assert [(s.shape, s.offset, s.size, s.bucket_off, s.n_buckets) for s in spec.slots] == \
        [(s.shape, s.offset, s.size, s.bucket_off, s.n_buckets) for s in jspec.slots]
    ids = packing.bucket_ids(spec)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, jpacking.bucket_ids(jspec))
    assert packing.merged_runs(spec) == jpacking.merged_runs(jspec)
    vec = np.random.default_rng(5).normal(size=(3, spec.n_buckets)).astype(np.float32)
    np.testing.assert_array_equal(packing.expand_bucket_vec(spec, torch.from_numpy(vec)).numpy(),
                                  np.asarray(jpacking.expand_bucket_vec(jspec, vec)))
    if which == "fedyolov3":
        # every leaf is "misc": one real bucket, n_layers, for all 13.3 M
        assert spec.n_total == 13_312_864 and set(np.unique(ids)) == {cfg.n_layers}
    else:
        assert len(np.unique(ids)) == spec.n_buckets


def test_pack_unpack_views_and_bucket_sums_match_reference():
    cfg, spec, jspec = _specs("multi_bucket")
    t, j = _multi_bucket_templates()
    rng = np.random.default_rng(6)
    tree = params.map_tree(lambda i: rng.normal(size=(3,) + i.shape).astype(np.float32), t)
    jtree = {"blocks": {"g": tree["blocks"]["g"], "w": tree["blocks"]["w"]},
             "embed": tree["embed"], "tail": tree["tail"], "z": tree["z"]}
    packed = packing.pack(spec, params.map_tree(torch.from_numpy, tree))
    jpacked = np.array(jpacking.pack(jspec, jtree))
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    views = packing.unpack_views(spec, packed, t)
    back = packing.unpack(spec, packed, t)
    for (path, v), (_, b), (_, x) in zip(params.flatten_with_paths(views),
                                        params.flatten_with_paths(back),
                                        params.flatten_with_paths(tree)):
        np.testing.assert_array_equal(v.numpy(), x, err_msg=path)
        np.testing.assert_array_equal(b.numpy(), x, err_msg=path)
    views["embed"][1, 2, 3] = 42.0  # a view writes through into the buffer
    assert packed[1, spec.slots[2].offset + 2 * 4 + 3] == 42.0
    fresh = torch.zeros_like(packed)
    packing.write_slots(spec, fresh, back)
    np.testing.assert_array_equal(fresh.numpy(), jpacked)
    np.testing.assert_allclose(packing.bucket_sums(spec, torch.from_numpy(jpacked)).numpy(),
                               np.asarray(jpacking.bucket_sums(jspec, jpacked)), rtol=1e-6, atol=1e-6)


def test_compression_scores_and_topn_tie_rule():
    rng = np.random.default_rng(8)
    prev, new = rng.normal(size=(4, 6)).astype(np.float32), rng.normal(size=(4, 6)).astype(np.float32)
    v = compression.contribution_scores(torch.from_numpy(prev), torch.from_numpy(new))
    jv = np.asarray(jcomp.contribution_scores(prev, new))
    np.testing.assert_array_equal(v.numpy(), jv)
    for n in (1, 3, 6, 9):
        np.testing.assert_array_equal(compression.topn_mask(v, n).numpy(),
                                      np.asarray(jcomp.topn_mask(jv, n)))
    # fedyolov3's bucket vector: only the misc bucket moves, so ties at 0
    # upload every bucket under >= kth
    scores = torch.tensor([[0.0, 0.0, 0.0, 0.0, 0.0, 3.5]])
    assert compression.topn_mask(scores, 4).all()
    assert compression.n_score_buckets(get_arch("fedyolov3")) == 6
