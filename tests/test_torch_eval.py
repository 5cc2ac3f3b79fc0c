"""The port's federated evaluation (``repro_torch.core.detection``: greedy
matching on K2, VOC AP, the evaluator, ``FLServer.evaluate_round``) held
against the reference.

Matching is exact: given the same detections, the TP flags must be
identical (tolerance: none). AP and mAP come from cumulative f32 sums taken
in another order, so they are held at atol 1e-6. The evaluator decodes with
each package's own forward (raw heads agree to rtol 1e-4 / atol 1e-5); on
this model's detections that leaves ranking, NMS and matching unchanged, so
its mAP is held at atol 1e-6 too. The model is fedyolov3 cut to base width
8 and 3 stages at 32x32, 3 clients x 4 holdout images.
"""
import dataclasses

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.core import detection as jdetection
from repro.core.rounds import FedConfig as JFedConfig
from repro.data import pipeline as jpipeline
from repro.models import params as jparams
from repro.models import yolov3 as jyolo
from repro_torch.configs import get_arch
from repro_torch.core import detection, monitor
from repro_torch.core.rounds import FedConfig
from repro_torch.core.server import EvalRecord, FLServer, RoundRecord
from repro_torch.kernels import detect
from repro_torch.models import yolov3
from repro_torch.optim import sgd

JCFG = dataclasses.replace(jget_arch("fedyolov3").reduced(), d_model=8, n_layers=3)
TCFG = dataclasses.replace(get_arch("fedyolov3").reduced(), d_model=8, n_layers=3)
C, IMG = 3, 32


def _eval_batch():
    _, ev, _ = jpipeline.detection_suite(JCFG, JFedConfig(n_clients=C), batch=2, img_size=IMG,
                                         pool_scenes=24)
    return ev


def _flat(x):
    return x.reshape((-1,) + x.shape[2:])


def _synthetic_pool(seed=0, B=6, K=10, G=4, n_classes=3):
    """Detections built around the GT: jittered copies (hits), duplicates of
    one GT (one TP, the rest FP), wrong classes, invalid slots and score
    ties, so matching and AP see every branch."""
    rng = np.random.default_rng(seed)
    gt = np.concatenate([rng.uniform(0.2, 0.8, (B, G, 2)), rng.uniform(0.1, 0.3, (B, G, 2))], -1)
    gt_cls = rng.integers(0, n_classes, (B, G)).astype(np.int32)
    gt_valid = (rng.uniform(size=(B, G)) > 0.2).astype(np.float32)
    src = rng.integers(0, G, (B, K))
    boxes = np.take_along_axis(gt, src[..., None], 1) + rng.normal(0, 0.02, (B, K, 4))
    cls = np.take_along_axis(gt_cls, src, 1).copy()
    flip = rng.uniform(size=(B, K)) < 0.2
    cls[flip] = (cls[flip] + 1) % n_classes
    scores = np.round(rng.uniform(size=(B, K)), 1)  # ties
    order = np.argsort(-scores, axis=1, kind="stable")
    take = lambda x: np.take_along_axis(x, order if x.ndim == 2 else order[..., None], 1)
    valid = (rng.uniform(size=(B, K)) > 0.15).astype(np.float32)
    pred = {"boxes": take(boxes).astype(np.float32), "scores": take(scores).astype(np.float32),
            "cls": take(cls).astype(np.int32), "valid": take(valid)}
    return pred, gt.astype(np.float32), gt_cls, gt_valid


def _torch_pred(pred):
    return {k: torch.tensor(np.asarray(v)) for k, v in pred.items()}


@pytest.mark.parametrize("iou_thresh", [0.5, 0.3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matching_and_ap_match_reference_on_synthetic_pool(seed, iou_thresh):
    pred, gt, gt_cls, gt_valid = _synthetic_pool(seed)
    jtp = np.asarray(jdetection.match_detections(
        jax.tree.map(jnp.asarray, pred), jnp.asarray(gt), jnp.asarray(gt_cls), jnp.asarray(gt_valid),
        iou_thresh=iou_thresh))
    assert jtp.sum() > 0 and (1 - jtp).sum() > 0
    for impl in ("kernel", "ref"):
        tp = detection.match_detections(_torch_pred(pred), torch.from_numpy(gt),
                                        torch.from_numpy(gt_cls), torch.from_numpy(gt_valid),
                                        iou_thresh=iou_thresh, impl=impl)
        np.testing.assert_array_equal(tp.numpy(), jtp)
    ours = detection.evaluate_detections(_torch_pred(pred), torch.from_numpy(gt),
                                         torch.from_numpy(gt_cls), torch.from_numpy(gt_valid), 3,
                                         iou_thresh=iou_thresh)
    ref = jdetection.evaluate_detections(jax.tree.map(jnp.asarray, pred), jnp.asarray(gt),
                                         jnp.asarray(gt_cls), jnp.asarray(gt_valid), 3,
                                         iou_thresh=iou_thresh)
    np.testing.assert_allclose(ours["ap"].numpy(), np.asarray(ref["ap"]), atol=1e-6)
    np.testing.assert_allclose(float(ours["map"]), float(ref["map"]), atol=1e-6)


def test_average_precision_absent_class_and_perfect_detector():
    """A class with no GT contributes nothing; a perfect ranking scores 1."""
    scores = torch.tensor([0.9, 0.8, 0.7, 0.6])
    tp = torch.tensor([1.0, 1.0, 0.0, 1.0])
    valid = torch.ones(4)
    cls = torch.tensor([0, 0, 0, 1])
    n_gt = torch.tensor([2.0, 1.0, 0.0])
    ap, m = detection.average_precision(scores, tp, valid, cls, n_gt)
    jap, jm = jdetection.average_precision(*(jnp.asarray(x.numpy()) for x in (scores, tp, valid, cls, n_gt)))
    np.testing.assert_allclose(ap.numpy(), np.asarray(jap), atol=1e-6)
    assert float(m) == pytest.approx(1.0) and float(jm) == pytest.approx(1.0)


def _models(seed=0):
    p = jparams.init_params(jyolo.template(JCFG), jax.random.key(seed), jnp.float32)
    tree = jax.tree.map(np.asarray, p)
    return tree, yolov3.FedYOLOv3(TCFG, weights=tree).eval()


def test_evaluator_matches_reference_given_its_detections():
    tree, model = _models(3)  # a seed whose random detector finds some objects
    ev = _eval_batch()
    jeval = jdetection.build_evaluator(JCFG, max_detections=16)(jax.tree.map(jnp.asarray, tree),
                                                                 jax.tree.map(jnp.asarray, ev))
    assert float(jeval["map"]) > 0
    # the reference's own decode of the flattened (C*B) holdout
    jpred = jax.tree.map(np.asarray, jdetection.decode_predictions(
        JCFG, jax.tree.map(jnp.asarray, tree), jnp.asarray(_flat(ev["images"])), max_detections=16))
    gt = [torch.from_numpy(_flat(ev[k])) for k in ("gt_boxes", "gt_cls", "gt_valid")]
    jtp = np.asarray(jdetection.match_detections(jax.tree.map(jnp.asarray, jpred),
                                                 *(jnp.asarray(g.numpy()) for g in gt)))
    tp = detection.match_detections(_torch_pred(jpred), *gt)
    np.testing.assert_array_equal(tp.numpy(), jtp)
    n_gt = detection._gt_hist(gt[1], gt[2], 3).reshape(C, -1, 3).sum(1)
    per = lambda x: torch.tensor(np.asarray(x)).reshape(C, -1)
    maps = [float(detection.average_precision(per(jpred["scores"])[c], tp.reshape(C, -1)[c],
                                              per(jpred["valid"])[c], per(jpred["cls"])[c], n_gt[c])[1])
            for c in range(C)]
    np.testing.assert_allclose(maps, np.asarray(jeval["per_client_map"]), atol=1e-6)
    # the port's evaluator, decoding with its own forward
    before = detect.pairwise_iou.launches
    out = detection.build_evaluator(TCFG, max_detections=16)(
        model, {k: torch.from_numpy(v) for k, v in ev.items()})
    assert detect.pairwise_iou.launches == before  # on the CPU: the plain version
    assert out["per_client_ap"].shape == (C, 3)
    np.testing.assert_allclose(float(out["map"]), float(jeval["map"]), atol=1e-6)
    np.testing.assert_allclose(out["per_client_map"].numpy(), np.asarray(jeval["per_client_map"]),
                               atol=1e-6)
    np.testing.assert_allclose(out["per_client_ap"].numpy(), np.asarray(jeval["per_client_ap"]),
                               atol=1e-6)


def test_evaluate_round_feeds_scheduler_and_monitor():
    fed = FedConfig(n_clients=C, topn=4, participation="masked")
    srv = FLServer(TCFG, fed, sgd(1e-3), device="cpu")
    glob = srv.global_params()
    assert isinstance(glob, yolov3.FedYOLOv3) and not glob.training
    ev = _eval_batch()
    rec = srv.evaluate_round(ev, max_detections=16)
    assert isinstance(rec, EvalRecord) and rec.round_idx == 0
    assert len(rec.per_client_map) == C and 0.0 <= rec.map50 <= 1.0
    np.testing.assert_array_equal(srv.scheduler.last_eval, rec.per_client_map)
    hist = [RoundRecord(i, 10.0 - i, [0.5, 0.5, 0.0], 0.1, [0, 1]) for i in range(3)]
    text = monitor.render_task("fedyolo", hist, C, eval_history=[rec, rec])
    assert "mAP@0.5" in text and "2/3 participating" in text
    assert monitor.sparkline([1.0, 2.0, 3.0]) == "▁▄█"
    assert monitor.top_clients(hist, C, k=2) == [0, 1]
