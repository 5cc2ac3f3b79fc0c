"""The port's detection service (``repro_torch.core``) held against the
reference's serving plane, on the CPU.

Weights come from the reference's ``init_params`` through
``convert.from_reference``, with the heads scaled by 25 so the scores
spread as a trained detector's do (the plain init puts every score near
0.27, within 1e-5 of its neighbours). Tolerances: decoded boxes and scores
rtol 1e-5 / atol 1e-5 (the f32 convolutions sum in different orders, and
decoded w/h reach anchor * e^6, so the error is relative); classes, validity,
wire bytes, freshness tiers, checkpoint leaves and the padded-batch pin
exactly.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import ObjectStore as JStore
from repro.configs import get_arch as jget_arch
from repro.core import detection as jdetection
from repro.core import rounds as JR
from repro.core import serving as jserving
from repro.core.simclock import SimClock as JSimClock
from repro.core.transport import wire as jwire
from repro.data import synthetic as jsynthetic
from repro.models import params as jparams
from repro.models import yolov3 as jyolo
from repro_torch import device as D
from repro_torch.checkpoint import ObjectStore
from repro_torch.configs import get_arch
from repro_torch.core import detection, serving
from repro_torch.core import rounds as R
from repro_torch.core.simclock import SimClock
from repro_torch.core.transport import wire
from repro_torch.data import synthetic
from repro_torch.models import convert
from repro_torch.models.params import flatten_with_paths
from repro_torch.models.yolov3 import FedYOLOv3

ROOT = Path(__file__).resolve().parents[1]
IMG, K = 32, 16
WEIGHT_SEED, DATA_SEED = 8, 2  # top-K score margin 5.7e-4 (asserted below)


def jcfg():
    return jget_arch("fedyolov3").reduced()


def tcfg():
    return get_arch("fedyolov3").reduced()


@functools.lru_cache(maxsize=None)
def reference_weights(seed=WEIGHT_SEED):
    p = jparams.init_params(jyolo.template(jcfg()), jax.random.key(seed), jnp.float32)
    p["heads"] = tuple(h * 25.0 for h in p["heads"])
    return jax.tree.map(np.asarray, p)


def ported(tree):
    model = FedYOLOv3(tcfg())
    model.load_state_dict(convert.from_reference(tree))
    return model.eval()


def scenes(n, seed=DATA_SEED):
    imgs, _ = synthetic.scene_images(np.random.default_rng(seed), n, IMG, 3)
    return imgs


def program_output(model, imgs):
    return serving.to_host(serving.detection_program(tcfg(), K, "cpu")(model, torch.from_numpy(imgs)))


def test_scene_images_bit_identical_to_reference():
    a, boxes_a = synthetic.scene_images(np.random.default_rng(3), 4, 48, 3, max_boxes=4)
    b, boxes_b = jsynthetic.scene_images(np.random.default_rng(3), 4, 48, 3, max_boxes=4)
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert [[dataclasses.astuple(x) for x in bs] for bs in boxes_a] == \
        [[dataclasses.astuple(x) for x in bs] for bs in boxes_b]


def test_decode_predictions_matches_reference():
    tree = reference_weights()
    imgs = scenes(4)
    ref = jdetection.decode_predictions(jcfg(), tree, jnp.asarray(imgs), max_detections=K)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    # the seed's top-K margin: a 1-ulp conv drift cannot reorder slots
    outs = jyolo.forward(tree, jnp.asarray(imgs), jcfg())
    scores = jnp.concatenate([
        (lambda b, c, p: (c * p.max(-1)).reshape(4, -1))(*jyolo.decode_boxes(r, a))
        for r, a in zip(outs, jyolo.ANCHORS)], 1)
    top = -np.sort(-np.asarray(scores), axis=1)[:, : K + 1]
    assert np.min(top[:, :-1] - top[:, 1:]) >= 1e-4
    with torch.inference_mode():
        out = detection.decode_predictions(tcfg(), ported(tree), torch.from_numpy(imgs),
                                           max_detections=K)
    np.testing.assert_array_equal(out["cls"].numpy(), ref["cls"])
    np.testing.assert_array_equal(out["valid"].numpy(), ref["valid"])
    np.testing.assert_allclose(out["boxes"].numpy(), ref["boxes"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["scores"].numpy(), ref["scores"], rtol=1e-5, atol=1e-5)
    assert 0 < ref["valid"].sum() < ref["valid"].size  # NMS kept some and cut some


def test_decode_pads_with_minus_one_when_k_exceeds_candidates():
    """63 candidates at img 8 (4x4, 2x2, 1x1 grids x 3 anchors) < K=64."""
    with torch.inference_mode():
        out = detection.decode_predictions(tcfg(), ported(reference_weights()),
                                           torch.from_numpy(scenes(2)[:, :8, :8]), max_detections=64)
    assert out["scores"].shape == (2, 64)
    assert (out["scores"][:, 63:] == -1.0).all() and (out["valid"][:, 63:] == 0).all()
    assert (out["scores"][:, :63] > 0).all()


def test_padded_batch_is_bit_identical_to_lone_request():
    """Port of tests/test_serving.py's padding pin: slot 0's detections are
    the same bits whether it shares the batch with 7 scenes or rides alone
    with 7 zero slots."""
    model = ported(reference_weights())
    imgs = scenes(8, seed=3)
    lone = np.zeros_like(imgs)
    lone[0] = imgs[0]
    full, alone = program_output(model, imgs), program_output(model, lone)
    for key in ("boxes", "scores", "cls", "valid"):
        np.testing.assert_array_equal(full[key][0], alone[key][0], err_msg=key)
    assert serving.decode_result(full, 0) == serving.decode_result(alone, 0)
    assert sum(len(serving.decode_result(full, i)) for i in range(8)) > 0


def test_detection_program_is_cached_per_device():
    cfg = tcfg()
    assert serving.detection_program(cfg, 16, "cpu") is serving.detection_program(cfg, 16, "cpu")
    assert serving.detection_program(cfg, 16, "cpu") is not serving.detection_program(cfg, 8, "cpu")


FED_VARIANTS = [{}, {"serve_soft_stale_rounds": 0, "serve_hard_stale_rounds": 1,
                     "serve_soft_stale_s": 0.5, "serve_hard_stale_s": 2.0}]


@pytest.mark.parametrize("overrides", FED_VARIANTS)
def test_freshness_tier_equals_reference(overrides):
    fed, jfed = R.FedConfig(n_clients=2, **overrides), JR.FedConfig(n_clients=2, **overrides)
    assert dataclasses.asdict(fed) == dataclasses.asdict(jfed)
    rounds = sorted({0, 1, 100} | {v + d for v in (fed.serve_soft_stale_rounds,
                                                     fed.serve_hard_stale_rounds) for d in (-1, 0, 1)})
    secs = sorted({0.0, 1e6} | {v + d for v in (fed.serve_soft_stale_s, fed.serve_hard_stale_s)
                                for d in (-1e-3, 0.0, 1e-3)})
    for r in rounds:
        for s in secs:
            assert serving.freshness_tier(r, s, fed) == jserving.freshness_tier(r, s, jfed), (r, s)


def test_model_status_on_simclock_equals_reference():
    """fresh -> soft -> hard on a controlled clock, then on landed rounds:
    the port's status dict equals the reference's at every step."""
    fed, jfed = R.FedConfig(n_clients=2), JR.FedConfig(n_clients=2)
    clock, jclock = SimClock(), JSimClock()
    slot, jslot = serving.ModelSlot(clock=clock), jserving.ModelSlot(clock=jclock)
    tiers = []
    for dt, latest, republish in [(0, 5, True), (fed.serve_soft_stale_s + 1, 5, False),
                                  (fed.serve_hard_stale_s, 5, False), (0, 5, True),
                                  (0, 8, False), (0, 14, False)]:
        clock.advance(dt)
        jclock.advance(dt)
        if republish:
            assert slot.publish(5, "m") and jslot.publish(5, "m")
        status = serving.model_status(slot, latest, clock.now(), fed)
        assert status == jserving.model_status(jslot, latest, jclock.now(), jfed)
        tiers.append(status["tier"])
    assert tiers == ["fresh", "soft_stale", "hard_stale", "fresh", "soft_stale", "hard_stale"]
    assert not slot.publish(4, "late") and slot.stale_publishes == 1


DETS = [(2, np.float32(0.75), (0.1, 0.2, 0.3, 0.4)), (-1, 0.5, (1.5, 1.5, 1.5, 1.5))]
FRAMES = {
    "hello": lambda w: w.pack_hello(7),
    "dispatch": lambda w: w.pack_dispatch(3, b"row-bytes"),
    "update": lambda w: w.pack_update(1, 2, 3, 0.25, b"\x00\x01"),
    "heartbeat": lambda w: w.pack_heartbeat(9),
    "bye": lambda w: w.pack_bye(),
    "infer": lambda w: w.pack_infer(42, np.random.default_rng(0).normal(size=(5, 7, 3))),
    "result": lambda w: w.pack_result(7, 12345, 1, DETS),
    "status_request": lambda w: w.pack_status_request(),
    "status": lambda w: w.pack_status({"version": 3, "tier": "fresh"}),
}


@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_wire_frames_are_byte_identical_to_reference(kind):
    frame = FRAMES[kind](wire)
    assert frame == FRAMES[kind](jwire)
    assert wire.PROTOCOL_VERSION == jwire.PROTOCOL_VERSION == 3
    (ftype, payload), = jwire.FrameParser().feed(frame)
    assert [(ftype, payload)] == wire.FrameParser().feed(frame)


def test_reference_client_talks_to_the_port_service():
    """A reference InferenceClient drives the port's service; its RESULT is
    the port's direct program output for the zero-padded batch, bit for bit,
    and carries the published version."""
    model = ported(reference_weights())
    fed = R.FedConfig(n_clients=1, serve_batch=4, serve_max_detections=K)
    slot = serving.ModelSlot()
    slot.publish(3, model)
    svc = serving.InferenceService(tcfg(), fed, slot, img_size=IMG, device="cpu").start()
    img = scenes(1, seed=11)[0]
    try:
        with jserving.InferenceClient(svc.host, svc.port) as client:
            res = client.infer(img)
            status = client.status()
    finally:
        svc.stop()
    padded = np.zeros((4, IMG, IMG, 3), np.float32)
    padded[0] = img
    want = serving.decode_result(program_output(model, padded), 0)
    assert res.version == 3 and res.tier == "fresh"
    assert [(l, np.float32(s), tuple(np.float32(b))) for l, s, b in want] == \
        [(l, np.float32(s), tuple(np.float32(b))) for l, s, b in res.detections]
    assert len(res.detections) > 0
    assert status["in_flight"] == 0 and status["version"] == 3


def test_concurrent_port_clients_share_batches_and_drop_nothing():
    fed = R.FedConfig(n_clients=1, serve_batch=4, serve_max_wait_s=0.05)
    slot = serving.ModelSlot()
    slot.publish(1, ported(reference_weights()))
    svc = serving.InferenceService(tcfg(), fed, slot, img_size=IMG, device="cpu").start()
    imgs = scenes(8, seed=5)
    results = [None] * 8
    errors = []

    def ask(i):
        try:
            with serving.InferenceClient(svc.host, svc.port, timeout=30.0) as c:
                results[i] = c.infer(imgs[i])
        except Exception as e:  # noqa: BLE001 — surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors
        status = svc.status()
    finally:
        svc.stop()
    assert all(r.version == 1 for r in results)
    assert status["in_flight"] == 0 and status["requests"] == 8
    assert status["batches"] < 8  # some requests shared a launch


def test_failed_batch_stops_the_service_and_stop_reraises():
    """No fallback on the serving path: a batch that raises closes its
    clients' connections, stops the batcher, and stop() re-raises."""
    slot = serving.ModelSlot()
    slot.publish(1, "not a model")
    svc = serving.InferenceService(tcfg(), R.FedConfig(n_clients=1, serve_batch=2), slot,
                                   img_size=IMG, device="cpu").start()
    try:
        with serving.InferenceClient(svc.host, svc.port, timeout=30.0) as c:
            with pytest.raises(ConnectionError):
                c.infer(scenes(1)[0])
    finally:
        with pytest.raises(RuntimeError, match="batcher failed"):
            svc.stop()
    assert isinstance(svc.error, AttributeError)  # the program called a str as a model


def test_cos_round_restores_across_packages(tmp_path):
    """JAX put_model -> port restore, and port put_model -> JAX restore_into:
    every leaf bit-identical, key paths the reference's."""
    tree = reference_weights()
    JStore(tmp_path / "a").put_model("fedyolo", 3, tree)
    store = ObjectStore(tmp_path / "a")
    assert store.rounds("fedyolo") == [3]
    model = store.restore_into("fedyolo", FedYOLOv3(tcfg(), torch.Generator().manual_seed(9)))
    for (k, a), (k2, b) in zip(flatten_with_paths(tree), flatten_with_paths(convert.to_reference(model))):
        assert k == k2
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=k)

    mine = FedYOLOv3(tcfg(), torch.Generator().manual_seed(4))
    ObjectStore(tmp_path / "b").put_model("fedyolo", 5, mine, meta={"note": "port"})
    jstore = JStore(tmp_path / "b")
    assert jstore.rounds("fedyolo") == [5]
    assert "stages/0/down" in jstore.get_model("fedyolo")
    blank = jparams.init_params(jyolo.template(jcfg()), jax.random.key(0), jnp.float32)
    restored = jstore.restore_into("fedyolo", blank)
    for (k, a), (_, b) in zip(flatten_with_paths(convert.to_reference(mine)),
                              jax.tree_util.tree_flatten_with_path(restored)[0]):
        np.testing.assert_array_equal(a.view(np.int32), np.asarray(b).view(np.int32), err_msg=k)


def test_cuda_is_never_a_silent_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        D.resolve("cuda")
    slot = serving.ModelSlot()
    slot.publish(1, "model")
    with pytest.raises(RuntimeError, match="cuda"):
        serving.InferenceService(tcfg(), R.FedConfig(n_clients=1), slot, img_size=IMG)


def _run(args, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT)


def test_serve_cli_runs_the_port_service_on_cpu():
    r = _run(["-m", "repro_torch.launch.serve", "--arch", "fedyolov3", "--img-size", "32",
              "--requests", "4", "--serve-batch", "4", "--device", "cpu"])
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["dropped"] == 0 and out["requests"] == 4 and out["device"] == "cpu"


def _serves_lm(arch: str) -> None:
    r = _run(["-m", "repro_torch.launch.serve", "--arch", arch, "--device", "cpu",
              "--prompt-len", "16", "--new-tokens", "4"])
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["arch"] == f"{arch}-reduced" and len(out["generated"]) == 4 and out["device"] == "cpu"


def test_serve_cli_refuses_unported_arch():
    """The hybrid once refused here is served since slice 7c; an arch
    neither package knows is refused."""
    _serves_lm("zamba2-2.7b")
    r = _run(["-m", "repro_torch.launch.serve", "--arch", "no-such-arch", "--device", "cpu"])
    assert r.returncode != 0 and "unknown arch" in r.stderr


def test_serve_cli_refuses_unported_moe_arch():
    """The MoE arch once refused here is served since slice 7c."""
    _serves_lm("granite-moe-1b-a400m")


def test_serve_cli_refuses_the_encoder_only_arch():
    r = _run(["-m", "repro_torch.launch.serve", "--arch", "hubert-xlarge", "--device", "cpu"])
    assert r.returncode != 0 and "hubert-xlarge is encoder-only: no decode step" in r.stderr


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    r = _run(["-c", code], timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) >= 15  # every module of the slice was imported
