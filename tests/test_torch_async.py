"""The port's async control plane (``repro_torch.core.async_engine``: the
timing terms, the buffered and streaming engines, ``FLServer`` in async
mode, ``publish_from_engine``, the monitor's async lines and the launcher's
``--mode async`` / ``--stream``) held against the reference on identical
inputs.

Both packages start from the reference's initial state, carried across by
``models.convert.state_from_reference`` (eq6's aggregator state rebuilt
from it); batches and the load process come from the same NumPy seeds. The
model is fedyolov3 cut to base width 8 and 3 stages, at 32x32 images, 4
clients, a flush every 2 landings. Tolerances, each stated where it is used:

- the event plane (participants, staleness, drops, simulated time, the
  discounted weights), the timing terms and the monitor's text: exact;
- flush losses rtol 1e-5, params rtol 1e-4 / atol 1e-6 (the bounds of
  ``tests/test_torch_train.py``'s whole rounds);
- a full-buffer flush against the port's own sync round, and the rows in
  flight across a flush: bitwise;
- streaming against buffered: 1e-5 relative to the global's largest
  magnitude (``tests/test_stream_async.py``).
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.core import async_engine as jae
from repro.core import monitor as jmonitor
from repro.core import rounds as jrounds
from repro.core import explorer as jexplorer
from repro.data import pipeline as jpipeline
from repro.launch import train as jtrain
from repro.optim import sgd as jsgd
from repro_torch.configs import get_arch
from repro_torch.core import async_engine as ae
from repro_torch.core import explorer, monitor, rounds, serving
from repro_torch.core.server import FLServer
from repro_torch.core.simclock import SimClock
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.optim import adamw, sgd

JCFG = dataclasses.replace(jget_arch("fedyolov3").reduced(), d_model=8, n_layers=3)
TCFG = dataclasses.replace(get_arch("fedyolov3").reduced(), d_model=8, n_layers=3)
IMG = 32
C = 4
FLUSHES = 4
# client 3 runs ~2.5x slower than client 0: with max_staleness 1 it lands
# stale, and once too stale (dropped) within 4 flushes at seed 0
BASELINE = [0.1, 0.2, 0.5, 0.6]
ZERO_VAR = dict(straggler_frac=0.0, base_spread=0.0, jitter=0.0, spike_prob=0.0)


def _fed(pkg, **kw):
    base = dict(n_clients=C, local_steps=1, aggregation="eq6", topn=4, client_axis="data",
                data_axis=None, mode="async", buffer_size=2, max_staleness=1,
                staleness_alpha=0.5)
    base.update(kw)
    return (rounds.FedConfig if pkg == "torch" else jrounds.FedConfig)(**base)


def _load_model(mod, baseline=BASELINE, **cfg):
    lm = mod.ClientLoadModel(C, seed=0, config=mod.LoadModelConfig(**cfg) if cfg else None)
    lm.baseline = np.array(baseline, float)
    lm.loads = lm.baseline.copy()
    return lm


def _batches(seed=0):
    gen, _, _ = jpipeline.detection_suite(JCFG, _fed("jax", mode="sync"), batch=2, img_size=IMG,
                                          pool_scenes=24, seed=seed)
    return gen


def _carry(engine, jstate):
    """The reference's buffered state -> the port engine's, in place."""
    p, o = convert.state_from_reference(TCFG, np.asarray(jstate["params"]),
                                        jax.tree.map(np.asarray, jstate["opt"]))
    engine.state = {"params": p, "opt": o, "agg": engine.agg.init_state(p), "round": 0}


def _assert_same_event_plane(rec, jrec):
    assert rec.participants == jrec.participants
    assert rec.staleness == jrec.staleness
    assert rec.dropped == jrec.dropped
    assert rec.sim_time == jrec.sim_time
    assert rec.weights == jrec.weights
    assert rec.version == jrec.version and rec.round_idx == jrec.round_idx


# ------------------------------ timing terms --------------------------------

@pytest.mark.parametrize("kw", [{}, dict(uplink_spread=0.5), dict(uplink_spread=0.3, uplink_b_s=1e6),
                                dict(payload_bytes=2e6, base_compute_s=3.0, min_headroom=0.2)])
def test_timing_terms_equal_reference(kw):
    t, jt = ae.TimingModel(**kw), jae.TimingModel(**kw)
    for seed in (0, 5):
        up = ae.default_upload_terms(t, 7, 53_976, seed)
        np.testing.assert_array_equal(up, jae.default_upload_terms(jt, 7, 53_976, seed))
        np.testing.assert_array_equal(
            ae.client_upload_seconds(t, 5, 1e5, np.random.default_rng(seed)),
            jae.client_upload_seconds(jt, 5, 1e5, np.random.default_rng(seed)))
        loads = np.random.default_rng(seed).uniform(0, 1, 7)
        for mask in (None, np.array([1, 0, 1, 1, 0, 0, 1])):
            assert ae.sync_round_seconds(t, loads, up, 2, mask) == jae.sync_round_seconds(
                jt, loads, up, 2, mask)
        for load in (0.0, 0.5, 0.97):
            assert t.compute_seconds(load, 3) == jt.compute_seconds(load, 3)
    with pytest.raises(ValueError, match="spread"):
        ae.client_upload_seconds(ae.TimingModel(uplink_spread=1.0), 2, 1.0,
                                 np.random.default_rng(0))


def test_discounted_weights_equal_reference_formula():
    fed = _fed("torch", staleness_alpha=0.7)
    staged, stal = [3, 0, 2], [0, 2, 5]
    mask, w = ae.discounted_weights(fed, staged, stal)
    # BufferedAsyncEngine._do_flush's arithmetic, written out in NumPy f32
    m = np.zeros(C, np.float32)
    m[staged] = 1.0
    s = np.zeros(C, np.float32)
    s[staged] = stal
    want = (m / np.float32(3) * (1.0 + s) ** np.float32(-0.7)).astype(np.float32)
    np.testing.assert_array_equal(mask, m)
    np.testing.assert_array_equal(w, want)
    assert w[3] == np.float32(1.0 / 3)  # staleness 0: no discount, bit for bit


# ------------------------------ buffered engine ------------------------------

@pytest.mark.parametrize("mode", ["dense", "eq6"])
def test_buffered_engine_matches_reference(mode):
    """4 flushes with stragglers (staleness up to 1, one drop): the event
    plane exactly, losses rtol 1e-5, params rtol 1e-4 / atol 1e-6."""
    timing = dict(uplink_spread=0.5)
    jeng = jae.BufferedAsyncEngine(JCFG, _fed("jax", aggregation=mode), jsgd(1e-2), seed=0,
                                   load_model=_load_model(jexplorer),
                                   timing=jae.TimingModel(**timing))
    eng = ae.BufferedAsyncEngine(TCFG, _fed("torch", aggregation=mode), sgd(1e-2), seed=0,
                                 load_model=_load_model(explorer),
                                 timing=ae.TimingModel(**timing), device="cpu")
    np.testing.assert_array_equal(eng.upload_s, jeng.upload_s)
    _carry(eng, jeng.state)
    gen = _batches()
    stal, dropped = [], 0
    for _ in range(FLUSHES):
        b = next(gen)
        jrec = jeng.step_round(jax.tree.map(jnp.asarray, b))
        rec = eng.step_round(b)
        _assert_same_event_plane(rec, jrec)
        stal += rec.staleness
        dropped += rec.dropped
        np.testing.assert_allclose(rec.loss, jrec.loss, rtol=1e-5)
        np.testing.assert_allclose(eng.state["params"].numpy(), np.asarray(jeng.state["params"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(eng.global_packed_row().numpy(),
                                   np.asarray(jeng.global_packed_row()), rtol=1e-4, atol=1e-6)
        assert eng.global_row == jeng.global_row
    assert max(stal) >= 1 and dropped >= 1  # the stragglers really bit
    assert eng.completions == jeng.completions and eng.dropped_total == jeng.dropped_total
    np.testing.assert_array_equal(eng.dispatch_version, jeng.dispatch_version)
    _, mu = convert.state_to_reference(TCFG, eng.state["params"], eng.state["opt"])
    for a, b in zip(jax.tree.leaves(mu), jax.tree.leaves(jeng.state["opt"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    if mode == "eq6":
        np.testing.assert_allclose(eng.state["agg"]["prev_sums"].numpy(),
                                   np.asarray(jeng.state["agg"]["prev_sums"]), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["dense", "eq6"])
def test_full_buffer_flush_equals_sync_round_bitwise(mode):
    """buffer_size == C, zero load variance, alpha 0: every flush IS the
    port's sync round, bit for bit (params, opt rows, agg state, loss)."""
    eng = ae.BufferedAsyncEngine(TCFG, _fed("torch", aggregation=mode, buffer_size=C,
                                            staleness_alpha=0.0, max_staleness=0), sgd(1e-2),
                                 seed=0, load_model=explorer.ClientLoadModel(
                                     C, seed=0, config=explorer.LoadModelConfig(**ZERO_VAR)),
                                 device="cpu")
    fed_s = _fed("torch", aggregation=mode, mode="sync")
    state = rounds.make_state(TCFG, fed_s, sgd(1e-2), torch.Generator().manual_seed(0), "cpu")
    fr = rounds.build_fed_round(TCFG, fed_s, sgd(1e-2))
    gen = _batches()
    for _ in range(2):
        b = next(gen)
        rec = eng.step_round(b)
        state, m = fr(state, rounds.to_device(b, "cpu"), rounds.uniform_weights(C))
        assert rec.staleness == [0] * C and rec.participants == list(range(C))
        assert float(m["loss"]) == rec.loss
    assert torch.equal(state["params"].view(torch.int32), eng.state["params"].view(torch.int32))
    for k in state["opt"]:
        assert torch.equal(state["opt"][k], eng.state["opt"][k]), k
    for k in state["agg"]:
        assert torch.equal(state["agg"][k], eng.state["agg"][k]), k


@pytest.mark.parametrize("mode", ["dense", "eq6"])
def test_buffered_flush_preserves_in_flight_rows(mode):
    """The port's aggregators write the global into every row; the flush
    puts the in-flight rows back: bit for bit their dispatch version."""
    eng = ae.BufferedAsyncEngine(TCFG, _fed("torch", aggregation=mode), sgd(1e-2), seed=0,
                                 load_model=_load_model(explorer), device="cpu")
    gen = _batches()
    redispatched = 0
    for _ in range(FLUSHES):
        before, old_global = eng.state["params"].clone(), eng.global_packed_row()
        version = eng.dispatch_version.copy()
        rec = eng.step_round(next(gen))
        after = eng.state["params"]
        in_flight = [c for c in range(C) if c not in rec.participants]
        assert in_flight
        for c in in_flight:
            # a client dropped in this window was redispatched the old global
            want = before[c] if eng.dispatch_version[c] == version[c] else old_global
            redispatched += eng.dispatch_version[c] != version[c]
            assert torch.equal(after[c].view(torch.int32), want.view(torch.int32)), c
        g = after[rec.participants[0]]
        for c in rec.participants:  # staged rows redispatch with the new global
            assert torch.equal(after[c], g) and not torch.equal(after[c], before[c])
        assert torch.equal(eng.global_packed_row(), g)
    assert redispatched >= 1  # a drop's redispatch was exercised


def test_async_engine_refusals():
    fed = _fed("torch")
    mk = lambda f, opt=sgd(1e-2): ae.BufferedAsyncEngine(TCFG, f, opt, device="cpu")
    with pytest.raises(ValueError, match="buffer_size"):
        mk(dataclasses.replace(fed, buffer_size=C + 1))
    with pytest.raises(ValueError, match="mode='async'"):
        mk(dataclasses.replace(fed, mode="sync"))
    with pytest.raises(ValueError, match="participation"):
        mk(dataclasses.replace(fed, participation="masked"))
    with pytest.raises(ValueError, match="max_staleness"):
        mk(dataclasses.replace(fed, max_staleness=-1))
    with pytest.raises(ValueError, match="client-stacked"):
        mk(dataclasses.replace(fed, aggregation="fedsgd"))
    with pytest.raises(ValueError, match="BufferedAsyncEngine"):
        rounds.build_fed_round(TCFG, fed, sgd())
    with pytest.raises(ValueError, match="mode"):
        FLServer(TCFG, dataclasses.replace(fed, mode="nope"), sgd(), device="cpu")


# ------------------------------ streaming engine -----------------------------

def test_streaming_engine_matches_reference_and_buffered():
    """Streaming against the reference's streaming engine (carried ring) and
    against the port's buffered twin from the same seed (one initial
    global: ring row 0 is make_state's row 0): the event plane exactly, the
    global within 1e-5 of its largest magnitude."""
    kw = dict(aggregation="dense", stream=True, max_staleness=2, buffer_size=2)
    opt = lambda m: m(lr=1e-2, momentum=0.0)
    timing = dict(uplink_spread=0.5)
    jeng = jae.StreamingAsyncEngine(JCFG, _fed("jax", **kw), opt(jsgd), seed=0,
                                    load_model=_load_model(jexplorer),
                                    timing=jae.TimingModel(**timing))
    eng = ae.StreamingAsyncEngine(TCFG, _fed("torch", **kw), opt(sgd), seed=0,
                                  load_model=_load_model(explorer),
                                  timing=ae.TimingModel(**timing), device="cpu")
    twin = ae.BufferedAsyncEngine(TCFG, _fed("torch", **{**kw, "stream": False}), opt(sgd), seed=0,
                                  load_model=_load_model(explorer),
                                  timing=ae.TimingModel(**timing), device="cpu")
    n = eng.agg.ctx.spec.n_total
    assert eng.state["ring"].shape == (3, n) and eng.state["agg"]["acc"].shape == (n,)
    assert torch.equal(eng.state["ring"][0], twin.state["params"][0])
    ring0 = np.asarray(jeng.state["ring"])
    eng.state["ring"] = torch.tensor(ring0)
    twin.state["params"] = torch.tensor(ring0[:1]).expand(C, -1).contiguous()
    twin.state["agg"] = twin.agg.init_state(twin.state["params"])
    gen = _batches()
    for _ in range(FLUSHES):
        b = next(gen)
        jrec = jeng.step_round(jax.tree.map(jnp.asarray, b))
        rec, trec = eng.step_round(b), twin.step_round(b)
        _assert_same_event_plane(rec, jrec)
        assert (trec.participants, trec.staleness, trec.dropped) == (
            rec.participants, rec.staleness, rec.dropped)
        np.testing.assert_allclose(rec.loss, jrec.loss, rtol=1e-5)
        g = eng.global_packed_row().double().numpy()
        for other in (np.asarray(jeng.global_packed_row(), np.float64),
                      twin.global_packed_row().double().numpy()):
            assert np.max(np.abs(g - other)) / max(np.max(np.abs(other)), 1e-9) < 1e-5
    assert eng.dropped_total == jeng.dropped_total


def test_streaming_refusals():
    opt0 = sgd(lr=0.05, momentum=0.0)
    fed = _fed("torch", aggregation="dense", stream=True, max_staleness=3)
    mk = lambda f, opt=opt0: ae.StreamingAsyncEngine(TCFG, f, opt, device="cpu")
    with pytest.raises(ValueError, match="max_staleness"):
        mk(dataclasses.replace(fed, max_staleness=0))
    with pytest.raises(ValueError, match="dense"):
        mk(dataclasses.replace(fed, aggregation="eq6"))
    with pytest.raises(ValueError, match="stateless"):
        mk(fed, sgd(lr=0.05))  # momentum state
    with pytest.raises(ValueError, match="stateless"):
        mk(fed, adamw(1e-3))
    with pytest.raises(ValueError, match="stream=True"):
        mk(dataclasses.replace(fed, stream=False))
    with pytest.raises(ValueError, match="StreamingAsyncEngine"):
        ae.BufferedAsyncEngine(TCFG, fed, opt0, device="cpu")


# ------------------------------ server, serving, monitor ---------------------

def test_server_runs_async_and_reads_the_engine_global():
    fed = _fed("torch", aggregation="dense")
    srv = FLServer(TCFG, fed, sgd(1e-2), seed=0, device="cpu", load_model=_load_model(explorer))
    with pytest.raises(RuntimeError, match="run_async"):
        srv.run_round(next(_batches()))
    assert srv.next_time() == srv.engine.next_completion_time()
    hist = srv.fit(_batches(), 3, log=None)
    assert len(hist) == 3 and srv.state is srv.engine.state
    assert [r.sim_time for r in hist] == sorted(r.sim_time for r in hist)
    seen = sorted({c for r in hist for c in r.participants})
    assert not np.isnan(srv.scheduler.last_loss[seen]).any()  # completions fed the EMA
    # the global is the last flush's first staged row, not row 0
    want = rounds.global_model(TCFG, srv.state["params"][srv.engine.global_row], "cpu")
    for k, v in srv.global_params().state_dict().items():
        assert torch.equal(v, want.state_dict()[k]), k
    with pytest.raises(NotImplementedError, match="slice 6"):
        FLServer(TCFG, fed, sgd(), device="cpu", clock=SimClock())


def test_publish_from_engine_serves_the_landed_global_and_keeps_it():
    eng = ae.BufferedAsyncEngine(TCFG, _fed("torch", aggregation="dense"), sgd(1e-2), seed=0,
                                 load_model=_load_model(explorer), device="cpu")
    gen = _batches()
    eng.step_round(next(gen))
    slot = serving.ModelSlot()
    assert serving.publish_from_engine(slot, eng, TCFG)
    pub = slot.snapshot()
    assert pub.version == eng.version == 1
    want = rounds.global_model(TCFG, eng.global_packed_row(), "cpu").state_dict()
    kept = {k: v.clone() for k, v in pub.params.state_dict().items()}
    for k, v in kept.items():
        assert torch.equal(v, want[k]), k
    eng.step_round(next(gen))  # further landings and a flush rewrite the rows in place
    eng.step_round(next(gen))
    for k, v in pub.params.state_dict().items():
        assert torch.equal(v, kept[k]), k
    assert serving.publish_from_engine(slot, eng, TCFG) and slot.snapshot().version == 3


def test_monitor_renders_async_records_as_reference():
    recs = [dict(round_idx=i, loss=2.0 - 0.1 * i, weights=[0.5, 0.5, 0.0], seconds=0.1,
                 participants=[0, 1], loads=[0.2, 0.3, 0.9], version=i + 1,
                 sim_time=30.0 * (i + 1), staleness=[0, i], dropped=i % 2) for i in range(3)]
    ours = monitor.render_task("demo", [ae.AsyncRoundRecord(**r) for r in recs], 3)
    assert ours == jmonitor.render_task("demo", [jae.AsyncRoundRecord(**r) for r in recs], 3)
    assert "sim clock 90s" in ours and "dropped 1" in ours


# ------------------------------ the launcher --------------------------------

@pytest.mark.parametrize("flags", [["--buffer-size", "2", "--max-staleness", "1"],
                                   ["--stream", "--buffer-size", "2"]])
def test_launcher_async_matches_reference_launcher(flags, monkeypatch, capsys):
    """The event plane of ``--mode async`` (and ``--stream``) equals the
    reference launcher's: sim_seconds, mean_staleness and dropped exactly."""
    common = ["--arch", "qwen3-1.7b", "--rounds", "3", "--clients", "3", "--batch", "1",
              "--seq", "16", "--mode", "async", *flags]
    monkeypatch.setattr(sys, "argv", ["train", *common])
    jtrain.main()
    import json

    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ours = train.main(["--device", "cpu", *common])
    assert ref["mode"] == ours["mode"] == "async" and ours["rounds"] == 3
    for k in ("sim_seconds", "mean_staleness", "dropped", "mean_participants", "participation"):
        assert ours[k] == ref[k], k
    assert np.isfinite(ours["final_loss"])
