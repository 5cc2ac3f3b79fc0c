"""The port's arrival plane (``repro_torch.core.async_engine``'s
``ArrivalAsyncEngine`` and ``build_row_update``, ``core/transport/codec.py``
and ``core/transport/replay.py``, the launcher's ``--replay-schedule``) held
against the reference.

A schedule is recorded by driving the reference's arrival engine through a
fixed dispatch/land plan (each landing trained by its row update and sent
through its codec, every decision written down as a ``WireEvent``), and
the reference's own ``replay`` accepts it. The port then replays that JSON.
The model is the reduced qwen3-1.7b cut to the wire tests' tiny widths
(``harness.TINY_OVERRIDES``), 3 clients, a flush every 2 landings,
max_staleness 1, so the plan holds a staleness-1 landing and a drop.
Tolerances, each stated where it is used:

- codec bytes, schedule JSON, the event plane, ``ReplayMismatch``'s event
  index, the export/import round trip, and the port's replay of its own
  dense record: exact;
- the port's replay of its own quant8 record: 1e-5, the replay contract;
- the port against the reference (row update, replayed globals): params
  rtol 1e-4 / atol 1e-6 and losses rtol 1e-5 (``tests/test_torch_train_rounds.py``'s
  round bounds; the two packages' training rounds differently in f32).
  Under quant8 that 1e-7 training gap flips a delta's rounding decision
  that sits on a half step (measured: 5 elements of 107,072), as it does
  in ``tests/test_torch_aggregation_rounds.py``'s rounds: at most 1 element in
  10^4 may then differ, by at most one quantization step of the record's
  deltas.
"""
import dataclasses
import json
import sys

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax.numpy as jnp

from repro.core import async_engine as jae
from repro.core.transport import codec as jcodec
from repro.core.transport import harness
from repro.core.transport import replay as jrp
from repro.launch import train as jtrain
from repro_torch.core import async_engine as ae
from repro_torch.core import rounds
from repro_torch.core.transport import codec
from repro_torch.core.transport import replay as rp
from repro_torch.launch import train
from repro_torch.optim import adamw, sgd

CODECS = ["dense", "quant8", "quant4", "topk"]
# (kind, client, t) or (kind, client, seq, t): two flushes, a staleness-2
# landing (dropped), a staleness-1 landing, four flushes in all
PLAN = [("dispatch", 0, 0.0), ("dispatch", 1, 0.0), ("dispatch", 2, 0.0),
        ("land", 0, 0, 1.0), ("land", 1, 0, 1.5),
        ("dispatch", 0, 1.6), ("dispatch", 1, 1.6),
        ("land", 1, 1, 2.0), ("land", 0, 1, 2.5),
        ("land", 2, 0, 3.0),
        ("dispatch", 0, 3.1), ("dispatch", 1, 3.1),
        ("land", 2, 1, 4.0), ("land", 0, 2, 4.5),
        ("dispatch", 2, 4.6), ("dispatch", 0, 4.6),
        ("land", 1, 2, 5.0), ("land", 2, 2, 5.5)]
DROP_INDEX = 9  # PLAN's landing of client 2 at staleness 2


def _meta(**kw):
    base = dict(overrides=harness.TINY_OVERRIDES, n_clients=3, buffer_size=2, max_staleness=1,
                seq=8, batch=2, quant_block=512)
    base.update(kw)
    return harness.make_meta(**base)


def _record(pkg, meta, plan=PLAN):
    """Drive ``pkg``'s arrival engine through ``plan`` -> (the schedule of
    what it did, the engine)."""
    if pkg == "jax":
        mod, cod, eng = jrp, jcodec, jrp.make_engine(meta)
        upd = jae.build_row_update(mod.build_cfg(meta), mod.build_fed(meta),
                                   mod.build_optimizer(meta))
        train_row = lambda base, b: upd(jnp.asarray(base), b)
    else:
        mod, cod, eng = rp, codec, rp.make_engine(meta, device="cpu")
        upd = ae.build_row_update(mod.build_cfg(meta), mod.build_fed(meta),
                                  mod.build_optimizer(meta))
        train_row = lambda base, b: upd(torch.from_numpy(base), rounds.to_device(b, "cpu"))
    cfg = mod.build_cfg(meta)
    events, steps = [], [0.0]
    for kind, c, *rest in plan:
        if kind == "dispatch":
            (t,) = rest
            eng.clock.advance_to(max(t, eng.clock.now()))
            events.append(mod.WireEvent("dispatch", t, c, eng.dispatch(c)))
            continue
        seq, t = rest
        version, base = int(eng.dispatch_version[c]), eng.dispatch_row(c)
        trained, loss = train_row(base, mod.synth_client_batch(cfg, meta, c, seq))
        trained = np.asarray(trained, np.float32)
        landed = cod.decode_update(cod.encode_update(trained, base, meta["wire_codec"],
                                                     meta["quant_block"]), base)
        if meta["wire_codec"] == "quant8":
            steps.append(float(cod.quantize_blocks(trained - base, meta["quant_block"])[1].max()))
        res = eng.land(c, landed, loss=float(loss), t=t)
        events.append(mod.WireEvent("land", t, c, version, seq=seq, dropped=res.dropped,
                                    flush=-1 if res.flush is None else res.flush.round_idx))
    sched = mod.ArrivalSchedule(meta, events)
    sched.max_step = max(steps)  # the largest quantization step of a landed delta
    return sched, eng


def _same_flushes(ours, ref):
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        assert (a.participants, a.staleness, a.dropped, a.sim_time, a.weights) == (
            b.participants, b.staleness, b.dropped, b.sim_time, b.weights)
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-5)


# ------------------------------ codec ---------------------------------------

@pytest.mark.parametrize("name", CODECS)
def test_codec_bytes_equal_reference(name):
    rng = np.random.default_rng(CODECS.index(name))
    for n, block in ((3000, 256), (1, 64), (4097, 1024)):
        base = rng.normal(size=n).astype(np.float32)
        row = (base + rng.normal(size=n) * 1e-3).astype(np.float32)
        buf = codec.encode_update(row, base, name, block)
        assert buf == jcodec.encode_update(row, base, name, block)
        np.testing.assert_array_equal(codec.decode_update(buf, base),
                                      jcodec.decode_update(buf, base))
        assert len(buf) == codec.payload_bytes(n, name, block) == jcodec.payload_bytes(n, name, block)
        assert codec.encode_row(row, name) == jcodec.encode_row(row, name)
        np.testing.assert_array_equal(codec.decode_row(codec.encode_row(row, name)), row)
    if name == "dense":  # every dtype the dense codec carries
        for dt in (np.float16, np.float64):
            x = rng.normal(size=33).astype(dt)
            assert codec.encode_dense(x) == jcodec.encode_dense(x)


# ------------------------------ row update and arrival engine ----------------

def test_row_update_matches_reference():
    meta = _meta()
    jcfg, cfg = jrp.build_cfg(meta), rp.build_cfg(meta)
    jupd = jae.build_row_update(jcfg, jrp.build_fed(meta), jrp.build_optimizer(meta))
    upd = ae.build_row_update(cfg, rp.build_fed(meta), rp.build_optimizer(meta))
    row = jrp.make_engine(meta).dispatch_row(0)
    batch = jrp.synth_client_batch(jcfg, meta, 1, 3)
    ours_batch = rp.synth_client_batch(cfg, meta, 1, 3)
    np.testing.assert_array_equal(ours_batch["tokens"].numpy(), np.asarray(batch["tokens"]))
    jrow, jloss = jupd(jnp.asarray(row), batch)
    base = torch.from_numpy(row.copy())
    trained, loss = upd(base, ours_batch)
    assert np.array_equal(base.numpy(), row)  # the dispatch row is not changed
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(trained.numpy(), np.asarray(jrow), rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="stateless"):
        ae.build_row_update(cfg, rp.build_fed(meta), sgd(0.05))


def test_arrival_engine_guards_and_refusals():
    meta = _meta()
    cfg, fed = rp.build_cfg(meta), rp.build_fed(meta)
    opt0 = sgd(0.05, momentum=0.0)
    mk = lambda f, opt=opt0: ae.ArrivalAsyncEngine(cfg, f, opt, device="cpu")
    with pytest.raises(ValueError, match="stateless"):
        mk(fed, adamw(1e-3))
    with pytest.raises(ValueError, match="mode"):
        mk(dataclasses.replace(fed, mode="sync"))
    with pytest.raises(ValueError, match="buffer_size"):
        mk(dataclasses.replace(fed, buffer_size=99))
    with pytest.raises(ValueError, match="stream"):
        mk(dataclasses.replace(fed, stream=True))
    eng = rp.make_engine(meta, device="cpu")
    base = eng.dispatch_row(0)
    eng.land(0, base + 1.0)
    with pytest.raises(RuntimeError, match="staged"):
        eng.dispatch(0)
    with pytest.raises(RuntimeError, match="already staged"):
        eng.land(0, base + 2.0)
    # the mid-window hazard: client 0's next update lands on global_row
    rec = eng.land(1, base + 2.0)
    g1 = eng.global_packed_row().clone()
    assert rec.flush.participants == [0, 1] and eng.global_row == 0
    eng.land(0, base + 50.0)
    assert torch.equal(eng.global_packed_row(), g1)
    eng.land(1, base + 7.0)  # second flush
    g2 = eng.global_packed_row()
    res = eng.land(2, base + 9.0)  # staleness 2 > 1: dropped, redispatched the true global
    assert res.dropped and res.staleness == 2 and eng.dropped_total == 1
    np.testing.assert_array_equal(eng.dispatch_row(2), g2.numpy())
    # the arrival engine starts from make_state's row 0 at its seed
    fed_s = dataclasses.replace(fed, mode="sync")
    st = rounds.make_state(cfg, fed_s, opt0, rounds.seed_generator(cfg, 0, "cpu"), "cpu")
    assert torch.equal(rp.make_engine(meta, device="cpu").global_packed_row(), st["params"][0])


@pytest.mark.parametrize("aggregation", ["dense", "eq6"])
def test_export_import_round_trip_is_bitwise(aggregation):
    meta = _meta(aggregation=aggregation)
    plan = PLAN[:13]  # ends mid-window: client 2 staged, awaiting the flush
    _, eng = _record("torch", meta, plan)
    assert eng.staged() == (2,) and eng.dropped_total == 1
    snap = eng.export_state()
    back = rp.make_engine(meta, device="cpu")
    back.import_state({"arrays": snap["arrays"], "scalars": json.loads(json.dumps(snap["scalars"]))})
    again = back.export_state()
    # the history is not part of a snapshot (the reference's neither)
    drop = lambda d: {k: v for k, v in d.items() if k != "n_history"}
    assert drop(again["scalars"]) == drop(snap["scalars"])
    assert set(again["arrays"]) == set(snap["arrays"])
    for k, v in snap["arrays"].items():
        assert v.dtype == again["arrays"][k].dtype and np.array_equal(
            v.view(np.uint8), again["arrays"][k].view(np.uint8)), k
    # both finish the window identically
    for e in (eng, back):
        e.land(0, e.dispatch_row(0) + np.float32(0.25), loss=1.0, t=6.0)
    assert torch.equal(eng.global_packed_row(), back.global_packed_row())
    assert eng.history[-1] == back.history[-1]


# ------------------------------ replay --------------------------------------

def _port_engine_from_reference(meta):
    """A fresh port engine holding the reference engine's initial state,
    carried by the snapshot format both packages share."""
    eng = rp.make_engine(meta, device="cpu")
    eng.import_state(jrp.make_engine(meta).export_state())
    return eng


@pytest.mark.parametrize("wire_codec", ["dense", "quant8"])
def test_reference_schedule_replays_through_the_port(wire_codec, tmp_path):
    meta = _meta(wire_codec=wire_codec)
    sched, _ = _record("jax", meta)
    assert sched.n_flushes == 4 and sched.n_dropped == 1
    path = tmp_path / "ref.schedule.json"
    sched.save(path)
    jrep = jrp.replay(jrp.ArrivalSchedule.load(path))  # the reference accepts its record
    ours = rp.ArrivalSchedule.load(path)
    assert ours.to_json() == sched.to_json()
    rp.replay(ours, device="cpu")  # from the port's own initial global: no mismatch
    eng = rp.apply_events(_port_engine_from_reference(meta), ours.events, ours.meta)
    _same_flushes(eng.history, jrep.history)
    assert eng.dropped_total == jrep.dropped_total == 1
    np.testing.assert_array_equal(eng.dispatch_version, jrep.dispatch_version)
    for a, b in ((eng.global_packed_row().numpy(), np.asarray(jrep.global_packed_row())),
                 (eng.state["params"].numpy(), np.asarray(jrep.state["params"]))):
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-6)
        assert off.sum() <= (1e-4 * a.size if wire_codec == "quant8" else 0), int(off.sum())
        np.testing.assert_allclose(a[off], b[off], rtol=0, atol=sched.max_step)


@pytest.mark.parametrize("wire_codec", ["dense", "quant8"])
def test_port_replay_reproduces_its_record(wire_codec):
    """The replay contract within the port: its own record replays bit for
    bit under dense, within 1e-5 under quant8; the reference replays the
    port's record without a mismatch."""
    meta = _meta(wire_codec=wire_codec)
    sched, eng = _record("torch", meta)
    rep = rp.replay(rp.ArrivalSchedule.from_json(sched.to_json()), device="cpu")
    got, want = rep.global_packed_row(), eng.global_packed_row()
    if wire_codec == "dense":
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    _same_flushes(rep.history, eng.history)
    jrep = jrp.replay(jrp.ArrivalSchedule.from_json(sched.to_json()))
    assert [r.participants for r in jrep.history] == [r.participants for r in eng.history]


def test_tampered_event_raises_at_its_index():
    meta = _meta()
    sched, _ = _record("jax", meta)
    assert sched.events[DROP_INDEX].dropped
    flipped = rp.ArrivalSchedule.from_json(sched.to_json())
    flipped.events[DROP_INDEX] = dataclasses.replace(flipped.events[DROP_INDEX], dropped=False)
    with pytest.raises(rp.ReplayMismatch, match=f"^event {DROP_INDEX} \\(land client 2"):
        rp.replay(flipped, device="cpu")
    moved = rp.ArrivalSchedule.from_json(sched.to_json())
    moved.events[5] = dataclasses.replace(moved.events[5], version=7)  # a dispatch
    with pytest.raises(rp.ReplayMismatch, match="^event 5 \\(dispatch client 0"):
        rp.replay(moved, device="cpu")


def test_launcher_replay_schedule_matches_reference(tmp_path, monkeypatch, capsys):
    """``--replay-schedule`` replays the reference's record from the port's
    own initial global: the same events, flushes and drops; the loss is
    the port's (its initial model is drawn by torch)."""
    sched, _ = _record("jax", _meta())
    path = tmp_path / "run.schedule.json"
    sched.save(path)
    monkeypatch.setattr(sys, "argv", ["train", "--replay-schedule", str(path)])
    jtrain.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ours = train.main(["--device", "cpu", "--replay-schedule", str(path)])
    for k in ("replayed_events", "flushes", "dropped", "deterministic"):
        assert ours[k] == ref[k], k
    assert np.isfinite(ours["final_loss"]) and ours["device"] == "cpu"
