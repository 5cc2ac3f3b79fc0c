"""The port's socket wire (``repro_torch.core.transport.{server,harness}``,
``repro_torch.launch.worker``, ``core.monitor.render_wire``) held against
the reference, on the host.

Every run here is a real multi-process federation: the ``WireServer`` in
this process, worker processes over TCP (``--device cpu``, one intra-op
thread each) training the reduced qwen3-1.7b cut to the wire tests' tiny
widths (``harness.TINY_OVERRIDES``). Each passes ``deadline_s`` of at most
60 and asserts the deadline was not hit. Tolerances, each stated where it
is used:

- the recorded schedule replayed through the port's engine: bitwise
  (dense), 1e-5 (quant8, quant4), the replay contract;
- the same schedule replayed through the reference's engine, started from
  the port's initial state (the snapshot format carries it): rtol 1e-4 /
  atol 1e-6, ``tests/test_torch_replay.py``'s bound for the two packages'
  f32 training; under quant8 that gap may flip a delta's rounding on a half
  step, so at most 1 element in 10^4 of each landed delta may differ, by
  at most one quantization step of the run's deltas (a socket run lands
  10 or 11 deltas; 12 of 107,072 elements were seen to differ);
- the monitor's lines, the meta, the worker's flags, the stats merge:
  exact.

The scenarios are the reference's (``tests/test_scenarios.py``), each
choreographed so the ordering it needs is forced: a client crash whose
crash is a precondition of the last flush (the reference's races: its
survivors can finish first) in which the heartbeat timeout finds the dead
peer, a straggler dropped at the staleness gate, a reconnect under the
same id, and backpressure on a bounded queue.
"""
import dataclasses
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core.transport import codec as jcodec
from repro.core.transport import harness as jharness
from repro.core.transport import replay as jrp
from repro.core.transport import server as jserver
from repro.core.transport import wire as jwire
from repro.core import monitor as jmonitor
from repro.launch import worker as jworker
from repro_torch.core import async_engine as ae
from repro_torch.core import monitor
from repro_torch.core.simclock import SimClock, WallClock
from repro_torch.core.transport import codec, harness, wire
from repro_torch.core.transport import replay as rp
from repro_torch.core.transport.server import WireRunStats, WireServer
from repro_torch.launch import worker
from repro_torch.launch.worker import CRASH_EXIT_CODE

TINY = harness.TINY_OVERRIDES
DEADLINE_S = 60.0
# a worker whose upload meets the server closing after the last flush
# reconnects; this budget ends that in about 0.15 s instead of the default's
# several seconds (no scenario here reconnects to a live server by backoff)
QUICK = ["--connect-retries", "3", "--backoff-base", "0.05"]


def _meta(**kw):
    base = dict(overrides=TINY, seq=8, batch=2)
    base.update(kw)
    return harness.make_meta(**base)


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Worker processes train with one intra-op thread: six test workers
    each spawning them share the host's cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _wire(meta, n_flushes, **kw):
    res = harness.wire_run(meta, n_flushes, deadline_s=DEADLINE_S, device="cpu", **kw)
    assert not res.stats.deadline_hit, (res.stats, res.worker_stderr)
    return res


def _replay_with_steps(res):
    """The recorded schedule through the port's engine -> (engine, the
    largest quantization step of a landed delta)."""
    meta = res.schedule.meta
    update = ae.build_row_update(rp.build_cfg(meta), rp.build_fed(meta), rp.build_optimizer(meta))
    steps = [0.0]

    def stepped(row, batch):
        trained, loss = update(row, batch)
        if meta["wire_codec"] != "dense":
            delta = (trained - row).numpy()
            steps.append(float(codec.quantize_blocks(delta, int(meta["quant_block"]))[1].max()))
        return trained, loss

    eng = rp.make_engine(meta, clock=SimClock(), device="cpu")
    return rp.apply_events(eng, res.schedule.events, meta, update=stepped), max(steps)


def _pin_replay(res, tol=0.0):
    """The scenario's spine: the recorded schedule re-derives identically
    (``apply_events`` raises at the first divergent decision) and lands on
    the run's global, bitwise under dense."""
    eng, step = _replay_with_steps(res)
    got = eng.global_packed_row().numpy()
    if tol == 0.0:
        assert np.array_equal(got.view(np.int32), res.global_row.view(np.int32))
    else:
        np.testing.assert_allclose(got, res.global_row, atol=tol, rtol=0)
    assert len(eng.history) == len(res.history) and eng.dropped_total == res.dropped_total
    return eng, step


def _spawn_when(cond, meta, path, client_ids, extra=()):
    """A hook for ``wire_run``: start a worker process for ``client_ids``
    once ``cond(server)`` holds."""
    path.write_text(json.dumps(meta))

    def hook(server, workers):
        def go():
            deadline = time.monotonic() + DEADLINE_S
            while not cond(server) and time.monotonic() < deadline:
                time.sleep(0.02)
            workers.append(harness.spawn_worker(str(path), server.host, server.port, client_ids,
                                                list(extra), device="cpu"))

        threading.Thread(target=go, daemon=True).start()

    return hook


def _landed(client):
    return lambda server: any(e.kind == "land" and e.client == client
                              for e in list(server.schedule.events))


# ------------------------------ units ---------------------------------------

def test_frames_are_the_reference_bytes_and_parse_alike():
    """The port frames a row with one copy and parses with one; the bytes
    and the parsed frames are the reference's, under any chunking, with a
    corrupted frame withheld alike."""
    rng = np.random.default_rng(5)
    row = rng.standard_normal(5000).astype(np.float32)
    payload = codec.encode_row(row, "dense")
    assert payload == jcodec.encode_row(row, "dense")
    for dt in (np.float16, np.float64):
        assert codec.encode_dense(row.astype(dt)) == jcodec.encode_dense(row.astype(dt))
    frames = [(wire.pack_hello(3), jwire.pack_hello(3)),
              (wire.pack_dispatch(7, payload), jwire.pack_dispatch(7, payload)),
              (wire.pack_update(3, 2, 7, 0.5, payload), jwire.pack_update(3, 2, 7, 0.5, payload)),
              (wire.pack_heartbeat(3), jwire.pack_heartbeat(3)), (wire.pack_bye(), jwire.pack_bye()),
              (wire.encode_frame(wire.STATUS, b"{}"), jwire.encode_frame(jwire.STATUS, b"{}"))]
    for ours, ref in frames:
        assert ours == ref
    stream = bytearray(b"".join(f for f, _ in frames))
    stream[len(frames[0][0]) + 40] ^= 0xFF  # damage the dispatch's body
    for trial in range(3):
        cuts = sorted(rng.choice(len(stream), size=[1, 7, 300][trial], replace=False))
        chunks = [bytes(stream[a:b]) for a, b in zip([0, *cuts], [*cuts, len(stream)])]
        ours, ref = wire.FrameParser(), jwire.FrameParser()
        got = [f for c in chunks for f in ours.feed(c)]
        want = [f for c in chunks for f in ref.feed(c)]
        assert got == want and len(got) == len(frames) - 1
        assert all(type(p) is bytes for _, p in got)
        assert ours.crc_errors == ref.crc_errors == 1 and ours.pending == 0

def test_wire_server_refuses_what_the_reference_refuses():
    meta = _meta(n_clients=2)
    eng = rp.make_engine(meta, device="cpu")  # a SimClock engine
    with pytest.raises(ValueError, match="WallClock"):
        WireServer(eng)
    eng = rp.make_engine(dict(meta, transport="inproc"), clock=WallClock(), device="cpu")
    with pytest.raises(ValueError, match="transport='socket'"):
        WireServer(eng)
    eng = rp.make_engine(dict(meta, wire_codec="zip"), clock=WallClock(), device="cpu")
    with pytest.raises(ValueError, match="wire_codec"):
        WireServer(eng)


def test_meta_and_worker_command_match_the_reference():
    assert harness.TINY_OVERRIDES == jharness.TINY_OVERRIDES
    for kw in (dict(), dict(overrides=TINY, n_clients=3, buffer_size=2, max_staleness=1, seq=8,
                            batch=2, wire_codec="quant8", quant_block=512, queue_cap=1),
               dict(arch="qwen3-1.7b", reduced=False, overrides={"n_layers": 2}, n_clients=4,
                    batch=1, seq=128, heartbeat_s=0.1, heartbeat_timeout_s=0.6)):
        assert harness.make_meta(**kw) == jharness.make_meta(**kw)
    cmd = harness.worker_cmd("m.json", "127.0.0.1", 5, [0, 2], ["--max-updates", "1"], device="cpu")
    ref = jharness.worker_cmd("m.json", "127.0.0.1", 5, [0, 2], ["--max-updates", "1"])
    assert cmd[1:3] == ["-m", "repro_torch.launch.worker"]
    assert cmd[3:] == ref[3:-2] + ["--device", "cpu"] + ref[-2:]
    # the device is the workers' flag, never the schedule's meta
    assert "device" not in harness.make_meta()


def test_worker_takes_the_reference_flags_and_defaults_plus_device():
    argv = ["--port", "1", "--meta", "m.json", "--client-ids", "0"]
    ours, ref = vars(worker._parse_args(argv)), vars(jworker._parse_args(argv))
    assert ours.pop("device") == "cuda" and ours == ref
    assert worker.CRASH_EXIT_CODE == jworker.CRASH_EXIT_CODE == 17


def test_worker_never_falls_back_to_the_host(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("this host has a card")
    path = tmp_path / "meta.json"
    path.write_text(json.dumps(_meta(n_clients=1)))
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        worker.main(["--port", "1", "--meta", str(path), "--client-ids", "0"])


def _history():
    return [SimpleNamespace(round_idx=i, loss=2.0 - 0.25 * i, weights=[0.5, 0.0, 0.5],
                            seconds=0.0, sim_time=1.5 * (i + 1), staleness=[0, i], dropped=i % 2)
            for i in range(3)]


@pytest.mark.parametrize("fields,log", [
    (dict(), ()),
    (dict(flushes=3, landed=6, dropped=1, heartbeats=40, reconnects=2, bytes_up=12_345_678,
          bytes_down=98_765, backpressure_blocks=3, queue_high_water=2, protocol_errors=1,
          superseded=2, deadline_hit=True), ((0.5, 1, "alive"), (2.0, 1, "dead"), (2.5, 0, "dead"))),
    (dict(flushes=5, landed=10, snapshots=2, wal_events=31, recoveries=1, faults_injected=1,
          crashed=True, crc_errors=2), ((1.0, 0, "alive"),)),
    (dict(wal_events=4), ()),
])
def test_render_wire_equals_the_reference_line_for_line(fields, log):
    ours = monitor.render_wire("qwen3-1.7b", _history(), WireRunStats(**fields), 3, liveness_log=log)
    ref = jmonitor.render_wire("qwen3-1.7b", _history(), jserver.WireRunStats(**fields), 3,
                               liveness_log=log)
    assert ours.splitlines() == ref.splitlines()
    assert ("durable" in ours) == any(k in fields for k in (
        "snapshots", "wal_events", "recoveries", "faults_injected", "crashed", "crc_errors"))


def test_merged_stats_equal_the_reference():
    a = dict(flushes=2, landed=5, dropped=1, queue_high_water=3, faults_injected=1, crashed=True,
             bytes_up=10, snapshots=1, wal_events=9)
    b = dict(flushes=3, landed=4, queue_high_water=2, faults_injected=1, recoveries=1, bytes_up=7,
             deadline_hit=False, wal_events=8)
    ours = harness._merge_stats(WireRunStats(**a), WireRunStats(**b))
    ref = jharness._merge_stats(jserver.WireRunStats(**a), jserver.WireRunStats(**b))
    assert {k: v for k, v in dataclasses.asdict(ours).items()
            if k not in ("landing_ms", "dispatch_ms", "snapshot_ms")} == dataclasses.asdict(ref)


# ------------------------------ scenarios -----------------------------------

def test_client_crash_midround_survivors_keep_flushing(tmp_path):
    """The crasher uploads once and exits with ``CRASH_EXIT_CODE`` while its
    window is still open; the survivors start only once that landing is
    recorded, so the run cannot finish without it (the reference's
    scenario races: its survivors may finish the three flushes first and
    the crasher then exits 0). The survivors' start outlasts the 1 s
    heartbeat timeout, so the liveness machine marks the crasher dead and
    never a survivor (the reference's heartbeat scenario)."""
    meta = _meta(n_clients=3, buffer_size=2, max_staleness=0, heartbeat_s=0.1,
                 heartbeat_timeout_s=1.0)
    captured = {}
    spawn = _spawn_when(_landed(2), meta, tmp_path / "meta.json", [0, 1], QUICK)

    def hooks(server, workers):
        captured["workers"] = workers
        spawn(server, workers)

    res = _wire(meta, 3, worker_groups=[{"client_ids": [2], "extra": ["--crash-after", "1"]}],
                hooks=hooks)
    assert res.stats.flushes == 3
    assert captured["workers"][0].returncode == CRASH_EXIT_CODE
    lands = [e for e in res.schedule.events if e.kind == "land"]
    assert [e.client for e in lands].count(2) == 1 and lands[0].client == 2
    assert 2 in res.history[0].participants  # its row made the round it died in
    transitions = [(c, s) for _, c, s in res.liveness_log]
    assert (2, "alive") in transitions and (2, "dead") in transitions, res.liveness_log
    assert (0, "dead") not in transitions and (1, "dead") not in transitions
    _pin_replay(res)


def test_straggler_drops_past_max_staleness_and_recovers():
    # buffer 1: every landing flushes, so the fast client alone advances
    # the version twice while the straggler's first upload waits 3 s; it
    # lands 2 versions stale -> dropped and redispatched, and its
    # retrained update lands fresh and makes the last flush
    meta = _meta(n_clients=2, buffer_size=1, max_staleness=1)
    res = _wire(meta, 3, worker_groups=[
        {"client_ids": [0], "extra": ["--max-updates", "2"]},
        {"client_ids": [1], "extra": ["--fault-plan", "delay@1:update:3.0", "--max-updates", "2"]},
    ])
    assert res.stats.flushes == 3
    assert res.dropped_total == 1 and res.schedule.n_dropped == 1
    drops = [e for e in res.schedule.events if e.kind == "land" and e.dropped]
    assert drops[0].client == 1
    later = [e for e in res.schedule.events if e.kind == "land" and e.client == 1 and not e.dropped]
    assert later and later[-1].flush >= 0
    eng, _ = _pin_replay(res)
    assert eng.history[-1].participants == [1]


def test_reconnect_with_same_id_resumes_contributing(tmp_path):
    # client 0's first process uploads once and leaves; a new process with
    # the same id says HELLO after that landing and makes the second flush
    meta = _meta(n_clients=2, buffer_size=2, max_staleness=0)
    res = _wire(meta, 2, worker_groups=[{"client_ids": [0], "extra": ["--max-updates", "1"]},
                                        {"client_ids": [1], "extra": QUICK}],
                hooks=_spawn_when(_landed(0), meta, tmp_path / "meta.json", [0],
                                  ["--max-updates", "2"]))
    assert res.stats.flushes == 2 and res.stats.reconnects >= 1
    assert len([e for e in res.schedule.events if e.kind == "land" and e.client == 0]) == 2
    assert [e for e in res.schedule.events if e.kind == "dispatch" and e.client == 0]
    _pin_replay(res)


def test_bounded_queue_applies_backpressure():
    # queue_cap 1 and a slow landing loop: four clients' HELLOs (and later
    # their uploads) arrive together, so readers must find the queue full
    meta = _meta(n_clients=4, buffer_size=2, max_staleness=2, queue_cap=1)
    res = _wire(meta, 2, land_delay_s=0.2,
                worker_groups=[{"client_ids": [0, 1, 2, 3], "extra": QUICK}])
    assert res.stats.flushes == 2 and res.stats.backpressure_blocks >= 1
    assert res.stats.queue_high_water <= meta["queue_cap"]
    _pin_replay(res)


# ------------------------------ the acceptance run --------------------------

@pytest.mark.parametrize("wire_codec", ["dense", "quant8", "quant4"])
def test_wire_run_replays_deterministically(wire_codec, tmp_path):
    """C = 4 workers over TCP, 5 flushes, a straggler dropped at the
    staleness gate. The recorded schedule replays through the port's
    engine to the run's global (bitwise dense, 1e-5 otherwise) and, from
    the port's initial state, through the reference's engine (module
    docstring's bounds)."""
    meta = _meta(n_clients=4, buffer_size=2, max_staleness=1, wire_codec=wire_codec,
                 quant_block=512)
    res = _wire(meta, 5, worker_groups=[
        {"client_ids": [0, 1, 2], "extra": ["--max-updates", "3"]},
        {"client_ids": [3], "extra": ["--fault-plan", "delay@1:update:3.0", "--max-updates", "2"]},
    ])
    assert res.stats.flushes == 5 and len(res.history) == 5
    assert res.dropped_total >= 1 and res.schedule.n_dropped == res.dropped_total
    assert res.stats.protocol_errors == 0
    assert len(res.stats.landing_ms) == res.stats.landed + res.dropped_total
    assert {"d2h", "decode", "h2d", "land", "flush"} <= set(res.stats.landing_ms[0])
    path = tmp_path / f"{wire_codec}.schedule.json"
    res.schedule.save(path)
    res.schedule = rp.ArrivalSchedule.load(path)  # the schedule survives its JSON
    eng, step = _pin_replay(res, 0.0 if wire_codec == "dense" else 1e-5)
    for wrec, rrec in zip(res.history, eng.history):
        assert (wrec.participants, wrec.staleness) == (rrec.participants, rrec.staleness)
        np.testing.assert_allclose(wrec.loss, rrec.loss, rtol=1e-5)
    if wire_codec == "quant4":
        return
    # the reference replays the port's record, from the port's initial state
    jeng = jrp.make_engine(meta)
    jeng.import_state(rp.make_engine(meta, device="cpu").export_state())
    jrp.apply_events(jeng, jrp.ArrivalSchedule.load(path).events, meta)
    assert [r.participants for r in jeng.history] == [r.participants for r in res.history]
    assert jeng.dropped_total == res.dropped_total
    want = np.asarray(jeng.global_packed_row(), np.float32)
    off = ~np.isclose(res.global_row, want, rtol=1e-4, atol=1e-6)
    deltas = sum(1 for e in res.schedule.events if e.kind == "land" and not e.dropped)
    assert off.sum() <= (1e-4 * off.size * deltas if wire_codec == "quant8" else 0), int(off.sum())
    np.testing.assert_allclose(res.global_row[off], want[off], rtol=0, atol=step)
    for wrec, jrec in zip(res.history, jeng.history):
        np.testing.assert_allclose(wrec.loss, jrec.loss, rtol=1e-5)
