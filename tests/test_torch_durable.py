"""The port's crash tolerance (``repro_torch.core.transport.{retry,faults}``,
``repro_torch.checkpoint.durable``, the ``WireServer``'s WAL, snapshots and
``kill@M`` recovery) held against the reference, on the host.

Three tiers, cheapest first, as in the reference's ``tests/test_chaos.py``:

- pure units, each also held against the reference's module on the same
  inputs: the ``Backoff`` delays (equal as floats), the ``FaultPlan``
  grammar and the bytes its frame edits put on a socket (equal byte for
  byte), the snapshot file and the WAL line (equal byte for byte, and each
  package reads the other's);
- in-process recovery: ``export_state`` / ``import_state`` mid window with
  ``topk_ef``'s private leaves, and ``DurableRun.recover_engine`` against
  an engine that never crashed (bitwise);
- the real wire, worker processes on the host (``--device cpu``, one
  intra-op thread each): a ``kill@5`` and the restore on the same port
  against a replay of the combined WAL schedule (bitwise under dense, 1e-5
  under quant8, the replay contract), and the storms: corrupted frames,
  a dropped dispatch, a duplicated update, a severed connection, a kill
  without durability, a worker whose server never binds.

Every wire run passes ``deadline_s`` of at most 60 and asserts the
deadline was not hit.
"""
import json
import socket
import time

import numpy as np
import _torch_threads  # noqa: F401 (torch on 2 threads a worker)
import pytest
import torch

import jax.numpy as jnp

from repro.checkpoint import durable as jdr
from repro.core import async_engine as jae
from repro.core.transport import codec as jcodec
from repro.core.transport import faults as jfaults
from repro.core.transport import replay as jrp
from repro.core.transport import retry as jretry
from repro_torch.checkpoint import durable as dr
from repro_torch.core import async_engine as ae
from repro_torch.core import rounds
from repro_torch.core.simclock import SimClock, WallClock
from repro_torch.core.transport import codec, harness, wire
from repro_torch.core.transport import replay as rp
from repro_torch.core.transport.faults import FaultPlan, ServerKilled
from repro_torch.core.transport.retry import Backoff, RetriesExhausted, _fmix32, connect_with_retry

TINY = harness.TINY_OVERRIDES
DEADLINE_S = 60.0
# a recovery rebuilds the engine; the workers must outlast it (at least
# 6 s of backoff)
PATIENT = ["--connect-retries", "16", "--backoff-max", "1.0"]
# the storms reconnect to a live server; a worker whose last upload meets
# the closing server gives up in about 0.35 s, not in PATIENT's 6-12 s
STORM = ["--connect-retries", "4", "--backoff-base", "0.05"]


def _meta(**kw):
    base = dict(overrides=TINY, n_clients=3, buffer_size=2, max_staleness=1, seq=8, batch=2)
    base.update(kw)
    return harness.make_meta(**base)


@pytest.fixture
def one_thread_workers(monkeypatch):
    """Worker processes train with one intra-op thread: six test workers
    each spawning them share the host's cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _wire(meta, n_flushes, **kw):
    res = harness.wire_run(meta, n_flushes, deadline_s=DEADLINE_S, device="cpu", **kw)
    assert not res.stats.deadline_hit, (res.stats, res.worker_stderr)
    return res


def _pin_replay(res, tol=0.0):
    eng = rp.replay(res.schedule, device="cpu")
    got = eng.global_packed_row().numpy()
    if tol == 0.0:
        assert np.array_equal(got.view(np.int32), res.global_row.view(np.int32))
    else:
        np.testing.assert_allclose(got, res.global_row, atol=tol, rtol=0)
    return eng


# ---------------------------------------------------------------------------
# retry.Backoff: the deterministic reconnect schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(base=0.05, cap=2.0, attempts=8, seed=3),
                                dict(base=0.1, cap=0.8, attempts=10, jitter=0.0),
                                dict(base=0.01, cap=0.02, attempts=4, seed=5),
                                dict(base=0.3, cap=7.0, attempts=12, jitter=0.9, seed=2**31 - 1)])
def test_backoff_delays_equal_reference(kw):
    ours, ref = Backoff(**kw), jretry.Backoff(**kw)
    assert ours.delays() == ref.delays()  # equal floats, not close ones
    assert [ours.delay(k) for k in range(40)] == [ref.delay(k) for k in range(40)]
    for x in (0, 1, 0x9E3779B9, 2**32 - 1, 2**40 + 7, 123456789 * 0x9E3779B9):
        assert _fmix32(x) == jretry._fmix32(x)


def test_backoff_schedule_is_deterministic_and_desynchronized():
    a = Backoff(base=0.05, cap=2.0, attempts=8, seed=3)
    assert a.delays() == Backoff(base=0.05, cap=2.0, attempts=8, seed=3).delays()
    assert len(a.delays()) == 7  # no sleep after the final attempt
    # C workers restarted together must not sleep identical schedules
    schedules = [tuple(Backoff(seed=c).delays()) for c in range(8)]
    assert len(set(schedules)) == len(schedules)


def test_backoff_delays_grow_and_cap():
    d = Backoff(base=0.1, cap=0.8, attempts=10, jitter=0.0).delays()
    assert d[:4] == [0.1, 0.2, 0.4, 0.8]
    assert all(x == 0.8 for x in d[4:])
    # jitter only ever shortens a delay
    jit = Backoff(base=0.1, cap=0.8, attempts=10, jitter=0.5, seed=1).delays()
    assert all(0 < j <= x for j, x in zip(jit, d))


@pytest.mark.parametrize("kw", [dict(base=0.0), dict(base=1.0, cap=0.5), dict(jitter=1.0),
                                dict(attempts=0)])
def test_backoff_validates_arguments(kw):
    for cls in (Backoff, jretry.Backoff):
        with pytest.raises(ValueError):
            cls(**kw)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_connect_retry_exhausts_with_the_exact_schedule():
    bo = Backoff(base=0.01, cap=0.02, attempts=4, seed=5)
    slept = []
    with pytest.raises(RetriesExhausted) as ei:
        connect_with_retry("127.0.0.1", _free_port(), bo, timeout=0.2, sleep=slept.append)
    assert slept == bo.delays() == jretry.Backoff(base=0.01, cap=0.02, attempts=4, seed=5).delays()
    assert isinstance(ei.value.__cause__, OSError)  # the last failure, chained


def test_connect_retry_succeeds_once_the_server_binds():
    port = _free_port()
    listener = socket.socket()
    attempts = []

    def sleep(_):
        attempts.append(1)
        if len(attempts) == 2:
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind(("127.0.0.1", port))
            listener.listen(1)

    try:
        connect_with_retry("127.0.0.1", port, Backoff(base=0.001, attempts=8), sleep=sleep).close()
    finally:
        listener.close()
    assert len(attempts) == 2  # refused twice, connected on the third


# ---------------------------------------------------------------------------
# faults.FaultPlan: grammar, counters, the bytes it puts on a socket
# ---------------------------------------------------------------------------

def test_fault_plan_parses_the_grammar_as_the_reference_does():
    spec = "corrupt@2:update, server.drop@1:dispatch; delay@3:heartbeat:0.5;sever@4096; kill@7"
    plan, ref = FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    kinds = [(op.side, op.kind, op.arg, op.ftype, op.seconds, op.spec) for op in plan.ops]
    assert kinds == [(op.side, op.kind, op.arg, op.ftype, op.seconds, op.spec) for op in ref.ops]
    assert [k[:4] for k in kinds] == [
        ("client", "corrupt", 2, wire.UPDATE),
        ("server", "drop", 1, wire.DISPATCH),
        ("client", "delay", 3, wire.HEARTBEAT),
        ("client", "sever", 4096, None),
        ("server", "kill", 7, None),  # kill is forced server-side
    ]
    assert plan.ops[2].seconds == 0.5 and plan.total_fired == 0


@pytest.mark.parametrize("bad", ["", "  ;  ", "explode@1", "martian.drop@1", "drop", "drop@0",
                                 "delay@1:update"])
def test_fault_plan_rejects_bad_specs(bad):
    for cls in (FaultPlan, jfaults.FaultPlan):
        with pytest.raises(ValueError):
            cls.parse(bad)


def _drain(sock, parser=None, timeout=2.0):
    """Everything ``sock`` receives until EOF -> the raw bytes, and the
    frames ``parser`` parsed from them."""
    sock.settimeout(timeout)
    raw, frames = b"", []
    try:
        while True:
            data = sock.recv(1 << 16)
            if not data:
                break
            raw += data
            if parser is not None:
                frames.extend(parser.feed(data))
    except socket.timeout:
        pass
    return raw, frames


def _stream():
    return [wire.pack_hello(3), wire.pack_heartbeat(3), wire.pack_update(3, 0, 1, 0.5, b"\x07" * 64),
            wire.pack_heartbeat(3), wire.pack_update(3, 1, 2, 0.25, bytes(range(200))),
            wire.pack_dispatch(4, b"\x01" * 40), wire.pack_update(3, 2, 4, 0.125, b"\xff" * 33),
            wire.pack_hello(3), wire.pack_bye()]


@pytest.mark.parametrize("spec,seed,side", [
    ("corrupt@2:update;dup@1:hello;drop@2:heartbeat", 9, "client"),
    ("corrupt@1;corrupt@3:update;dup@2:update", 11, "client"),
    ("server.corrupt@1:dispatch;server.dup@1:bye", 0, "server"),
    ("corrupt@4", 2**20 + 3, "client"),
])
def test_fault_plan_edits_the_frame_stream_as_the_reference_does(spec, seed, side):
    """The same spec and seed turn one frame stream into the same bytes."""
    got = []
    for mod in (FaultPlan, jfaults.FaultPlan):
        plan = mod.parse(spec, seed=seed)
        a, b = socket.socketpair()
        try:
            fa = plan.wrap(a, side=side)
            for frame in _stream():
                fa.sendall(frame)
            a.close()
            got.append((_drain(b)[0], dict(plan.fired)))
        finally:
            b.close()
    assert got[0] == got[1]
    assert got[0][0] != b"".join(_stream())  # the plan really edited the stream


def test_corrupt_fault_is_caught_by_the_crc_not_by_desync():
    plan = FaultPlan.parse("corrupt@1:update", seed=9)
    a, b = socket.socketpair()
    try:
        fa = plan.wrap(a, side="client")
        fa.sendall(wire.pack_update(0, 0, 1, 0.5, b"\x00" * 64))
        fa.sendall(wire.pack_hello(0))  # the stream stays framed after the damage
        a.close()
        parser = wire.FrameParser()
        _, frames = _drain(b, parser)
    finally:
        b.close()
    assert plan.total_fired == 1 and plan.fired == {"corrupt@1:update": 1}
    assert parser.crc_errors == 1
    assert [t for t, _ in frames] == [wire.HELLO] and parser.pending == 0


def test_drop_dup_delay_and_sever_faults():
    plan = FaultPlan.parse("drop@1:heartbeat;dup@1:hello;delay@1:bye:0.2")
    a, b = socket.socketpair()
    try:
        fa = plan.wrap(a, side="client")
        fa.sendall(wire.pack_heartbeat(3))  # swallowed
        fa.sendall(wire.pack_hello(3))  # doubled
        t0 = time.monotonic()
        fa.sendall(wire.pack_bye())  # delayed
        took = time.monotonic() - t0
        a.close()
        _, frames = _drain(b, wire.FrameParser())
    finally:
        b.close()
    assert [t for t, _ in frames] == [wire.HELLO, wire.HELLO, wire.BYE]
    assert took >= 0.2 and plan.total_fired == 3
    sever = FaultPlan.parse("sever@10")
    a, b = socket.socketpair()
    try:
        with pytest.raises(ConnectionResetError):
            sever.wrap(a, side="client").sendall(wire.pack_update(0, 0, 1, 0.0, b"\x00" * 32))
    finally:
        a.close()
        b.close()
    assert sever.total_fired == 1


def test_fault_counters_persist_across_reconnects_and_count_only_their_type():
    plan = FaultPlan.parse("drop@1:update")
    got = []
    for _ in range(2):  # two sessions, one plan
        a, b = socket.socketpair()
        try:
            plan.wrap(a, side="client").sendall(wire.pack_update(0, 0, 1, 0.0, b"\x01"))
            a.close()
            got.append(len(_drain(b, wire.FrameParser())[1]))
        finally:
            b.close()
    assert got == [0, 1] and plan.total_fired == 1
    plan = FaultPlan.parse("drop@2:update")
    a, b = socket.socketpair()
    try:
        fa = plan.wrap(a, side="client")
        for frame in (wire.pack_heartbeat(0), wire.pack_update(0, 0, 1, 0.0, b"\x01"),
                      wire.pack_heartbeat(0), wire.pack_update(0, 1, 1, 0.0, b"\x01"),
                      wire.pack_heartbeat(0)):
            fa.sendall(frame)
        a.close()
        types = [t for t, _ in _drain(b, wire.FrameParser())[1]]
    finally:
        b.close()
    assert types.count(wire.UPDATE) == 1 and types.count(wire.HEARTBEAT) == 3


def test_kill_trigger_fires_once_at_threshold():
    plan = FaultPlan.parse("kill@3")
    assert plan.kill_after_landings() == 3
    plan.maybe_kill(1)
    plan.maybe_kill(2)
    with pytest.raises(ServerKilled):
        plan.maybe_kill(3)
    plan.maybe_kill(99)  # done ops never re-fire: the restored server lives
    assert plan.kill_after_landings() is None and plan.fired == {"kill@3": 1}


# ---------------------------------------------------------------------------
# checkpoint.durable: the snapshot file and the WAL, both packages' bytes
# ---------------------------------------------------------------------------

def _fake_snap(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "arrays": {
            "params": rng.normal(size=(3, 17)).astype(np.float32),
            "agg_0": rng.normal(size=17).astype(np.float32),
            "counter": np.asarray([5], np.uint32),
            "dispatch_version": np.asarray([0, 3, 2], np.int64),
        },
        "scalars": {"round": 4, "version": 4, "losses": [0.5, 0.25], "staged": [1]},
    }


def _same_snap(a, b):
    assert a["scalars"] == b["scalars"] and set(a["arrays"]) == set(b["arrays"])
    for k, v in a["arrays"].items():
        w = b["arrays"][k]
        assert (v.dtype, v.shape, v.tobytes()) == (w.dtype, w.shape, w.tobytes()), k


def test_snapshot_file_is_the_reference_format(tmp_path):
    snap = _fake_snap()
    n = dr.write_snapshot(tmp_path / "ours.ckpt", snap)
    jdr.write_snapshot(tmp_path / "ref.ckpt", snap)
    assert n == (tmp_path / "ours.ckpt").stat().st_size
    blob = (tmp_path / "ours.ckpt").read_bytes()
    assert blob == (tmp_path / "ref.ckpt").read_bytes() and blob[:8] == b"FVSNAP01"
    _same_snap(dr.read_snapshot(tmp_path / "ref.ckpt"), snap)
    _same_snap(jdr.read_snapshot(tmp_path / "ours.ckpt"), snap)


def test_snapshot_crc_rejects_every_kind_of_damage(tmp_path):
    p = tmp_path / "s.ckpt"
    dr.write_snapshot(p, _fake_snap())
    blob = p.read_bytes()
    bad = bytearray(blob)
    bad[len(blob) // 2] ^= 0xFF
    for damaged in (bytes(bad), blob[:-7], b"NOTASNAP" + blob[8:]):
        p.write_bytes(damaged)
        with pytest.raises(ValueError):
            dr.read_snapshot(p)


def test_atomic_write_leaves_no_tmp_file(tmp_path):
    dr.atomic_write_bytes(tmp_path / "x.bin", b"payload")
    assert (tmp_path / "x.bin").read_bytes() == b"payload"
    assert list(tmp_path.glob("*.tmp")) == []


def _events(n, start=0, mod=rp):
    return [mod.WireEvent("dispatch", float(i), i % 3, i) for i in range(start, n)]


def test_wal_line_is_the_reference_line():
    evs = _events(3) + [rp.WireEvent("land", 2.75, 1, 3, seq=7, dropped=True, flush=-1),
                        rp.WireEvent("land", 1e-9, 0, 2, seq=0, flush=12)]
    for i, ev in enumerate(evs):
        line = dr._wal_line(i, ev)
        jev = jrp.WireEvent(**{k: getattr(ev, k) for k in ev.__dataclass_fields__})
        assert line == jdr._wal_line(i, jev)
        assert dr._parse_wal_line(line) == (i, ev)
        assert jdr._parse_wal_line(line) == (i, jev)
    assert dr._parse_wal_line("0" * 8 + " {}\n") is None  # a CRC that does not match


class _Eng:  # snapshot() only needs export_state()
    def export_state(self):
        return _fake_snap()


def test_wal_torn_tail_is_discarded_not_fatal(tmp_path):
    run = dr.DurableRun(tmp_path, {"n": 1})
    for ev in _events(5):
        run.append_event(ev)
    run.close()
    wal = next(tmp_path.glob("wal_*.jsonl"))
    text = wal.read_text()
    wal.write_text(text[: len(text) - 9])  # the crash tore the last line
    assert [e.version for e in dr.DurableRun(tmp_path).events()] == [0, 1, 2, 3]
    lines = text.splitlines(keepends=True)
    lines[2] = lines[2].replace(lines[2][0], "f" if lines[2][0] != "f" else "0", 1)
    wal.write_text("".join(lines))  # a flipped line mid-file ends its segment
    assert len(dr.DurableRun(tmp_path).events()) == 2


def test_wal_segments_concatenate_and_a_gap_is_an_error(tmp_path):
    run = dr.DurableRun(tmp_path, {"n": 1})
    evs = _events(7)
    for i, ev in enumerate(evs):
        run.append_event(ev)
        if i in (2, 4):
            run.snapshot(_Eng())  # rotates the WAL segment
    run.close()
    assert len(list(tmp_path.glob("wal_*.jsonl"))) == 3
    assert len(list(tmp_path.glob("snap_*.ckpt"))) == 2
    assert dr.DurableRun(tmp_path).events() == evs
    # the reference reads the port's directory event for event
    assert [(e.kind, e.t, e.client, e.version) for e in jdr.DurableRun(tmp_path).events()] == [
        (e.kind, e.t, e.client, e.version) for e in evs]
    sorted(tmp_path.glob("wal_*.jsonl"))[0].unlink()  # lose the first segment
    with pytest.raises(ValueError, match="WAL gap"):
        dr.DurableRun(tmp_path).events()


def test_durable_reopen_resumes_the_event_counter(tmp_path):
    run = dr.DurableRun(tmp_path, {"n": 1})
    for ev in _events(3):
        run.append_event(ev)
    run.close()
    run2 = dr.DurableRun(tmp_path)  # a restarted server reopens the directory
    assert run2.n_events == 3
    run2.append_event(rp.WireEvent("dispatch", 9.0, 0, 3))
    run2.close()
    assert len(dr.DurableRun(tmp_path).events()) == 4 and dr.DurableRun(tmp_path).meta == {"n": 1}
    with pytest.raises(FileNotFoundError):
        dr.DurableRun(tmp_path / "fresh")


# ---------------------------------------------------------------------------
# in-process recovery: export/import and recover_engine against a run that
# never crashed
# ---------------------------------------------------------------------------

def _drive(meta, n_lands, *, pkg="torch", durable=None, snapshot_at=()):
    """The landing loop in miniature: round-robin dispatch/land over a
    fresh engine of ``pkg``, recording (and optionally journaling) every
    event -> (engine, events)."""
    if pkg == "torch":
        mod, cod, eng = rp, codec, rp.make_engine(meta, clock=SimClock(), device="cpu")
        upd = ae.build_row_update(mod.build_cfg(meta), mod.build_fed(meta), mod.build_optimizer(meta))
        cfg = mod.build_cfg(meta)
        train = lambda base, b: upd(torch.from_numpy(base), rounds.to_device(b, "cpu"))
    else:
        mod, cod, eng = jrp, jcodec, jrp.make_engine(meta, clock=jrp.SimClock())
        upd = jae.build_row_update(mod.build_cfg(meta), mod.build_fed(meta), mod.build_optimizer(meta))
        cfg = mod.build_cfg(meta)
        train = lambda base, b: upd(jnp.asarray(base), b)
    wc, block = meta["wire_codec"], int(meta["quant_block"])
    C = int(meta["n_clients"])
    events, seqs, staged, t = [], [0] * C, set(), 0.0

    def record(ev):
        events.append(ev)
        if durable is not None:
            durable.append_event(ev)

    for c in range(C):
        t += 1.0
        eng.clock.advance_to(t)
        record(mod.WireEvent("dispatch", t, c, eng.dispatch(c)))
    lands, ci = 0, 0
    while lands < n_lands:
        c = ci % C
        ci += 1
        if c in staged:
            continue  # a staged row waits for its flush redispatch
        t += 1.0
        ver, base = int(eng.dispatch_version[c]), np.asarray(eng.dispatch_row(c), np.float32)
        trained, loss = train(base, mod.synth_client_batch(cfg, meta, c, seqs[c]))
        landed = cod.decode_update(cod.encode_update(np.asarray(trained, np.float32), base, wc,
                                                     block), base)
        res = eng.land(c, landed, loss=float(loss), t=t)
        record(mod.WireEvent("land", t, c, ver, seq=seqs[c], dropped=res.dropped,
                             flush=-1 if res.flush is None else res.flush.round_idx))
        seqs[c] += 1
        lands += 1
        if res.flush is not None:
            staged.clear()
        elif not res.dropped:
            staged.add(c)
        if durable is not None and lands in snapshot_at:
            durable.snapshot(eng)
    return eng, events


def _assert_engines_identical(a, b):
    """Bitwise equality of everything ``export_state`` covers, either
    package's engine; ``n_history`` is informational (round records are
    re-earned by the WAL suffix, not snapshotted)."""
    sa, sb = a.export_state(), b.export_state()
    assert set(sa["arrays"]) == set(sb["arrays"])
    for k in sa["arrays"]:
        x, y = np.asarray(sa["arrays"][k]), np.asarray(sb["arrays"][k])
        assert (x.dtype, x.shape, x.tobytes()) == (y.dtype, y.shape, y.tobytes()), k
    drop = lambda s: {k: v for k, v in s.items() if k != "n_history"}
    assert drop(sa["scalars"]) == drop(sb["scalars"])


def test_export_import_round_trips_mid_window_with_topk_ef():
    # topk_ef keeps aggregator-private leaves (error-feedback residual rows,
    # round counters) that a params-only checkpoint would lose; 5 landings
    # at buffer 2 leave the window half full
    meta = _meta(aggregation="topk_ef")
    eng, _ = _drive(meta, 5)
    assert eng.staged()
    fresh = rp.make_engine(meta, clock=SimClock(), device="cpu")
    fresh.import_state(eng.export_state())
    _assert_engines_identical(eng, fresh)
    assert (fresh.version, fresh.dropped_total) == (eng.version, eng.dropped_total)


@pytest.mark.parametrize("aggregation,n_lands,snapshot_at", [
    ("topk_ef", 6, (3,)),  # a snapshot, then the WAL suffix
    ("dense", 4, ()),  # no snapshot: the WAL alone
])
def test_recover_engine_equals_uninterrupted_run(tmp_path, aggregation, n_lands, snapshot_at):
    meta = _meta(aggregation=aggregation)
    run = dr.DurableRun(tmp_path, meta)
    ref, events = _drive(meta, n_lands, durable=run, snapshot_at=snapshot_at)
    run.close()
    rec, n_replayed = dr.DurableRun(tmp_path).recover_engine(clock=SimClock(), device="cpu")
    if snapshot_at:
        assert 0 < n_replayed < len(events)  # the snapshot really cut the replay
        got = [(r.round_idx, r.loss) for r in rec.history]
        assert got and got == [(r.round_idx, r.loss) for r in ref.history][-len(got):]
    else:
        assert n_replayed == len(events)
    _assert_engines_identical(ref, rec)


def test_recover_engine_falls_back_past_a_corrupt_snapshot(tmp_path):
    meta = _meta()
    run = dr.DurableRun(tmp_path, meta)
    ref, _ = _drive(meta, 6, durable=run, snapshot_at=(2, 4))
    run.close()
    newest = sorted(tmp_path.glob("snap_*.ckpt"))[-1]
    blob = bytearray(newest.read_bytes())
    blob[-3] ^= 0x55
    newest.write_bytes(bytes(blob))
    run2 = dr.DurableRun(tmp_path)
    at, _ = run2.latest_snapshot()
    assert f"snap_{at:08d}.ckpt" != newest.name  # fell back to the older one
    _assert_engines_identical(ref, run2.recover_engine(clock=SimClock(), device="cpu")[0])


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_durable_directory_is_recovered_by_the_other_package(tmp_path, writer):
    """A directory one package wrote (its WAL, and a snapshot after the last
    event) is recovered by the other's ``DurableRun``: the same events, and
    every snapshotted array bitwise."""
    meta = _meta(aggregation="topk_ef")
    mod_w, mod_r = (dr, jdr) if writer == "torch" else (jdr, dr)
    run = mod_w.DurableRun(tmp_path, meta)
    eng, events = _drive(meta, 5, pkg=writer, durable=run, snapshot_at=(5,))
    run.close()
    reader = mod_r.DurableRun(tmp_path)
    got = reader.events()
    assert [(e.kind, e.t, e.client, e.version, e.seq, e.dropped, e.flush) for e in got] == [
        (e.kind, e.t, e.client, e.version, e.seq, e.dropped, e.flush) for e in events]
    if writer == "torch":
        rec, n = reader.recover_engine(clock=jrp.SimClock())
    else:
        rec, n = reader.recover_engine(clock=SimClock(), device="cpu")
    assert n == 0 and rec.staged() == eng.staged() and rec.version == eng.version
    _assert_engines_identical(eng, rec)


def test_wall_clock_start_offset_continues_the_timeline():
    clk = WallClock(start=123.5)
    assert clk.now() == 123.5
    time.sleep(0.01)
    assert clk.sync() > 123.5 and clk.peek() >= clk.now()


# ---------------------------------------------------------------------------
# the real wire: kill and restore, the storms, the counters that prove them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire_codec,tol", [("dense", 0.0), ("quant8", 1e-5)])
def test_wire_kill_and_restore_pins_the_combined_replay(tmp_path, one_thread_workers,
                                                        wire_codec, tol):
    """Kill the server after 5 landings (no BYE, sockets slammed, the WAL as
    the last append left it), restore from snapshot + WAL on the same port
    while the workers ride their backoff, finish: the combined schedule
    replays to the same global (bitwise dense, 1e-5 quant8)."""
    meta = _meta(n_clients=4, buffer_size=2, max_staleness=2, wire_codec=wire_codec)
    res = _wire(meta, 5, worker_groups=[{"client_ids": [0, 1, 2, 3], "extra": PATIENT}],
                durable_root=tmp_path / "run", snapshot_every=2, fault_plan="kill@5")
    assert res.recovered and res.stats.crashed and res.stats.recoveries == 1
    assert res.stats.flushes == 5 and res.schedule.n_flushes == 5
    assert res.stats.faults_injected == 1  # the kill itself, counted
    assert res.stats.snapshots >= 1 and res.stats.wal_events > 0
    assert res.pre_crash_stats is not None and res.pre_crash_stats.landed == 5
    assert res.recovery_s > 0 and res.events_replayed > 0  # snapshot at 4, killed at 5
    assert all(s["bytes"] > 0 for s in res.stats.snapshot_ms)
    assert len(res.stats.snapshot_ms) == res.stats.snapshots
    assert [r.round_idx for r in res.history] == list(range(5))  # the spliced history
    _pin_replay(res, tol)


def test_wire_corrupt_frame_storm_is_counted_and_survived(one_thread_workers):
    # two corrupted uploads: the CRC firewall withholds each, drops the
    # connection, and the worker reconnects and retrains
    res = _wire(_meta(n_clients=2, buffer_size=2, max_staleness=2), 3,
                worker_groups=[{"client_ids": [0, 1], "extra": STORM}],
                fault_plan="corrupt@2:update;corrupt@4:update", fault_seed=11)
    assert res.stats.flushes == 3 and res.stats.crc_errors == 2 and res.stats.reconnects >= 1
    _pin_replay(res)


def test_wire_dropped_dispatch_covered_by_dispatch_timeout(one_thread_workers):
    # one client: when its post-flush dispatch evaporates, it must hit
    # --dispatch-timeout, reconnect, and be redispatched through its HELLO
    res = _wire(_meta(n_clients=1, buffer_size=1, max_staleness=2), 3,
                worker_groups=[{"client_ids": [0], "extra": STORM + ["--dispatch-timeout", "2.0"]}],
                fault_plan="server.drop@2:dispatch")
    assert res.stats.flushes == 3 and res.stats.faults_injected == 1
    assert res.stats.reconnects >= 1
    _pin_replay(res)


def test_wire_duplicated_update_dies_at_the_version_echo_gate(one_thread_workers):
    # the first upload goes twice: the copy echoes a version the engine has
    # moved past and is refused as superseded, never landed twice
    res = _wire(_meta(n_clients=2, buffer_size=1, max_staleness=2), 3,
                worker_groups=[{"client_ids": [0, 1], "extra": STORM}], fault_plan="dup@1:update")
    assert res.stats.flushes == 3 and res.stats.superseded >= 1
    seqs = [(e.client, e.seq) for e in res.schedule.events if e.kind == "land"]
    assert len(seqs) == len(set(seqs))
    _pin_replay(res)


def test_wire_severed_connection_reconnects_and_completes(one_thread_workers):
    # the tiny dispatch row is about 30 KB; the cut falls in the first update
    res = _wire(_meta(n_clients=2, buffer_size=2, max_staleness=2), 3,
                worker_groups=[{"client_ids": [0, 1], "extra": STORM}], fault_plan="sever@9000")
    assert res.stats.flushes == 3 and res.stats.reconnects >= 1
    _pin_replay(res)


def test_wire_kill_without_durable_raises_not_hangs(one_thread_workers):
    with pytest.raises(ServerKilled):
        harness.wire_run(_meta(n_clients=2, buffer_size=1), 4, deadline_s=DEADLINE_S, device="cpu",
                         worker_groups=[{"client_ids": [0, 1], "extra": [
                             "--connect-retries", "2", "--backoff-base", "0.05"]}],
                         fault_plan="kill@2")


def test_worker_process_exits_cleanly_when_server_never_binds(tmp_path, one_thread_workers):
    meta_path = tmp_path / "meta.json"
    meta_path.write_text(json.dumps(_meta(n_clients=1)))
    p = harness.spawn_worker(str(meta_path), "127.0.0.1", _free_port(), [0],
                             ["--connect-retries", "3", "--backoff-base", "0.01"], device="cpu")
    _, err = p.communicate(timeout=60)
    assert p.returncode == 0, err.decode()
