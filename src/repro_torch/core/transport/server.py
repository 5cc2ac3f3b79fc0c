"""The server side of the wire transport (port of
``repro/core/transport/server.py``; DESIGN.md §14).

`WireServer` owns the listening socket, one reader thread per client
connection, and THE landing loop — the single thread allowed to touch the
`ArrivalAsyncEngine`. Readers only parse frames and enqueue work:

    reader threads --(bounded landing queue)--> landing loop --> engine

The landing queue is bounded (``FedConfig.queue_cap``, default 2C): when
the loop falls behind, `queue.put` blocks the reader, the reader stops
draining its socket, the kernel's TCP window closes, and the *worker's*
send blocks — real end-to-end backpressure, counted in
``backpressure_blocks`` rather than buffered unboundedly.

Liveness is a two-state machine per client driven entirely by frame
arrival times: ALIVE -> DEAD after ``heartbeat_timeout_s`` of silence
(heartbeats ride their own frame type and never touch the engine), DEAD ->
ALIVE on any frame. Transitions land in ``liveness_log``. A dead client's
in-flight dispatch simply never returns; when it reconnects (a fresh HELLO
is the reconnect path) the landing loop redispatches the current global —
unless the client is staged in the pending flush, in which case the
dispatch is deferred to the flush boundary so the landed update is never
overwritten.

Every landing-loop action is recorded into an `ArrivalSchedule`
(`core/transport/replay.py`), timestamped off the engine's `WallClock` —
the record a SimClock replay must reproduce bit-for-bit (dense codec).

The engine's rows live on its device (the card by default). Only the
landing loop touches them, and a row crosses the bus once a hop, through
one pinned host buffer the loop reuses: a dispatch copies the row into it
and writes the frame straight from it (``wire.send_frame``); a dense
landing copies the payload into it and from there to the device; a quant8
landing sends its int8 blocks and scales the same way and adds their
dequantized delta to the base row on the device (the f32 multiply and add
of ``codec.decode_update``, so the row is the host decode's bit for bit),
never reading the base off the card. Other codecs decode on the host
against a copy of the base. ``WireRunStats.landing_ms``, ``dispatch_ms``
and ``snapshot_ms`` time those steps per landing, per dispatch and per
snapshot.
"""
from __future__ import annotations

import dataclasses
import queue
import socket
import threading
import time

import numpy as np
import torch

from repro_torch.core.simclock import WallClock
from repro_torch.core.transport import codec, wire
from repro_torch.core.transport.faults import ServerKilled
from repro_torch.core.transport.replay import ArrivalSchedule, WireEvent

ALIVE, DEAD = "alive", "dead"


@dataclasses.dataclass
class WireRunStats:
    """Operational counters the monitor renders next to the round history."""

    flushes: int = 0
    landed: int = 0
    dropped: int = 0
    heartbeats: int = 0
    reconnects: int = 0
    bytes_up: int = 0  # client -> server, payload+framing
    bytes_down: int = 0  # server -> client
    backpressure_blocks: int = 0  # reader puts that found the queue full
    queue_high_water: int = 0
    protocol_errors: int = 0  # frames the engine refused (double updates)
    superseded: int = 0  # updates whose echoed dispatch version was stale
    deadline_hit: bool = False
    crc_errors: int = 0  # frames the CRC firewall withheld (DESIGN.md §16)
    snapshots: int = 0  # durable full-engine snapshots written
    wal_events: int = 0  # events appended to the landing WAL
    recoveries: int = 0  # 1 on a server recovered from snapshot+WAL
    faults_injected: int = 0  # server-side FaultPlan ops that fired
    crashed: bool = False  # the fault plan killed this landing loop
    # host ms of each landing's steps: "d2h" (the base row off the device),
    # "decode", "h2d" (the decoded row onto it), "land" (the engine's land,
    # which runs the flush when "flush" is set), synchronised on the device
    landing_ms: list = dataclasses.field(default_factory=list)
    # host ms of each dispatch: "d2h" (the row off the device), "encode", "send"
    dispatch_ms: list = dataclasses.field(default_factory=list)
    # each durable snapshot: its "bytes" and host "ms" (the landing loop waits)
    snapshot_ms: list = dataclasses.field(default_factory=list)


class WireServer:
    """Socket front-end for one `ArrivalAsyncEngine`.

    The engine must have been built on a `simclock.WallClock` (the harness
    does this); `serve(n_flushes)` runs the landing loop until that many
    flushes land or the deadline passes.
    """

    def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 0,
                 record: bool = True, land_delay_s: float = 0.0,
                 durable=None, snapshot_every: int = 0, faults=None,
                 recovered: bool = False):
        fed = engine.fed
        if fed.transport != "socket":
            raise ValueError(
                f"WireServer needs FedConfig(transport='socket'), got {fed.transport!r}"
            )
        if not isinstance(engine.clock, WallClock):
            raise ValueError(
                "WireServer runs in real time: build the engine on a "
                "simclock.WallClock (replay is where a plain SimClock belongs)"
            )
        self.engine = engine
        self.fed = fed
        self.codec = fed.wire_codec
        if self.codec not in codec.CODECS:
            raise ValueError(f"unknown wire_codec {self.codec!r}")
        self.block = fed.quant_block
        self.queue_cap = fed.queue_cap or 2 * fed.n_clients
        self.land_delay_s = land_delay_s  # test hook: a deliberately slow landing loop
        self._q: queue.Queue = queue.Queue(self.queue_cap)
        self.stats = WireRunStats()
        # durability (DESIGN.md §16): every recorded event also lands in
        # the DurableRun's WAL; snapshot_every takes a full-engine snapshot
        # each N landings (0 = WAL only, recovery replays from the seed)
        self.durable = durable
        self.snapshot_every = snapshot_every
        self.faults = faults  # server-side FaultPlan (kill@M, corrupt dispatches)
        self._landings_since_snap = 0
        if recovered:
            self.stats.recoveries = 1
        self.schedule = ArrivalSchedule(meta={}) if record else None
        self._lock = threading.Lock()  # conns / last_seen / stats counters
        self._conns: dict[int, socket.socket] = {}
        self._send_locks: dict[int, threading.Lock] = {}
        self._last_seen: dict[int, float] = {}
        self.liveness: dict[int, str] = {}
        self.liveness_log: list[tuple[float, int, str]] = []
        self._deferred: set[int] = set()  # HELLOs from staged clients, dispatch at flush
        self._pinned: torch.Tensor | None = None  # the landing loop's staging bytes
        self._stopping = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(fed.n_clients + 4)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "WireServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="wire-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        with self._lock:
            conns = dict(self._conns)
        for c, sock in conns.items():
            try:
                self._send(c, wire.pack_bye())
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self.durable is not None:
            self.durable.close()  # graceful stop: flush + fsync the WAL tail

    # -- reader side (per-connection threads; never touch the engine) --------

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.faults is not None:
                sock = self.faults.wrap(sock, side="server")
            threading.Thread(
                target=self._reader, args=(sock,), name="wire-reader", daemon=True
            ).start()

    def _put(self, item) -> None:
        try:
            self._q.put_nowait(item)
        except queue.Full:
            with self._lock:
                self.stats.backpressure_blocks += 1
            self._q.put(item)  # blocks this reader: backpressure to the socket
        with self._lock:
            self.stats.queue_high_water = max(self.stats.queue_high_water, self._q.qsize())

    def _reader(self, sock: socket.socket) -> None:
        parser = wire.FrameParser()
        client: int | None = None
        clock = self.engine.clock  # a killed server gives its engine up
        chunk = bytearray(wire.RECV_CHUNK)
        while not self._stopping.is_set():
            try:
                n = sock.recv_into(chunk)
            except OSError:
                break
            if not n:
                break
            # peek, never sync: only the landing loop advances the engine clock
            t = clock.peek()
            with self._lock:
                self.stats.bytes_up += n
            try:
                frames = parser.feed(memoryview(chunk)[:n])
            except ValueError:
                break  # corrupt stream: drop the connection, liveness handles it
            if parser.crc_errors:
                # the CRC firewall caught line damage (DESIGN.md §16): count
                # it and drop the connection — a stream that corrupted one
                # byte can't be trusted to have framed the next honestly.
                # The worker's reconnect path (HELLO -> redispatch) recovers.
                with self._lock:
                    self.stats.crc_errors += parser.crc_errors
                break
            for ftype, payload in frames:
                if ftype == wire.HELLO:
                    client = wire.parse_hello(payload)
                    if not 0 <= client < self.fed.n_clients:
                        sock.close()
                        return
                    with self._lock:
                        known = client in self._conns
                        self._conns[client] = sock
                        self._send_locks.setdefault(client, threading.Lock())
                        self._last_seen[client] = t
                        if known:
                            self.stats.reconnects += 1
                    self._put(("hello", client, None))
                elif ftype == wire.UPDATE:
                    c, seq, version, loss, buf = wire.parse_update(memoryview(payload))
                    with self._lock:
                        self._last_seen[c] = t
                    self._put(("update", c, (seq, version, loss, buf)))
                elif ftype == wire.HEARTBEAT:
                    c = wire.parse_heartbeat(payload)
                    with self._lock:
                        self._last_seen[c] = t
                        self.stats.heartbeats += 1
                # BYE from a client is just a close; the recv() EOF handles it
        # drop the connection, do not just stop reading it: a worker whose
        # stream was poisoned then reconnects at once, not after its
        # dispatch timeout (the reference leaves the socket open)
        try:
            sock.close()
        except OSError:
            pass

    # -- landing loop (the only engine owner) ---------------------------------

    def _send(self, c: int, frame) -> None:
        """One frame, whole or as ``wire.frame_parts``, to client ``c``."""
        with self._lock:
            sock = self._conns.get(c)
            slock = self._send_locks.get(c)
        if sock is None or slock is None:
            return
        try:
            with slock:
                wire.send_frame(sock, frame)
            with self._lock:
                self.stats.bytes_down += wire.frame_nbytes(frame)
        except OSError:
            pass  # client gone mid-send; liveness will flag it

    def _sync(self) -> float:
        """Wait for the engine's device; -> host ms now."""
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)
        return time.perf_counter() * 1e3

    def _stage(self, dtype, shape: tuple) -> torch.Tensor:
        """A tensor of ``dtype`` (a NumPy dtype) and ``shape`` over the loop's
        pinned staging bytes, grown to fit and reused by every landing and
        dispatch: the loop is one thread and sends synchronously."""
        dtype = np.dtype(dtype).newbyteorder("=")
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if self._pinned is None or self._pinned.numel() < nbytes:
            self._pinned = None
            self._pinned = torch.empty(nbytes, dtype=torch.uint8,
                                       pin_memory=self.engine.device.type == "cuda")
        like = torch.from_numpy(np.empty(0, dtype)).dtype
        return self._pinned[:nbytes].view(like).view(shape)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` copied once into the staging bytes, then to the engine's
        device (on the host the staged tensor itself)."""
        staged = self._stage(arr.dtype, arr.shape)
        np.copyto(staged.numpy(), arr)
        return staged.to(self.engine.device)

    def _decode_landing(self, c: int, buf) -> tuple[torch.Tensor, float, float]:
        """An UPDATE payload -> (the trained row on the engine's device, host
        ms after reading the base, host ms after the host decode)."""
        tag = buf[0] if len(buf) else -1
        if tag == codec.DENSE:
            t1 = time.perf_counter() * 1e3
            view = codec.row_view(buf)
            return self._to_device(view), t1, time.perf_counter() * 1e3
        if tag == codec.QUANT8:
            t1 = time.perf_counter() * 1e3
            n, _, scale, q = codec.quant8_views(memoryview(buf)[1:])
            t2 = time.perf_counter() * 1e3
            dev = self.engine.device
            delta = torch.from_numpy(scale).to(dev)[:, None] * self._to_device(q).float()
            return self.engine.state["params"][c].float() + delta.reshape(-1)[:n], t1, t2
        base = self.engine.state["params"][c].to("cpu", torch.float32).numpy()
        t1 = time.perf_counter() * 1e3
        row = codec.decode_update(buf, base)
        return torch.from_numpy(row).to(self.engine.device), t1, time.perf_counter() * 1e3

    def _send_dispatch(self, c: int) -> None:
        t0 = self._sync()
        src = self.engine.state["params"][c]
        row = self._stage(np.float32, (src.numel(),))
        row.copy_(src)  # the dispatch's one device-to-host copy
        t1 = self._sync()
        frame = wire.dispatch_parts(
            int(self.engine.dispatch_version[c]), *codec.row_parts(row.numpy(), self.codec)
        )
        t2 = time.perf_counter() * 1e3
        self._send(c, frame)
        self.stats.dispatch_ms.append(
            {"d2h": t1 - t0, "encode": t2 - t1, "send": time.perf_counter() * 1e3 - t2})

    def _record(self, ev: WireEvent) -> None:
        if self.schedule is not None:
            self.schedule.events.append(ev)
        if self.durable is not None:
            self.durable.append_event(ev)
            self.stats.wal_events += 1

    def _check_liveness(self, t: float) -> None:
        timeout = self.fed.heartbeat_timeout_s
        with self._lock:
            seen = dict(self._last_seen)
        for c, last in seen.items():
            state = self.liveness.get(c)
            if t - last > timeout and state == ALIVE:
                self.liveness[c] = DEAD
                self.liveness_log.append((t, c, DEAD))
            elif t - last <= timeout and state != ALIVE:
                self.liveness[c] = ALIVE
                self.liveness_log.append((t, c, ALIVE))

    def _dispatch_now(self, c: int, t: float) -> None:
        v = self.engine.dispatch(c)
        self._record(WireEvent(kind="dispatch", t=t, client=c, version=v))
        self._send_dispatch(c)

    def serve(self, n_flushes: int, *, deadline_s: float = 120.0) -> WireRunStats:
        """Run the landing loop until `n_flushes` flushes land. Returns the
        stats; `engine.history` has the round records and `self.schedule`
        the replayable arrival record. A hung federation (every client dead,
        nothing arriving) exits at the deadline with ``deadline_hit`` set
        instead of stalling the caller — CI's hung-socket guard depends on
        this never blocking forever."""
        deadline = time.monotonic() + deadline_s
        while self.stats.flushes < n_flushes:
            if time.monotonic() > deadline:
                self.stats.deadline_hit = True
                break
            t = self.engine.clock.sync()
            self._check_liveness(t)
            try:
                kind, c, args = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if self.land_delay_s:
                time.sleep(self.land_delay_s)
            t = self.engine.clock.sync()
            if kind == "hello":
                if c in self.engine.staged():
                    self._deferred.add(c)  # redispatch at the flush boundary
                else:
                    self._dispatch_now(c, t)
            elif kind == "update":
                seq, trained_against, loss, buf = args
                if trained_against != int(self.engine.dispatch_version[c]):
                    # the echoed dispatch was superseded (a flush or a
                    # reconnect redispatched this client while the update
                    # was in flight): the row it trained on is not the row
                    # the engine holds, so landing it would silently
                    # diverge from the replay. Refuse it; the newer
                    # dispatch's update is already on its way.
                    self.stats.superseded += 1
                    continue
                t0 = self._sync()
                try:
                    row, t1, t2 = self._decode_landing(c, buf)
                except ValueError:
                    continue  # corrupt payload: skip; the client will retrain on redispatch
                t3 = self._sync()
                try:
                    res = self.engine.land(c, row, loss=loss, t=t)
                except RuntimeError:
                    # protocol violation (double update for one dispatch) —
                    # never let a misbehaving client kill the landing loop
                    self.stats.protocol_errors += 1
                    continue
                self.stats.landing_ms.append(
                    {"d2h": t1 - t0, "decode": t2 - t1, "h2d": t3 - t2,
                     "land": self._sync() - t3, "flush": res.flush is not None})
                self.stats.landed += 0 if res.dropped else 1
                self.stats.dropped += 1 if res.dropped else 0
                self._record(
                    WireEvent(
                        kind="land", t=t, client=c, version=trained_against, seq=seq,
                        dropped=res.dropped,
                        flush=-1 if res.flush is None else res.flush.round_idx,
                    )
                )
                if res.dropped:
                    # land() already redispatched the row+version; ship it
                    self._send_dispatch(c)
                elif res.flush is not None:
                    self.stats.flushes += 1
                    for sc in res.flush.participants:
                        self._send_dispatch(sc)  # staged rows already hold the global
                    # deferred reconnects were staged, hence participants:
                    # the flush dispatch above covered them
                    self._deferred.clear()
                if not res.dropped:
                    self._landings_since_snap += 1
                    if (self.durable is not None and self.snapshot_every
                            and self._landings_since_snap >= self.snapshot_every):
                        t0 = time.perf_counter() * 1e3
                        n = self.durable.snapshot(self.engine)
                        self.stats.snapshot_ms.append(
                            {"bytes": n, "ms": time.perf_counter() * 1e3 - t0})
                        self.stats.snapshots += 1
                        self._landings_since_snap = 0
                    if self.faults is not None:
                        try:
                            self.faults.maybe_kill(self.stats.landed)
                        except ServerKilled:
                            # the kill -9 model: mark, slam every socket
                            # shut (no BYE), leave the WAL exactly as the
                            # last append left it, and propagate — the
                            # harness's recovery path takes over from disk
                            self.stats.crashed = True
                            self.stats.faults_injected = self.faults.total_fired
                            self.kill()
                            raise
        if self.faults is not None:
            self.stats.faults_injected = self.faults.total_fired
        return self.stats

    def kill(self) -> None:
        """Abrupt shutdown — the in-process stand-in for ``kill -9``: no
        BYE frames, no WAL close, sockets slammed. Workers see a bare EOF/
        reset and enter their reconnect-with-backoff loop."""
        self._stopping.set()
        with self._lock:
            conns = dict(self._conns)
        for sock in conns.values():
            try:
                sock.close()
            except OSError:
                pass
        # pop a blocked accept() before closing: on Linux the in-flight
        # accept call keeps the listening socket — and its port — alive
        # past close(), so without this the recovery path's rebind of the
        # same port races against the next worker reconnect
        try:
            socket.create_connection((self.host, self.port), timeout=0.2).close()
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
