"""A federated client worker process (port of ``repro/launch/worker.py``;
DESIGN.md §14, resilience §16).

``python -m repro_torch.launch.worker --host H --port P --meta meta.json
--client-ids 0,1 [--device cuda]`` connects each client id to a
`WireServer` over TCP and runs the dispatch/train/upload loop:

    HELLO(c) -> [DISPATCH(version, row) -> train -> UPDATE(c, seq, version, loss)]* -> BYE

The UPDATE echoes the DISPATCH version it trained against: a reconnect can
leave two processes holding dispatches for one client id, and the server
uses the echo to refuse an update trained on a row its engine has already
moved past (superseded dispatch).

Training goes through `async_engine.build_row_update` — the SAME
single-row update the SimClock replay uses — on ``--device`` (the card by
default, never a fallback to the host), on batches derived from (seed,
client, seq) via `transport.replay.synth_client_batch`. Nothing about the
data crosses the wire; ``seq`` (the client-local update counter) rides the
UPDATE frame so the replayer indexes the same batch. One process can host
several clients as threads sharing the one row update; each thread trains
its own copy of its dispatch row. Fault-scenario clients run alone so
crashing or delaying them is isolated.

Resilience (DESIGN.md §16): every connect goes through
`transport.retry.connect_with_retry` — exponential backoff with
deterministic per-client jitter, bounded attempts — so a worker that races
the server's bind, or outlives a server crash, retries instead of dying.
The client loop is a *session* loop: any connection death (EOF, reset, a
CRC-poisoned stream, a dispatch that never arrives within
``--dispatch-timeout``) tears down the session and reconnects; ``seq``
survives sessions so the batch sequence stays deterministic, and the
server's version-echo gate squares away whatever was in flight.

Scenario hooks: ``--train-delay`` sleeps before each upload (a straggler;
with a small ``max_staleness`` its updates arrive stale and get dropped),
``--crash-after N`` hard-kills the process (``os._exit``) after N uploads
(mid-round crash), ``--max-updates N`` exits each client loop cleanly,
``--fault-plan SPEC`` installs a client-side `transport.faults.FaultPlan`
on every connection (corrupt/drop/dup/delay/sever this worker's outbound
frames, deterministically).
"""
from __future__ import annotations

import argparse
import json
import os
import select
import socket
import sys
import threading
import time

CRASH_EXIT_CODE = 17
RECONNECT, DONE = "reconnect", "done"


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description="FedVision wire worker")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--meta", required=True, help="path to the run-meta JSON")
    p.add_argument("--client-ids", required=True, help="comma-separated client ids")
    p.add_argument("--train-delay", type=float, default=0.0,
                   help="seconds to sleep before each upload (straggler)")
    p.add_argument("--crash-after", type=int, default=0,
                   help="os._exit after this many uploads across the process")
    p.add_argument("--max-updates", type=int, default=0,
                   help="per-client clean exit after this many uploads")
    p.add_argument("--heartbeat-s", type=float, default=0.0,
                   help="override the meta heartbeat period (0 = use meta)")
    p.add_argument("--connect-retries", type=int, default=10,
                   help="bounded connect attempts per session (retry.Backoff)")
    p.add_argument("--backoff-base", type=float, default=0.05,
                   help="first backoff delay, doubling per attempt")
    p.add_argument("--backoff-max", type=float, default=2.0,
                   help="per-delay cap on the backoff schedule")
    p.add_argument("--dispatch-timeout", type=float, default=15.0,
                   help="seconds to wait for a frame before reconnecting "
                        "(covers a dropped dispatch or update)")
    p.add_argument("--max-sessions", type=int, default=50,
                   help="bound on reconnect sessions per client (safety net)")
    p.add_argument("--fault-plan", default="",
                   help="client-side faults.FaultPlan spec (e.g. "
                        "'corrupt@2:update;sever@5000')")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="seed for the fault plan's deterministic choices")
    p.add_argument("--device", default="cuda",
                   help="where the clients train: cuda (default) or cpu; no fallback")
    return p.parse_args(argv)


class _Conn:
    """One client's socket for one session: framed sends under a lock (the
    heartbeat thread and the training loop both write), a framed-receive
    with the dispatch timeout, and the CRC-poisoned-stream check."""

    def __init__(self, host: str, port: int, client: int, wire, args, plan=None):
        from repro_torch.core.transport.retry import Backoff, connect_with_retry

        self.wire = wire
        self.client = client
        self.sock = connect_with_retry(
            host, port,
            Backoff(base=args.backoff_base, cap=args.backoff_max,
                    attempts=args.connect_retries, seed=client),
            timeout=10.0,
        )
        self.sock.settimeout(args.dispatch_timeout)
        if plan is not None:
            self.sock = plan.wrap(self.sock, side="client")
        self._parser = wire.FrameParser()
        self._send_lock = threading.Lock()
        self._frames: list = []

    def send(self, frame: bytes) -> None:
        with self._send_lock:
            self.sock.sendall(frame)

    def recv_frame(self):
        """Next (ftype, payload); None on EOF or a CRC-poisoned stream."""
        while not self._frames:
            data = self.sock.recv(1 << 16)
            if not data:
                return None
            self._frames.extend(self._parser.feed(data))
            if self._parser.crc_errors:
                # the server's bytes arrived damaged: treat the whole
                # connection as poisoned and resync via reconnect
                return None
        return self._frames.pop(0)

    def ended(self) -> str | None:
        """What arrived while the client trained, read without waiting:
        "bye" once the server has said BYE, "eof" once the connection is
        gone or poisoned, else None. Frames read stay queued for
        `recv_frame`."""
        gone = False
        while not gone and select.select([self.sock], [], [], 0)[0]:
            data = self.sock.recv(1 << 16)
            self._frames.extend(self._parser.feed(data))
            gone = not data or self._parser.crc_errors > 0
        if any(t == self.wire.BYE for t, _ in self._frames):
            return "bye"  # the server's BYE is followed by its close
        return "eof" if gone else None

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _heartbeat_loop(conn: "_Conn", period: float, stop: threading.Event) -> None:
    wire = conn.wire
    while not stop.wait(period):
        try:
            conn.send(wire.pack_heartbeat(conn.client))
        except OSError:
            return


def _session(client: int, args, meta: dict, cfg, update, crash_budget,
             seq: int, plan, dev) -> tuple[str, int]:
    """One connection's dispatch/train/upload loop on ``dev``. Returns
    (outcome, seq): DONE on BYE/--max-updates, RECONNECT on any connection
    death — the caller re-enters with the preserved ``seq`` so the batch
    sequence (and with it the replay) is untouched by how many sessions it
    took."""
    import numpy as np
    import torch

    from repro_torch.core import rounds
    from repro_torch.core.transport import codec, replay, wire

    wire_codec = meta.get("wire_codec", "dense")
    block = int(meta.get("quant_block", 1024))
    hb = args.heartbeat_s or float(meta.get("heartbeat_s", 0.2))
    conn = _Conn(args.host, args.port, client, wire, args, plan)
    stop = threading.Event()
    try:
        conn.send(wire.pack_hello(client))
        threading.Thread(
            target=_heartbeat_loop, args=(conn, hb, stop),
            name=f"hb-{client}", daemon=True,
        ).start()
        while True:
            try:
                got = conn.recv_frame()
            except socket.timeout:
                return RECONNECT, seq  # dispatch lost in flight: resync
            if got is None:
                return RECONNECT, seq  # server gone or stream poisoned
            ftype, payload = got
            if ftype == wire.BYE:
                return DONE, seq
            if ftype != wire.DISPATCH:
                continue
            version, row_buf = wire.parse_dispatch(payload)
            base = codec.decode_row(row_buf).astype(np.float32)
            batch = rounds.to_device(replay.synth_client_batch(cfg, meta, client, seq), dev)
            trained, loss = update(torch.from_numpy(base).to(dev), batch)
            trained = trained.float().cpu().numpy()
            if args.train_delay:
                time.sleep(args.train_delay)
            # a run that ended while this client trained said BYE: leave now
            # rather than upload into the closing socket and then reconnect
            ended = conn.ended()
            if ended is not None:
                return (DONE if ended == "bye" else RECONNECT), seq
            buf = codec.encode_update(trained, base, wire_codec, block)
            conn.send(wire.pack_update(client, seq, version, float(loss), buf))
            seq += 1
            if crash_budget is not None and crash_budget.hit():
                os._exit(CRASH_EXIT_CODE)  # mid-round crash: no BYE, no cleanup
            if args.max_updates and seq >= args.max_updates:
                try:
                    conn.send(wire.pack_bye())  # orderly exit, best effort
                except OSError:
                    pass
                return DONE, seq
    except OSError:
        return RECONNECT, seq  # reset/sever mid-send: next session resyncs
    finally:
        stop.set()
        conn.close()


def run_client(client: int, args, meta: dict, cfg, update, crash_budget,
               plan=None, dev="cuda") -> None:
    """One client's session loop (runs in its own thread): reconnect —
    through the bounded backoff — until the work is DONE or the retry
    budget/session bound runs out."""
    from repro_torch.core.transport.retry import RetriesExhausted

    seq = 0
    for _ in range(max(args.max_sessions, 1)):
        try:
            outcome, seq = _session(client, args, meta, cfg, update,
                                    crash_budget, seq, plan, dev)
        except RetriesExhausted:
            return  # the server never came back within the backoff budget
        if outcome == DONE:
            return


class _CrashBudget:
    """Process-wide upload countdown shared by this worker's clients."""

    def __init__(self, n: int):
        self._left = n
        self._lock = threading.Lock()

    def hit(self) -> bool:
        with self._lock:
            self._left -= 1
            return self._left <= 0


def main(argv=None) -> int:
    args = _parse_args(argv)
    meta = json.loads(open(args.meta).read())
    clients = [int(c) for c in args.client_ids.split(",") if c != ""]
    if not clients:
        raise SystemExit("--client-ids is empty")

    from repro_torch import device as D
    from repro_torch.core.async_engine import build_row_update
    from repro_torch.core.transport import replay

    dev = D.resolve(args.device)
    # one row update shared by every client thread in this process
    cfg = replay.build_cfg(meta)
    fed = replay.build_fed(meta)
    opt = replay.build_optimizer(meta)
    update = build_row_update(cfg, fed, opt)
    crash = _CrashBudget(args.crash_after) if args.crash_after else None
    plan = None
    if args.fault_plan:
        from repro_torch.core.transport.faults import FaultPlan

        # one plan per process: counters persist across this worker's
        # reconnects, so 'drop@1:update' fires once, not once per session
        plan = FaultPlan.parse(args.fault_plan, seed=args.fault_seed)

    threads = [
        threading.Thread(
            target=run_client, args=(c, args, meta, cfg, update, crash, plan, dev),
            name=f"client-{c}",
        )
        for c in clients
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return 0


if __name__ == "__main__":
    code = main()
    # every thread has joined and every socket is closed: skip the
    # interpreter's teardown, which takes seconds once torch has imported
    # its checkpoint machinery, and which the harness would wait out
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
