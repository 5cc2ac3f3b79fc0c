"""Deterministic fault injection for the wire transport (port of
``repro/core/transport/faults.py``; DESIGN.md §16).

A copy of the reference's pure-Python module (the port never imports the
JAX package): the same spec and seed edit the same frame stream into the
same bytes in both packages.

A `FaultPlan` is parsed from a compact spec string — shippable through
``--fault-plan`` to worker subprocesses — and wraps either endpoint's
socket so the *same plan + same seed* injects the *same faults at the same
frames* on every run. That determinism is what lets the chaos suite pin
recovery behaviour (counters, convergence bounds) instead of flaking.

Grammar: ops separated by ``;`` (or ``,``), each::

    [side.]op@arg[:qualifier]*

    corrupt@K[:TYPE]   flip one seeded byte of the K-th (1-based) matching
                       outbound frame — the CRC firewall must detect it
    drop@K[:TYPE]      swallow the K-th matching outbound frame
    dup@K[:TYPE]       send the K-th matching outbound frame twice
    delay@K[:TYPE]:S   sleep S seconds before sending frame K
    sever@N            close the connection abruptly after N bytes sent
    kill@M             (server op) crash the landing loop after M landings
                       — no BYE, no cleanup: the kill -9 model

``side`` is ``client`` or ``server`` (default ``client``): which
endpoint's *outbound* frames the op watches. ``TYPE`` is a frame-type name
(``hello``/``dispatch``/``update``/``heartbeat``/``bye``); without it the
op counts every frame. Per-type counters are the determinism linchpin:
heartbeats interleave nondeterministically with updates, so "the 2nd
frame" is racy but "the 2nd UPDATE" is exact.

Counters live on the *plan*, not the socket wrapper, and survive
reconnects — otherwise ``drop@1:update`` would re-fire on every fresh
connection and the worker would retry forever. Every fault that fires is
counted in ``plan.fired`` (and surfaced into ``WireRunStats.faults_injected``
by the server) so the acceptance criterion "every injected fault is
counted" is checkable.
"""
from __future__ import annotations

import socket
import threading
import time

from repro_torch.core.transport import wire
from repro_torch.core.transport.retry import _fmix32

_TYPE_NAMES = {
    "hello": wire.HELLO,
    "dispatch": wire.DISPATCH,
    "update": wire.UPDATE,
    "heartbeat": wire.HEARTBEAT,
    "bye": wire.BYE,
}

CLIENT, SERVER = "client", "server"
_OPS = ("corrupt", "drop", "dup", "delay", "sever", "kill")


class _Op:
    """One parsed fault op with its own persistent match counter."""

    def __init__(self, side: str, kind: str, arg: int,
                 ftype: int | None = None, seconds: float = 0.0,
                 spec: str = ""):
        self.side, self.kind, self.arg = side, kind, arg
        self.ftype, self.seconds, self.spec = ftype, seconds, spec
        self.seen = 0  # matching frames (or bytes, for sever) so far
        self.done = False

    def matches_frame(self, ftype: int) -> bool:
        return self.ftype is None or self.ftype == ftype


class ServerKilled(RuntimeError):
    """The fault plan crashed the landing loop (the simulated kill -9)."""


class FaultPlan:
    """A seeded, parsed fault schedule shared by every socket it wraps."""

    def __init__(self, ops: list[_Op], *, seed: int = 0, spec: str = ""):
        self.ops = ops
        self.seed = seed
        self.spec = spec
        self.fired: dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str, *, seed: int = 0) -> "FaultPlan":
        ops: list[_Op] = []
        for raw in spec.replace(",", ";").split(";"):
            tok = raw.strip()
            if not tok:
                continue
            side = CLIENT
            head, _, rest = tok.partition("@")
            if "." in head:
                side, head = head.split(".", 1)
                if side not in (CLIENT, SERVER):
                    raise ValueError(f"fault side must be client/server: {tok!r}")
            if head not in _OPS:
                raise ValueError(f"unknown fault op {head!r} in {tok!r}")
            if not rest:
                raise ValueError(f"fault op needs @arg: {tok!r}")
            parts = rest.split(":")
            arg = int(parts[0])
            if arg < 1:
                raise ValueError(f"fault arg must be >= 1: {tok!r}")
            ftype: int | None = None
            seconds = 0.0
            for q in parts[1:]:
                if q in _TYPE_NAMES:
                    ftype = _TYPE_NAMES[q]
                else:
                    seconds = float(q)
            if head == "delay" and seconds <= 0.0:
                raise ValueError(f"delay needs :seconds qualifier: {tok!r}")
            if head == "kill":
                side = SERVER  # kill is meaningful only at the landing loop
            ops.append(_Op(side, head, arg, ftype, seconds, tok))
        if not ops:
            raise ValueError(f"empty fault plan: {spec!r}")
        return cls(ops, seed=seed, spec=spec)

    def _fire(self, op: _Op) -> None:
        op.done = True
        with self._lock:
            self.fired[op.spec] = self.fired.get(op.spec, 0) + 1

    @property
    def total_fired(self) -> int:
        with self._lock:
            return sum(self.fired.values())

    # -- server-side landing-count trigger -----------------------------------

    def kill_after_landings(self) -> int | None:
        """M of the first pending ``kill@M`` op, or None."""
        for op in self.ops:
            if op.kind == "kill" and not op.done:
                return op.arg
        return None

    def maybe_kill(self, landings: int) -> None:
        """Called by the landing loop after each landing; raises
        `ServerKilled` when a pending kill op's threshold is reached."""
        for op in self.ops:
            if op.kind == "kill" and not op.done and landings >= op.arg:
                self._fire(op)
                raise ServerKilled(f"fault plan {op.spec!r} at {landings} landings")

    # -- socket wrapping ------------------------------------------------------

    def wrap(self, sock: socket.socket, side: str = CLIENT) -> "FaultySocket":
        return FaultySocket(sock, self, side)

    def _on_send(self, side: str, frame: bytes) -> list[bytes]:
        """Apply frame-level ops to one outbound frame; returns the list of
        byte strings actually to send ([] = dropped). The frame's type is
        read straight out of the wire header."""
        if len(frame) <= wire.HEADER_BYTES:
            return [frame]
        ftype = frame[wire.HEADER_BYTES]
        out = [frame]
        with self._lock:
            ops = [
                op for op in self.ops
                if op.side == side and op.kind in ("corrupt", "drop", "dup", "delay")
                and op.matches_frame(ftype)
            ]
            hits = []
            for op in ops:
                op.seen += 1
                if not op.done and op.seen == op.arg:
                    hits.append(op)
        for op in hits:
            if op.kind == "drop":
                out = []
            elif op.kind == "dup":
                out = out + list(out)
            elif op.kind == "delay":
                time.sleep(op.seconds)
            elif op.kind == "corrupt":
                # flip one seeded byte past the length prefix (the length
                # must stay honest so the receiver's parser keeps framing
                # and the CRC — not a desync — reports the damage)
                lo = wire._LEN.size
                pos = lo + _fmix32(self.seed * 0x9E3779B9 + op.seen) % (len(frame) - lo)
                out = [
                    bytes(frame[:pos]) + bytes([frame[pos] ^ 0xFF]) + bytes(frame[pos + 1:])
                    if b is frame else b
                    for b in out
                ]
            self._fire(op)
        return out

    def _sever_budget(self, side: str, nbytes: int) -> bool:
        """Account `nbytes` about to be sent; True => sever now."""
        with self._lock:
            for op in self.ops:
                if op.side == side and op.kind == "sever" and not op.done:
                    op.seen += nbytes
                    if op.seen >= op.arg:
                        self._fire_locked(op)
                        return True
        return False

    def _fire_locked(self, op: _Op) -> None:
        op.done = True
        self.fired[op.spec] = self.fired.get(op.spec, 0) + 1


class FaultySocket:
    """A socket proxy applying one `FaultPlan` side to outbound frames.

    Callers on both endpoints send exactly one complete frame per
    ``sendall`` (worker `_Conn.send`, server `_send`) — the invariant that
    makes frame-level interception possible without reparsing a stream.
    Reads and everything else pass straight through.
    """

    def __init__(self, sock: socket.socket, plan: FaultPlan, side: str):
        self._sock = sock
        self._plan = plan
        self._side = side

    def sendall(self, data: bytes) -> None:
        if self._plan._sever_budget(self._side, len(data)):
            try:
                self._sock.close()
            except OSError:
                pass
            raise ConnectionResetError(f"fault plan severed the {self._side} socket")
        for chunk in self._plan._on_send(self._side, data):
            self._sock.sendall(chunk)

    def __getattr__(self, name):
        return getattr(self._sock, name)
