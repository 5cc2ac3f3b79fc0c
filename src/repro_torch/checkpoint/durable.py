"""Durable round state: atomic engine snapshots + a landing WAL (port of
``repro/checkpoint/durable.py``; DESIGN.md §16).

The file formats are the reference's byte for byte: a snapshot or a WAL
written by either package is read by the other. The arrays a snapshot
holds are NumPy (``ArrivalAsyncEngine.export_state`` copies them off the
card), so nothing here touches a device until `DurableRun.recover_engine`
builds the engine on its ``device``.

The `WireServer` is the single point of total loss: the packed ``(C,
N_total)`` buffer, the aggregator substate (EF residual rows, fmix32 round
counters), and the dispatch versions all live in one process. `DurableRun`
makes that process killable: a directory of

    meta.json            the run meta (the schedule's self-description)
    wal_<E>.jsonl        event segments: every landing-loop event (dispatch
                         and land), CRC-guarded per line, segment starting
                         at global event index E
    snap_<E>.ckpt        full-engine snapshots (atomic tmp+fsync+rename,
                         CRC-guarded) taken after event E

Recovery = the newest CRC-valid snapshot + a *partial replay* of the WAL
suffix through `transport.replay.apply_events` — the identical
single-row update and codec round-trip the full replay harness already
proves deterministic. Nothing model-sized ever enters the WAL: a land
event is ~100 bytes of JSON, the trained row is recomputed from
``(seed, client, seq)`` at recovery time.

Durability model: the WAL is flushed (OS buffer) per event — surviving
``kill -9`` of the server process, the crash model the transport defends
against — and fsynced at snapshot boundaries; pass ``fsync_every_event``
for whole-machine-loss durability at a per-landing fsync cost. A torn
final WAL line (the crash interrupting the write itself) fails its line
CRC and is discarded: the engine recovers to the last *complete* event,
and the version-echo gate reconciles any worker whose update landed after
it.

WAL segments are never deleted, so the concatenation of all segments is
the complete `ArrivalSchedule` of the run across every crash — which is
what lets the chaos tests pin a recovered run bit-for-bit against an
uninterrupted replay of the combined schedule.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import zlib
from pathlib import Path

import numpy as np

from repro_torch.core.transport.replay import ArrivalSchedule, WireEvent, apply_events, make_engine

SNAP_MAGIC = b"FVSNAP01"


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: Path, blob: bytes) -> None:
    """tmp + fsync + rename: the file either fully exists or never did."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path.parent)


# -- snapshot file format -----------------------------------------------------

def write_snapshot(path: Path, snap: dict) -> int:
    """Serialize an `ArrivalAsyncEngine.export_state` dict to `path`
    atomically. Layout: magic | u32 crc32(body) | u64 len(body) | body,
    body = npz of the arrays plus the scalars JSON as a uint8 array.
    Returns the bytes written."""
    buf = io.BytesIO()
    scal = json.dumps(snap["scalars"]).encode()
    np.savez(buf, __scalars__=np.frombuffer(scal, np.uint8), **snap["arrays"])
    body = buf.getvalue()
    blob = (
        SNAP_MAGIC
        + zlib.crc32(body).to_bytes(4, "big")
        + len(body).to_bytes(8, "big")
        + body
    )
    atomic_write_bytes(path, blob)
    return len(blob)


def read_snapshot(path: Path) -> dict:
    """Load + verify one snapshot file; raises ValueError on any damage
    (bad magic, truncation, CRC mismatch) so recovery can fall back to an
    older snapshot instead of importing garbage."""
    blob = Path(path).read_bytes()
    if blob[: len(SNAP_MAGIC)] != SNAP_MAGIC:
        raise ValueError(f"{path}: bad snapshot magic")
    off = len(SNAP_MAGIC)
    crc = int.from_bytes(blob[off : off + 4], "big")
    n = int.from_bytes(blob[off + 4 : off + 12], "big")
    body = blob[off + 12 :]
    if len(body) != n:
        raise ValueError(f"{path}: truncated snapshot ({len(body)} != {n} bytes)")
    if zlib.crc32(body) != crc:
        raise ValueError(f"{path}: snapshot CRC mismatch")
    with np.load(io.BytesIO(body)) as z:
        arrays = {k: z[k] for k in z.files if k != "__scalars__"}
        scalars = json.loads(z["__scalars__"].tobytes().decode())
    return {"arrays": arrays, "scalars": scalars}


# -- WAL ----------------------------------------------------------------------

def _wal_line(idx: int, ev: WireEvent) -> str:
    body = json.dumps({"i": idx, "ev": dataclasses.asdict(ev)},
                      separators=(",", ":"))
    return f"{zlib.crc32(body.encode()):08x} {body}\n"


def _parse_wal_line(line: str) -> tuple[int, WireEvent] | None:
    """(index, event), or None for a torn/corrupt line."""
    if len(line) < 10 or line[8] != " ":
        return None
    body = line[9:].rstrip("\n")
    try:
        if int(line[:8], 16) != zlib.crc32(body.encode()):
            return None
        obj = json.loads(body)
        return int(obj["i"]), WireEvent(**obj["ev"])
    except (ValueError, KeyError, TypeError):
        return None


class DurableRun:
    """One run's durable directory: meta + WAL segments + snapshots.

    The landing loop calls `append_event` for every recorded event and
    `snapshot(engine)` whenever its policy fires; both live inline in the
    loop. Opening an existing directory resumes: the event counter
    continues from the last complete WAL line.
    """

    def __init__(self, root: str | Path, meta: dict | None = None, *,
                 fsync_every_event: bool = False):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.fsync_every_event = fsync_every_event
        meta_path = self.root / "meta.json"
        if meta is not None:
            atomic_write_bytes(meta_path, json.dumps(meta).encode())
            self.meta = dict(meta)
        elif meta_path.exists():
            self.meta = json.loads(meta_path.read_text())
        else:
            raise FileNotFoundError(f"{meta_path}: new DurableRun needs meta")
        self.n_events = sum(len(evs) for _, evs in self._segments())
        self.snapshots_written = 0
        self._wal = None  # lazily (re)opened; a snapshot rotates it

    # -- write path ----------------------------------------------------------

    def _open_wal(self) -> None:
        if self._wal is None:
            self._wal = open(self.root / f"wal_{self.n_events:08d}.jsonl", "a")

    def append_event(self, ev: WireEvent) -> None:
        self._open_wal()
        self._wal.write(_wal_line(self.n_events, ev))
        self._wal.flush()
        if self.fsync_every_event:
            os.fsync(self._wal.fileno())
        self.n_events += 1

    def snapshot(self, engine) -> int:
        """Write a full-engine snapshot at the current event count, fsync
        and rotate the WAL (the next segment starts here). Returns bytes
        written."""
        if self._wal is not None:
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._wal.close()
            self._wal = None
        n = write_snapshot(
            self.root / f"snap_{self.n_events:08d}.ckpt", engine.export_state()
        )
        self.snapshots_written += 1
        return n

    def close(self) -> None:
        if self._wal is not None:
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._wal.close()
            self._wal = None

    # -- read path ------------------------------------------------------------

    def _segments(self) -> list[tuple[int, list[WireEvent]]]:
        """All WAL segments as (start_index, events), index-ordered; a torn
        or corrupt line ends its segment (everything before it is intact —
        the WAL is append-only)."""
        out = []
        for p in sorted(self.root.glob("wal_*.jsonl")):
            start = int(p.stem.split("_")[1])
            events = []
            for line in p.read_text().splitlines(keepends=True):
                parsed = _parse_wal_line(line)
                if parsed is None:
                    break
                events.append(parsed[1])
            out.append((start, events))
        return out

    def events(self) -> list[WireEvent]:
        """The complete recorded event sequence across every crash —
        segment concatenation, gap-checked."""
        all_events: list[WireEvent] = []
        for start, evs in self._segments():
            if start > len(all_events):
                raise ValueError(
                    f"WAL gap: segment starts at event {start}, have {len(all_events)}"
                )
            all_events = all_events[:start] + evs
        return all_events

    def schedule(self) -> ArrivalSchedule:
        """The run's full `ArrivalSchedule` as persisted — what the
        recovery-equals-replay pin replays."""
        return ArrivalSchedule(meta=dict(self.meta), events=self.events())

    def latest_snapshot(self) -> tuple[int, dict] | None:
        """(event_count, snapshot dict) of the newest CRC-valid snapshot,
        falling back across damaged ones; None if no usable snapshot."""
        for p in sorted(self.root.glob("snap_*.ckpt"), reverse=True):
            try:
                return int(p.stem.split("_")[1]), read_snapshot(p)
            except ValueError:
                continue
        return None

    def recover_engine(self, *, clock=None, device="cuda"):
        """Rebuild the engine on ``device`` exactly as it stood at the last
        complete WAL event: newest valid snapshot imported, then the WAL
        suffix replayed through the row update (`replay.apply_events`).
        Returns ``(engine, n_events_replayed)``; a run with no snapshot
        replays the whole WAL from the seed engine — recovery degrades
        gracefully to a full replay, never to data loss."""
        events = self.events()
        engine = make_engine(self.meta, clock=clock, device=device)
        at = 0
        found = self.latest_snapshot()
        if found is not None:
            at, snap = found
            engine.import_state(snap)
        apply_events(engine, events[at:], self.meta, start_index=at)
        self.n_events = len(events)
        return engine, len(events) - at
