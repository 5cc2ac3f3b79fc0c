"""Recorded arrival schedules and the SimClock replay (port of
``repro/core/transport/replay.py``; DESIGN.md §14).

A wire run records its **arrival schedule**: the ordered dispatch/land
events its landing loop processed, with relative times. :func:`replay`
drives an ``ArrivalAsyncEngine`` from that record on a plain ``SimClock``,
recomputing each trained row with ``async_engine.build_row_update`` and
pushing it through the wire codec's round trip (``transport.codec``), so a
recorded run replays in process:

    dense codec  -> the replayed global equals the recorded run's bit for
                    bit (same row update, same codec bytes, same order);
    quant8 codec -> 1e-5 agreement (the int8 delta round trip is
                    deterministic NumPy; the tolerance covers rint/fma
                    differences between the worker's host and the replayer).

Replay cross-checks every recorded decision against the engine's own
(dispatch versions, staleness drops, flush boundaries), and
:class:`ReplayMismatch` names the first event that disagrees. The schedule
is JSON and holds no tensors: the rows are recomputed. Its ``meta`` block
rebuilds the config, engine, optimizer and each client's batches: client
``c``'s ``k``-th batch is a function of ``(seed, c, k)``
(:func:`synth_client_batch`). The format is the reference's, so a schedule
the reference recorded replays through the port.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import async_engine as ae
from repro_torch.core import rounds as R
from repro_torch.core.rounds import FedConfig
from repro_torch.core.simclock import SimClock
from repro_torch.core.transport import codec
from repro_torch.optim import sgd


class ReplayMismatch(AssertionError):
    """The replay's re-derivation of a recorded event disagrees with the
    record: the first such event."""


@dataclasses.dataclass
class WireEvent:
    """One landing-loop action.

    kind "dispatch": the server pushed the current global to ``client``;
    ``version`` is the global version sent. kind "land": an UPDATE arrived;
    ``version`` is the dispatch version it was trained against, ``seq`` the
    client-local update index (the batch selector), ``dropped`` whether the
    staleness gate discarded it, and ``flush`` the round index it completed
    (-1 otherwise).
    """

    kind: str
    t: float
    client: int
    version: int
    seq: int = -1
    dropped: bool = False
    flush: int = -1


@dataclasses.dataclass
class ArrivalSchedule:
    meta: dict[str, Any]
    events: list[WireEvent] = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(
            {"meta": self.meta, "events": [dataclasses.asdict(e) for e in self.events]})

    @classmethod
    def from_json(cls, text: str) -> "ArrivalSchedule":
        obj = json.loads(text)
        return cls(obj["meta"], [WireEvent(**e) for e in obj["events"]])

    def save(self, path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "ArrivalSchedule":
        return cls.from_json(Path(path).read_text())

    @property
    def n_flushes(self) -> int:
        return sum(1 for e in self.events if e.flush >= 0)

    @property
    def n_dropped(self) -> int:
        return sum(1 for e in self.events if e.kind == "land" and e.dropped)


# -- run meta: the schedule's self-description -------------------------------

def build_cfg(meta: dict):
    cfg = get_arch(meta["arch"])
    if meta.get("reduced", True):
        cfg = cfg.reduced()
    if meta.get("overrides"):
        cfg = dataclasses.replace(cfg, **meta["overrides"])
    return cfg


def build_fed(meta: dict) -> FedConfig:
    """The reference's FedConfig of a run, aggregating through the port's
    kernels (``agg_impl="kernel"``: K1 on the card, its plain version on
    the host)."""
    return FedConfig(
        n_clients=int(meta["n_clients"]),
        local_steps=int(meta.get("local_steps", 1)),
        aggregation=meta.get("aggregation", "dense"),
        agg_impl="kernel",
        client_axis="data",
        data_axis=None,
        state_layout="flat",
        mode="async",
        buffer_size=int(meta.get("buffer_size", 0)),
        staleness_alpha=float(meta.get("staleness_alpha", 0.5)),
        max_staleness=int(meta.get("max_staleness", 0)),
        transport=meta.get("transport", "socket"),
        wire_codec=meta.get("wire_codec", "dense"),
        queue_cap=int(meta.get("queue_cap", 0)),
        heartbeat_s=float(meta.get("heartbeat_s", 0.2)),
        heartbeat_timeout_s=float(meta.get("heartbeat_timeout_s", 2.0)),
    )


def build_optimizer(meta: dict):
    # the row update is a function of (dispatch row, batch): momentum-free sgd
    return sgd(float(meta.get("lr", 0.05)), momentum=0.0)


def synth_client_batch(cfg, meta: dict, client: int, k: int) -> dict:
    """Client ``c``'s ``k``-th local batch: ``{"tokens": (E, b, seq)}`` int32
    on the host, drawn by NumPy ``default_rng([seed, c, k])`` (the
    reference's draw, so both packages train on the same tokens)."""
    rng = np.random.default_rng([int(meta["seed"]), int(client), int(k)])
    shape = (int(meta.get("local_steps", 1)), int(meta["batch"]), int(meta["seq"]))
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(np.int32))}


# -- replay ------------------------------------------------------------------

def make_engine(meta: dict, clock: SimClock | None = None,
                device: str | torch.device = "cuda") -> ae.ArrivalAsyncEngine:
    return ae.ArrivalAsyncEngine(build_cfg(meta), build_fed(meta), build_optimizer(meta),
                                 seed=int(meta["seed"]), clock=clock or SimClock(), device=device)


def apply_events(engine: ae.ArrivalAsyncEngine, events: list[WireEvent], meta: dict, *,
                 update=None, start_index: int = 0) -> ae.ArrivalAsyncEngine:
    """Drive ``engine`` through recorded events, re-deriving each trained
    row with the row update and the wire codec's round trip and checking
    every recorded decision (dispatch versions, drops, flush boundaries)
    against the engine's own. ``start_index`` only offsets the event
    numbering in mismatch messages."""
    cfg, fed = build_cfg(meta), build_fed(meta)
    if update is None:
        update = ae.build_row_update(cfg, fed, build_optimizer(meta))
    wire_codec = meta.get("wire_codec", "dense")
    block = int(meta.get("quant_block", 1024))
    for i, ev in enumerate(events, start=start_index):
        where = f"event {i} ({ev.kind} client {ev.client} t={ev.t:.3f})"
        if ev.kind == "dispatch":
            engine.clock.advance_to(max(ev.t, engine.clock.now()))
            got = engine.dispatch(ev.client)
            if got != ev.version:
                raise ReplayMismatch(
                    f"{where}: replay dispatched version {got}, wire sent {ev.version}")
        elif ev.kind == "land":
            have = int(engine.dispatch_version[ev.client])
            if have != ev.version:
                raise ReplayMismatch(
                    f"{where}: replay dispatch_version {have} != recorded {ev.version}")
            base = engine.dispatch_row(ev.client)
            batch = R.to_device(synth_client_batch(cfg, meta, ev.client, ev.seq), engine.device)
            trained, loss = update(torch.from_numpy(base).to(engine.device), batch)
            # the worker's wire hop: encode -> decode the update
            landed = codec.decode_update(
                codec.encode_update(trained.float().cpu().numpy(), base, wire_codec, block), base)
            res = engine.land(ev.client, landed, loss=float(loss), t=ev.t)
            if res.dropped != ev.dropped:
                raise ReplayMismatch(
                    f"{where}: replay {'dropped' if res.dropped else 'staged'} "
                    f"(staleness {res.staleness}), wire "
                    f"{'dropped' if ev.dropped else 'staged'}")
            got_flush = -1 if res.flush is None else res.flush.round_idx
            if got_flush != ev.flush:
                raise ReplayMismatch(
                    f"{where}: replay flush index {got_flush} != recorded {ev.flush}")
        else:
            raise ReplayMismatch(f"{where}: unknown event kind {ev.kind!r}")
    return engine


def replay(schedule: ArrivalSchedule, *, clock: SimClock | None = None,
           device: str | torch.device = "cuda") -> ae.ArrivalAsyncEngine:
    """Re-derive a recorded run through a fresh engine on the SimClock ->
    the engine (history, state, drop counters); raises
    :class:`ReplayMismatch` at the first event that disagrees."""
    engine = make_engine(schedule.meta, clock=clock or SimClock(), device=device)
    return apply_events(engine, schedule.events, schedule.meta)
