"""Multi-process federation over a real wire (port of
``repro/core/transport/``; DESIGN.md §14).

The transport package splits the platform's client workers from the
server: `wire` frames the socket protocol (PROTOCOL_VERSION 3, the
reference's bytes), `codec` encodes row payloads (dense f32 or quantized
deltas), `server.WireServer` runs the landing loop that feeds an
`ArrivalAsyncEngine` in wall-clock arrival order, `replay` re-derives a
recorded wire run through the in-process SimClock engine (the determinism
pin), `faults` and `retry` inject and survive line damage, and
`harness.wire_run` orchestrates a whole run — server plus worker
subprocesses — in one call.
"""
from repro_torch.core.transport.codec import (  # noqa: F401
    CODECS,
    decode_row,
    decode_update,
    encode_row,
    encode_update,
    payload_bytes,
)
from repro_torch.core.transport.replay import (  # noqa: F401
    ArrivalSchedule,
    ReplayMismatch,
    WireEvent,
    synth_client_batch,
)
from repro_torch.core.transport.replay import replay as replay_schedule  # noqa: F401
from repro_torch.core.transport.wire import FrameParser, encode_frame  # noqa: F401

__all__ = [
    "ArrivalSchedule",
    "CODECS",
    "FrameParser",
    "ReplayMismatch",
    "WireEvent",
    "decode_row",
    "decode_update",
    "encode_frame",
    "encode_row",
    "encode_update",
    "payload_bytes",
    "replay_schedule",
    "synth_client_batch",
]
