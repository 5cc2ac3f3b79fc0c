"""Length-prefixed wire framing for the federation transport (DESIGN.md §14,
crash-tolerance + CRC in §16).

A port of ``repro/core/transport/wire.py`` (pure Python + NumPy; the port
never imports the JAX package). Frames stay byte-compatible with
PROTOCOL_VERSION 3, so the reference's clients and servers talk to the
port's. Where the reference concatenates a frame's pieces and slices its
body out of the receive buffer (three copies of a gigabyte row each way),
the port writes a row's frame as parts (:func:`frame_parts`,
:func:`send_frame`: one ``sendmsg`` of the header and the row's own
memory, no join) and copies it once when it parses it; the bytes are the
same.

One frame on the socket is::

    u32 length (big-endian, of everything after the CRC field)
    u32 crc32  (of everything after itself: type byte + payload)
    u8  frame type
    ... type-specific payload

Frame types (client -> server unless noted):

    HELLO      client_id u32, protocol u16 — sent once per connection;
               repeating it on a new connection IS the reconnect path
               (the server re-registers the id and redispatches).
    DISPATCH   (server -> client) version u64, encoded row payload
               (`transport.codec`) — the global model the client trains on.
    UPDATE     client_id u32, seq u32 (client-local update index, the batch
               selector), version u64 (ECHO of the DISPATCH version this
               update was trained against — the server refuses an echo that
               does not match the client's current dispatch, which closes
               the superseded-dispatch race: a reconnect or redispatch can
               leave two processes holding dispatches for one client id,
               and an update trained on the older row must never be
               credited to the newer version), loss f32, encoded update
               payload (dense full row or quant8 delta vs the dispatch,
               `codec.encode_update`).
    HEARTBEAT  client_id u32 — liveness only, never touches the engine.
    BYE        (server -> client) empty — orderly shutdown.

Serving-plane frames (DESIGN.md §17; client here = an inference consumer,
not a federated trainer):

    INFER      request_id u32, height u16, width u16, raw little-endian
               f32 image bytes (H*W*3) — one detection request.
    RESULT     (server -> client) request_id u32 (echo), round_version u64
               (the landed training round the serving model was published
               from), freshness tier u8 (serving.TIER_CODES), n u16, then
               n detections of (label i32, score f32, box 4xf32 center
               format) — only valid (NMS-kept) slots ship.
    STATUS     empty payload = request; response = a UTF-8 JSON blob, the
               `serving.model_status` evaluation (version, rounds/seconds
               behind, freshness tier, occupancy counters).

The CRC is the corruption firewall (DESIGN.md §16): a flipped byte anywhere
in the body is *detected* — the parser counts it in ``crc_errors`` and
withholds the frame — instead of landing corrupt model bytes into the
engine and silently diverging from the replay. A mismatched frame is never
yielded; the endpoints treat a CRC error as a poisoned connection (drop it
and let the reconnect/redispatch path recover), because a stream that
corrupted one byte cannot be trusted to have framed the next one honestly.

`FrameParser` is an incremental decoder: feed it arbitrary byte chunks
(TCP gives no message boundaries — frames arrive split and coalesced) and
it yields complete frames in order. The hypothesis round-trip suite in
tests/test_packing_props.py pins encode->feed->parse identity under
adversarial chunkings, and corrupted-byte sweeps in tests/test_transport.py
pin that no corruption ever parses.
"""
from __future__ import annotations

import struct
import zlib

PROTOCOL_VERSION = 3  # v3: serving frames (INFER/RESULT/STATUS); v2: CRC32

HELLO = 1
DISPATCH = 2
UPDATE = 3
HEARTBEAT = 4
BYE = 5
INFER = 6
RESULT = 7
STATUS = 8

FRAME_TYPES = (HELLO, DISPATCH, UPDATE, HEARTBEAT, BYE, INFER, RESULT, STATUS)

_LEN = struct.Struct("!I")
_CRC = struct.Struct("!I")
_HELLO = struct.Struct("!IH")
_DISPATCH = struct.Struct("!Q")
_UPDATE = struct.Struct("!IIQf")
_HEARTBEAT = struct.Struct("!I")
_INFER = struct.Struct("!IHH")
_RESULT = struct.Struct("!IQBH")
_DET = struct.Struct("!ifffff")  # label, score, box (x, y, w, h)

HEADER_BYTES = _LEN.size + _CRC.size  # per-frame framing overhead before the body

# a frame larger than this is a protocol error, not a big model: the row
# payload of a 314B-param arch ships sharded, never as one frame
MAX_FRAME = 1 << 31

# bytes a reader takes from its socket a call, into one reused buffer: a
# gigabyte row arrives in hundreds of calls, not tens of thousands
RECV_CHUNK = 1 << 22


def frame_parts(ftype: int, payload=b"", *more) -> tuple:
    """One wire frame as parts, not joined: the length prefix and CRC32,
    the type byte, then ``payload`` and ``more`` as given (bytes or
    contiguous buffers, a row's memory among them). :func:`send_frame`
    writes them; ``b"".join`` of them is :func:`encode_frame`."""
    if ftype not in FRAME_TYPES:
        raise ValueError(f"unknown frame type {ftype}")
    parts = (bytes([ftype]), payload, *more)
    n = sum(memoryview(p).nbytes for p in parts)
    if n > MAX_FRAME:
        raise ValueError(f"frame of {n} bytes exceeds MAX_FRAME")
    crc = 0
    for p in parts:
        crc = zlib.crc32(p, crc)
    return (_LEN.pack(n) + _CRC.pack(crc), *parts)


def encode_frame(ftype: int, payload: bytes = b"", *more: bytes) -> bytes:
    """One wire frame: length prefix + CRC32 + type byte + payload, the
    payload being ``payload`` followed by ``more`` (joined once, into the
    frame)."""
    return b"".join(frame_parts(ftype, payload, *more))


def frame_nbytes(frame) -> int:
    """Bytes of a frame given whole or as :func:`frame_parts`."""
    if isinstance(frame, (bytes, bytearray)):
        return len(frame)
    return sum(memoryview(p).nbytes for p in frame)


def send_frame(sock, frame) -> None:
    """Write one frame, whole (bytes) or as :func:`frame_parts`. Parts go
    out by ``sendmsg`` straight from their own memory, or, on a socket a
    fault plan intercepts frame by frame (``faults.FaultySocket``), through
    its ``send_parts``."""
    if isinstance(frame, (bytes, bytearray)):
        sock.sendall(frame)
        return
    if hasattr(sock, "send_parts"):
        sock.send_parts(frame)
        return
    views = [v for v in (memoryview(p).cast("B") for p in frame) if v.nbytes]
    while views:
        sent = sock.sendmsg(views[:64])
        while sent:
            if sent >= views[0].nbytes:
                sent -= views.pop(0).nbytes
            else:
                views[0], sent = views[0][sent:], 0


class FrameParser:
    """Incremental frame decoder over a TCP byte stream.

    `feed(chunk)` returns every frame completed by that chunk as a list of
    ``(ftype, payload)`` tuples; partial frames are buffered across calls.
    A frame whose CRC32 does not match is *withheld* — counted in
    ``crc_errors``, its bytes discarded, parsing continues at the next
    length prefix — so a corrupted frame is detected, never parsed.
    Structurally impossible streams (absurd lengths, an unknown type under
    a *valid* CRC) still raise ``ValueError``: those are protocol bugs, not
    line noise. The parser is transport-agnostic: the socket reader
    threads, the replay tooling, and the property tests all share it.
    """

    def __init__(self):
        self._buf = bytearray()
        self.crc_errors = 0  # frames withheld because their CRC mismatched

    @property
    def pending(self) -> int:
        """Bytes buffered awaiting a complete frame."""
        return len(self._buf)

    def feed(self, chunk: bytes) -> list[tuple[int, bytes]]:
        self._buf.extend(chunk)
        frames: list[tuple[int, bytes]] = []
        while True:
            if len(self._buf) < HEADER_BYTES:
                return frames
            (n,) = _LEN.unpack_from(self._buf, 0)
            if n < 1 or n > MAX_FRAME:
                raise ValueError(f"corrupt frame length {n}")
            if len(self._buf) < HEADER_BYTES + n:
                return frames
            (crc,) = _CRC.unpack_from(self._buf, _LEN.size)
            # read the body in place; copy only the payload of a good frame
            with memoryview(self._buf) as view:
                body = view[HEADER_BYTES : HEADER_BYTES + n]
                good = zlib.crc32(body) == crc
                ftype = body[0]
                payload = bytes(body[1:]) if good else b""
                body.release()
            del self._buf[: HEADER_BYTES + n]
            if not good:
                # corruption detected: withhold the frame, keep the stream
                # position (the length prefix still told us where it ended)
                self.crc_errors += 1
                continue
            if ftype not in FRAME_TYPES:
                raise ValueError(f"unknown frame type {ftype}")
            frames.append((ftype, payload))


# -- message payloads --------------------------------------------------------

def pack_hello(client_id: int) -> bytes:
    return encode_frame(HELLO, _HELLO.pack(client_id, PROTOCOL_VERSION))


def parse_hello(payload: bytes) -> int:
    client_id, proto = _HELLO.unpack(payload)
    if proto != PROTOCOL_VERSION:
        raise ValueError(f"protocol version {proto} != {PROTOCOL_VERSION}")
    return client_id


def pack_dispatch(version: int, row_payload: bytes) -> bytes:
    return encode_frame(DISPATCH, _DISPATCH.pack(version), row_payload)


def dispatch_parts(version: int, *row_parts) -> tuple:
    """:func:`pack_dispatch`'s frame as :func:`frame_parts`, the row payload
    given as parts (``codec.dense_parts``)."""
    return frame_parts(DISPATCH, _DISPATCH.pack(version), *row_parts)


def parse_dispatch(payload: bytes) -> tuple[int, bytes]:
    (version,) = _DISPATCH.unpack_from(payload, 0)
    return version, payload[_DISPATCH.size :]


def pack_update(client_id: int, seq: int, version: int, loss: float,
                row_payload: bytes) -> bytes:
    return encode_frame(UPDATE, _UPDATE.pack(client_id, seq, version, loss), row_payload)


def update_parts(client_id: int, seq: int, version: int, loss: float, *row_parts) -> tuple:
    """:func:`pack_update`'s frame as :func:`frame_parts`, the payload given
    as parts (``codec.update_parts``)."""
    return frame_parts(UPDATE, _UPDATE.pack(client_id, seq, version, loss), *row_parts)


def parse_update(payload: bytes) -> tuple[int, int, int, float, bytes]:
    client_id, seq, version, loss = _UPDATE.unpack_from(payload, 0)
    return client_id, seq, version, loss, payload[_UPDATE.size :]


def pack_heartbeat(client_id: int) -> bytes:
    return encode_frame(HEARTBEAT, _HEARTBEAT.pack(client_id))


def parse_heartbeat(payload: bytes) -> int:
    return _HEARTBEAT.unpack(payload)[0]


def pack_bye() -> bytes:
    return encode_frame(BYE)


# -- serving-plane payloads (DESIGN.md §17) ----------------------------------

def pack_infer(request_id: int, image) -> bytes:
    """INFER payload: one (H, W, 3) f32 image as raw little-endian bytes.
    NumPy-only on purpose — inference consumers need the codec, not JAX."""
    import numpy as np

    img = np.ascontiguousarray(np.asarray(image, np.float32))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"INFER image must be (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    if h > 0xFFFF or w > 0xFFFF:
        raise ValueError(f"image {h}x{w} exceeds the u16 frame dimensions")
    return encode_frame(
        INFER, _INFER.pack(request_id, h, w) + img.astype("<f4").tobytes()
    )


def parse_infer(payload: bytes):
    """-> (request_id, image (H, W, 3) f32)."""
    import numpy as np

    request_id, h, w = _INFER.unpack_from(payload, 0)
    body = payload[_INFER.size:]
    if len(body) != h * w * 3 * 4:
        raise ValueError(
            f"INFER body of {len(body)} bytes != {h}x{w}x3 f32 image"
        )
    img = np.frombuffer(body, "<f4").astype(np.float32).reshape(h, w, 3)
    return request_id, img


def pack_result(request_id: int, version: int, tier_code: int,
                detections) -> bytes:
    """RESULT payload: echo + round version + freshness tier + the kept
    detections, each a (label, score, (x, y, w, h)) tuple."""
    dets = list(detections)
    if len(dets) > 0xFFFF:
        raise ValueError(f"{len(dets)} detections exceed the u16 count field")
    body = _RESULT.pack(request_id, version, tier_code, len(dets))
    for label, score, box in dets:
        body += _DET.pack(int(label), float(score), *(float(v) for v in box))
    return encode_frame(RESULT, body)


def parse_result(payload: bytes):
    """-> (request_id, version, tier_code, [(label, score, (x,y,w,h)), ...])."""
    request_id, version, tier_code, n = _RESULT.unpack_from(payload, 0)
    off = _RESULT.size
    if len(payload) != off + n * _DET.size:
        raise ValueError(
            f"RESULT body of {len(payload) - off} bytes != {n} detections"
        )
    dets = []
    for _ in range(n):
        label, score, x, y, w, h = _DET.unpack_from(payload, off)
        off += _DET.size
        dets.append((label, score, (x, y, w, h)))
    return request_id, version, tier_code, dets


def pack_status_request() -> bytes:
    return encode_frame(STATUS)


def pack_status(status: dict) -> bytes:
    import json

    return encode_frame(STATUS, json.dumps(status).encode("utf-8"))


def parse_status(payload: bytes) -> dict | None:
    """None for the empty request form, the status dict for a response."""
    import json

    if not payload:
        return None
    return json.loads(payload.decode("utf-8"))
