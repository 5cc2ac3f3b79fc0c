"""Row payload codec: the bytes inside DISPATCH/UPDATE frames (DESIGN.md §14).

A port of ``repro/core/transport/codec.py`` (pure NumPy; the port never
imports the JAX package): the same row gives the same bytes in both
packages, so a schedule recorded against either replays through the
port's engine. A dense row is copied once into its payload (the
reference copies it three times).

Four codecs, selected by ``FedConfig.wire_codec``:

    dense   — the full row as raw little-endian bytes in its own dtype.
              Lossless: encode -> decode is bit-identical, which is what
              lets a recorded dense wire run replay bit-for-bit.
    quant8  — the paper's 4x uplink cut finally carrying real wire bytes:
              the **delta** vs the dispatch row, int8-quantized with one
              f32 scale per ``block`` elements (symmetric, the
              `core.compression` / quant8-aggregator scheme). Deltas, not
              rows: a trained row's quantization step would be set by the
              weight magnitudes and destroy the (lr-sized) update signal;
              the delta's step is set by the update itself.
    quant4  — the DESIGN.md §15 frontier on the wire: the delta with one
              f32 scale per block and values in [-7, 7], packed two
              two's-complement nibbles per byte (~8x under dense).
              Nearest rounding: the wire has no shared per-round key, and
              a deterministic codec is what replay pins against.
    topk    — sparse delta: a selection bitmap (the top ceil(frac * n)
              magnitudes) + int8-quantized selected values. At frac = 0.1
              the payload is ~0.23 bytes/element — >4x under quant8.

All arithmetic is NumPy in float32 — deterministic across processes, so
the replay harness reproduces a worker's encoded bytes exactly by running
the same codec on the same trained row. The 4-bit/sparse primitives are
pinned bit-for-bit against the `kernels.ref` oracles.

Payload layout (after the 1-byte codec tag):

    dense:  u8 dtype code, u32 n, raw bytes
    quant8: u32 n, u32 block, ceil(n/block) f32 scales, n int8 values
    quant4: u32 n, u32 block, ceil(n/block) f32 scales, ceil(n/2) nibble bytes
    topk:   u32 n, u32 block, ceil(n/8) bitmap, ceil(k/block) f32 scales,
            k int8 values (k = popcount(bitmap); values in bitmap order)
"""
from __future__ import annotations

import struct

import numpy as np

DENSE = 0
QUANT8 = 1
QUANT4 = 2
TOPK = 3

CODECS = {"dense": DENSE, "quant8": QUANT8, "quant4": QUANT4, "topk": TOPK}
CODEC_NAMES = {v: k for k, v in CODECS.items()}

TOPK_FRAC = 0.1  # wire-codec upload fraction (the aggregator-side knob is
# FedConfig.topk_frac; the codec keeps one fixed ratio so both endpoints
# frame identically without negotiating)

_DTYPES = {0: np.float32, 1: np.float16, 2: np.float64}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_DENSE_HDR = struct.Struct("!BI")
_QUANT_HDR = struct.Struct("!II")


def _as_row(x) -> np.ndarray:
    row = np.asarray(x)
    if row.ndim != 1:
        raise ValueError(f"codec rows are 1-D packed rows, got shape {row.shape}")
    return row


# -- dense -------------------------------------------------------------------

def dense_parts(row) -> tuple[bytes, memoryview]:
    """The dense payload as (tag + header, the row's bytes): the bytes are
    the row's own memory where it is little-endian and contiguous already,
    so a sender writes them without a copy (``wire.send_frame``)."""
    row = _as_row(row)
    if row.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported row dtype {row.dtype}")
    hdr = _DENSE_HDR.pack(_DTYPE_CODES[row.dtype], row.size)
    data = np.ascontiguousarray(row, row.dtype.newbyteorder("<"))
    return bytes([DENSE]) + hdr, memoryview(data).cast("B")


def encode_dense(row) -> bytes:
    return b"".join(dense_parts(row))


def _dense_view(buf) -> np.ndarray:
    """The row of a dense payload (tag stripped) as a read-only view of
    ``buf``, in its little-endian dtype: no copy."""
    code, n = _DENSE_HDR.unpack_from(buf, 0)
    if code not in _DTYPES:
        raise ValueError(f"unknown dtype code {code}")
    dt = np.dtype(_DTYPES[code]).newbyteorder("<")
    if len(buf) - _DENSE_HDR.size != n * dt.itemsize:
        raise ValueError(f"dense payload of {len(buf) - _DENSE_HDR.size} bytes != "
                         f"{n} x {dt.itemsize}")
    return np.frombuffer(buf, dt, count=n, offset=_DENSE_HDR.size)


def _decode_dense(buf: bytes) -> np.ndarray:
    view = _dense_view(buf)
    return view.astype(view.dtype.newbyteorder("="))


# -- quant8 ------------------------------------------------------------------

def quantize_blocks(x: np.ndarray, block: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric blockwise int8: one f32 scale per `block` elements
    (amax/127, floored so an all-zero block stays exactly zero)."""
    if block < 1:
        raise ValueError(f"quant block must be >= 1, got {block}")
    x = np.asarray(x, np.float32)
    n = x.size
    nb = -(-n // block)
    padded = np.zeros(nb * block, np.float32)
    padded[:n] = x
    x2 = padded.reshape(nb, block)
    scale = (np.maximum(np.abs(x2).max(axis=1), 1e-12) / np.float32(127.0)).astype(
        np.float32
    )
    q = np.clip(np.rint(x2 / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def dequantize_blocks(q: np.ndarray, scale: np.ndarray, n: int) -> np.ndarray:
    return (q.astype(np.float32) * scale[:, None].astype(np.float32)).reshape(-1)[:n]


def quant8_parts(row, block: int) -> tuple:
    """The quant8 payload as (tag + header, the scales, the int8 blocks),
    the blocks a view of the quantized array (no ``tobytes`` copy)."""
    row = _as_row(row)
    q, scale = quantize_blocks(row, block)
    hdr = _QUANT_HDR.pack(row.size, block)
    return bytes([QUANT8]) + hdr, scale.astype("<f4").tobytes(), memoryview(q).cast("B")


def encode_quant8(row, block: int) -> bytes:
    return b"".join(quant8_parts(row, block))


def quant8_views(buf) -> tuple[int, int, np.ndarray, np.ndarray]:
    """A quant8 payload (tag stripped) -> (n, block, the (nb,) f32 scales,
    the (nb, block) int8 blocks), the blocks a read-only view of ``buf``."""
    n, block = _QUANT_HDR.unpack_from(buf, 0)
    nb = -(-n // block)
    off = _QUANT_HDR.size
    scale = np.frombuffer(buf, "<f4", count=nb, offset=off).astype(np.float32)
    off += nb * 4
    if len(buf) != off + nb * block:
        raise ValueError("quant8 payload size mismatch")
    q = np.frombuffer(buf, np.int8, count=nb * block, offset=off).reshape(nb, block)
    return n, block, scale, q


def _decode_quant8(buf: bytes) -> np.ndarray:
    n, _, scale, q = quant8_views(buf)
    return dequantize_blocks(q, scale, n)


# -- quant4 ------------------------------------------------------------------

def quantize4_blocks(x: np.ndarray, block: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric blockwise 4-bit (nearest): one f32 scale per `block`
    elements, amax/7 — the wire twin of `kernels.ref.quant4_blocks_np`."""
    if block < 1:
        raise ValueError(f"quant block must be >= 1, got {block}")
    x = np.asarray(x, np.float32)
    n = x.size
    nb = -(-n // block)
    padded = np.zeros(nb * block, np.float32)
    padded[:n] = x
    x2 = padded.reshape(nb, block)
    scale = (np.maximum(np.abs(x2).max(axis=1), 1e-12) / np.float32(7.0)).astype(np.float32)
    q = np.clip(np.rint(x2 / scale[:, None]), -7, 7).astype(np.int8)
    return q, scale


def pack_nibbles(q: np.ndarray) -> bytes:
    """int8 values in [-8, 7] -> two two's-complement nibbles per byte."""
    u = np.asarray(q, np.int8).reshape(-1).astype(np.uint8) & np.uint8(0xF)
    if len(u) % 2:
        u = np.append(u, np.uint8(0))
    return (u[0::2] | (u[1::2] << np.uint8(4))).astype(np.uint8).tobytes()


def unpack_nibbles(buf: bytes, n: int) -> np.ndarray:
    """Inverse of `pack_nibbles`: first n sign-extended int8 values."""
    b = np.frombuffer(buf, np.uint8)
    u = np.empty(len(b) * 2, np.uint8)
    u[0::2] = b & np.uint8(0xF)
    u[1::2] = b >> np.uint8(4)
    return ((u[:n].astype(np.int16) ^ 8) - 8).astype(np.int8)


def encode_quant4(row, block: int) -> bytes:
    row = _as_row(row)
    q, scale = quantize4_blocks(row, block)
    hdr = _QUANT_HDR.pack(row.size, block)
    return bytes([QUANT4]) + hdr + scale.astype("<f4").tobytes() + pack_nibbles(q)


def _decode_quant4(buf: bytes) -> np.ndarray:
    n, block = _QUANT_HDR.unpack_from(buf, 0)
    nb = -(-n // block)
    off = _QUANT_HDR.size
    scale = np.frombuffer(buf, "<f4", count=nb, offset=off).astype(np.float32)
    off += nb * 4
    nbytes = -(-(nb * block) // 2)
    if len(buf) != off + nbytes:
        raise ValueError("quant4 payload size mismatch")
    q = unpack_nibbles(buf[off:], nb * block).reshape(nb, block)
    return dequantize_blocks(q, scale, n)


# -- topk (sparse delta) -----------------------------------------------------

def topk_indices(delta: np.ndarray, frac: float = TOPK_FRAC) -> np.ndarray:
    """Sorted indices of the ceil(frac * n) largest-|value| entries.
    Deterministic tie-break (last index wins via argpartition on (|v|, i))."""
    delta = np.asarray(delta, np.float32)
    n = delta.size
    k = max(1, min(n, int(-(-frac * n // 1))))
    idx = np.argpartition(np.abs(delta), n - k)[n - k:]
    return np.sort(idx)


def encode_topk(delta, block: int, frac: float = TOPK_FRAC) -> bytes:
    """Bitmap of the selected positions + int8-quantized selected values
    (quantized as a dense k-vector, one scale per `block` of it)."""
    delta = _as_row(np.asarray(delta, np.float32))
    n = delta.size
    idx = topk_indices(delta, frac)
    bitmap = np.zeros(n, np.uint8)
    bitmap[idx] = 1
    q, scale = quantize_blocks(delta[idx], block)
    hdr = _QUANT_HDR.pack(n, block)
    return (
        bytes([TOPK])
        + hdr
        + np.packbits(bitmap).tobytes()
        + scale.astype("<f4").tobytes()
        + q.reshape(-1)[: idx.size].tobytes()
    )


def _decode_topk(buf: bytes) -> np.ndarray:
    n, block = _QUANT_HDR.unpack_from(buf, 0)
    off = _QUANT_HDR.size
    nbm = -(-n // 8)
    bitmap = np.unpackbits(np.frombuffer(buf, np.uint8, count=nbm, offset=off))[:n]
    off += nbm
    k = int(bitmap.sum())
    nb = -(-k // block)
    scale = np.frombuffer(buf, "<f4", count=nb, offset=off).astype(np.float32)
    off += nb * 4
    if len(buf) != off + k:
        raise ValueError("topk payload size mismatch")
    qv = np.frombuffer(buf, np.int8, count=k, offset=off)
    qp = np.zeros(nb * block, np.int8)
    qp[:k] = qv
    vals = dequantize_blocks(qp.reshape(nb, block), scale, k)
    delta = np.zeros(n, np.float32)
    delta[bitmap.astype(bool)] = vals
    return delta


# -- update/dispatch payloads ------------------------------------------------

def encode_row(row, codec: str = "dense", block: int = 1024) -> bytes:
    """DISPATCH payload: dense always (downlink is not the FL bottleneck —
    FedVision's asymmetry is camera uplink — and a lossless dispatch keeps
    the worker training on exactly the server's row)."""
    if codec not in CODECS:
        raise ValueError(f"unknown wire codec {codec!r}; expected {sorted(CODECS)}")
    return encode_dense(row)


def row_parts(row, codec: str = "dense") -> tuple:
    """:func:`encode_row`'s payload as parts (:func:`dense_parts`)."""
    if codec not in CODECS:
        raise ValueError(f"unknown wire codec {codec!r}; expected {sorted(CODECS)}")
    return dense_parts(row)


def row_view(buf) -> np.ndarray:
    """:func:`decode_row` without a copy where the payload is dense: a
    read-only view of ``buf`` (a ``memoryview`` of the frame keeps it so)."""
    if buf and buf[0] == DENSE:
        return _dense_view(memoryview(buf)[1:])
    return decode_row(buf)


def decode_row(buf: bytes) -> np.ndarray:
    if not buf:
        raise ValueError("empty row payload")
    tag = buf[0]
    if tag == DENSE:
        return _decode_dense(buf[1:])
    if tag == QUANT8:
        return _decode_quant8(buf[1:])
    if tag == QUANT4:
        return _decode_quant4(buf[1:])
    if tag == TOPK:
        return _decode_topk(buf[1:])
    raise ValueError(f"unknown codec tag {tag}")


def encode_update(row_new, row_base, codec: str = "dense", block: int = 1024) -> bytes:
    """UPDATE payload: the trained row (dense) or its int8 delta (quant8)."""
    if codec == "dense":
        return encode_dense(row_new)
    if codec in ("quant8", "quant4", "topk"):
        delta = np.asarray(row_new, np.float32) - np.asarray(row_base, np.float32)
        if codec == "quant8":
            return encode_quant8(delta, block)
        if codec == "quant4":
            return encode_quant4(delta, block)
        return encode_topk(delta, block)
    raise ValueError(f"unknown wire codec {codec!r}; expected {sorted(CODECS)}")


def update_parts(row_new, row_base, codec: str = "dense", block: int = 1024) -> tuple:
    """:func:`encode_update`'s payload as parts: dense and quant8 without
    joining the row's bytes (:func:`dense_parts`, :func:`quant8_parts`)."""
    if codec == "dense":
        return dense_parts(row_new)
    if codec == "quant8":
        return quant8_parts(np.asarray(row_new, np.float32) - np.asarray(row_base, np.float32),
                            block)
    return (encode_update(row_new, row_base, codec, block),)


def decode_update(buf: bytes, row_base) -> np.ndarray:
    """Inverse of `encode_update`: quant8 payloads land as
    base + dequant(delta); dense payloads are the row itself."""
    if not buf:
        raise ValueError("empty update payload")
    if buf[0] == DENSE:
        return _decode_dense(buf[1:])
    if buf[0] == QUANT8:
        return np.asarray(row_base, np.float32) + _decode_quant8(buf[1:])
    if buf[0] == QUANT4:
        return np.asarray(row_base, np.float32) + _decode_quant4(buf[1:])
    if buf[0] == TOPK:
        return np.asarray(row_base, np.float32) + _decode_topk(buf[1:])
    raise ValueError(f"unknown codec tag {buf[0]}")


def payload_bytes(n: int, codec: str, block: int = 1024, itemsize: int = 4) -> int:
    """Analytic payload size (the BENCH payload-bytes rows)."""
    if codec == "dense":
        return 1 + _DENSE_HDR.size + n * itemsize
    if codec == "quant8":
        nb = -(-n // block)
        return 1 + _QUANT_HDR.size + nb * 4 + nb * block
    if codec == "quant4":
        nb = -(-n // block)
        return 1 + _QUANT_HDR.size + nb * 4 + -(-(nb * block) // 2)
    if codec == "topk":
        k = max(1, min(n, int(-(-TOPK_FRAC * n // 1))))
        nb = -(-k // block)
        return 1 + _QUANT_HDR.size + -(-n // 8) + nb * 4 + k
    raise ValueError(f"unknown wire codec {codec!r}")
