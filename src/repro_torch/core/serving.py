"""Serving plane for the trained detector (port of ``repro/core/serving.py``).

Concurrent INFER requests are batched into a fixed ``FedConfig.serve_batch``
slot batch (zero-padded) and every batch runs one cached detection program
(:func:`detection_program`: ``detection.decode_predictions`` under
``torch.inference_mode``, NMS on the CUDA kernel on the card). Per-slot
decode is a function of that slot alone, so a request's detections are
bit-identical at any batch occupancy (the padded-batch pin).

A :class:`ModelSlot` atomically publishes ``(round_version, model,
published_t)``; the batcher takes one snapshot per batch, so a swap is "the
next batch serves the new version" and no request is dropped by it. Every
RESULT carries the version it was served from and the freshness tier that
:func:`freshness_tier` evaluates (the STATUS frame goes through the same
:func:`model_status`).

The wire is ``core/transport/wire.py``'s CRC-framed INFER/RESULT/STATUS,
byte-compatible with the reference, so the reference's ``InferenceClient``
talks to this service. :func:`publish_from_engine` publishes an async
engine's landed global at its version through :func:`unpack_global`.
"""
from __future__ import annotations

import dataclasses
import functools
import queue
import socket
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core import detection
from repro_torch.core import rounds as R
from repro_torch.core.transport import wire

# -- freshness tiers (the Anti-Coin-style status model) ----------------------

FRESH, SOFT_STALE, HARD_STALE = "fresh", "soft_stale", "hard_stale"
TIER_CODES = {FRESH: 0, SOFT_STALE: 1, HARD_STALE: 2}
TIER_NAMES = {v: k for k, v in TIER_CODES.items()}


def freshness_tier(rounds_behind: int, seconds_behind: float, fed: R.FedConfig) -> str:
    """THE status evaluator — the STATUS frame and the health report both
    come from this one function, so they can never disagree.

    A model is ``soft_stale`` (serve, but warn) once it is strictly more
    than ``serve_soft_stale_rounds`` landed rounds OR
    ``serve_soft_stale_s`` wall seconds behind; ``hard_stale`` (degraded:
    still served, loudly flagged) past the hard thresholds. Exactly-at-
    threshold is the lower tier — `tests/test_serving.py` pins the
    boundaries."""
    if (rounds_behind > fed.serve_hard_stale_rounds
            or seconds_behind > fed.serve_hard_stale_s):
        return HARD_STALE
    if (rounds_behind > fed.serve_soft_stale_rounds
            or seconds_behind > fed.serve_soft_stale_s):
        return SOFT_STALE
    return FRESH


def model_status(slot: "ModelSlot", latest_version: int, now: float,
                 fed: R.FedConfig, stats: "ServeStats | None" = None) -> dict:
    """The serving health report: version lineage + freshness tier (+ the
    service's operational counters when given). JSON-able — this dict IS
    the STATUS frame payload."""
    pub = slot.snapshot()
    rounds_behind = max(0, int(latest_version) - pub.version)
    seconds_behind = max(0.0, float(now) - pub.published_t)
    tier = freshness_tier(rounds_behind, seconds_behind, fed)
    out = {
        "version": pub.version,
        "latest_version": int(latest_version),
        "rounds_behind": rounds_behind,
        "seconds_behind": seconds_behind,
        "tier": tier,
        "degraded": tier == HARD_STALE,
        "swaps": slot.swaps,
    }
    if stats is not None:
        out.update(stats.as_dict())
    return out


# -- the hot-swap slot -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PublishedModel:
    """One atomic publication: the model, the landed round version it came
    from, and when it was published (the freshness clock's anchor)."""

    version: int
    params: Any  # the published FedYOLOv3 module, on the service's device
    published_t: float


class ModelSlot:
    """Atomic publish/snapshot of ``(round_version, params)``.

    Training and serving share one live state through this slot: the
    training side calls :meth:`publish` as rounds land, the batcher calls
    :meth:`snapshot` once per batch. Publish is version-monotonic — a
    publisher racing an already-landed newer round is refused (returns
    False, counted in ``stale_publishes``) so the served model can never
    move backwards.

    ``clock`` is anything with ``.now()`` (a `SimClock` in tests — the
    controlled freshness transitions); None means host monotonic time.
    """

    def __init__(self, clock=None):
        self._lock = threading.Lock()
        self._clock = clock
        self._published: PublishedModel | None = None
        self.swaps = 0  # successful publishes (the first one included)
        self.stale_publishes = 0  # refused version regressions

    def now(self) -> float:
        return self._clock.now() if self._clock is not None else time.monotonic()

    def publish(self, version: int, params: Any, t: float | None = None) -> bool:
        pub = PublishedModel(int(version), params,
                             self.now() if t is None else float(t))
        with self._lock:
            if self._published is not None and pub.version < self._published.version:
                self.stale_publishes += 1
                return False
            self._published = pub
            self.swaps += 1
        return True

    def snapshot(self) -> PublishedModel:
        with self._lock:
            if self._published is None:
                raise RuntimeError("ModelSlot is empty: nothing published yet")
            return self._published

    @property
    def empty(self) -> bool:
        with self._lock:
            return self._published is None


def unpack_global(cfg, fed: R.FedConfig, row: torch.Tensor,
                  device: str | torch.device | None = None):
    """(N_total,) packed global row -> the model the slot serves (a
    ``FedYOLOv3``, or an LM's param tree) on ``device`` (the row's when
    None): the pack/unpack edge ``server.global_params`` crosses. The model
    holds copies; it never aliases ``row``, which an engine rewrites in
    place at its next landing or flush."""
    return R.global_model(cfg, row, row.device if device is None else device)


def publish_from_engine(slot: ModelSlot, engine, cfg, *, t: float | None = None) -> bool:
    """Publish the engine's landed global at its landed round version.

    Reads ``engine.global_packed_row()`` (a copy of each engine's current
    global; the arrival engine keeps its own because its buffer rows change
    on every landing), never a row of ``state["params"]``, which mid-window
    may hold a client's next trained update: the served version is the
    engine's landed round version by construction, and the published
    params stay as they are through later landings and flushes."""
    return slot.publish(engine.version, unpack_global(cfg, engine.fed, engine.global_packed_row()),
                        t=t)


# -- the detection program cache ---------------------------------------------

@functools.lru_cache(maxsize=16)
def detection_program(cfg, max_detections: int, device: str | torch.device = "cuda") -> Callable:
    """One cached decode+NMS callable per (cfg, max_detections, device):
    ``program(model, images (B, H, W, 3)) -> dict of tensors on the device``,
    the images copied to the device first where they are not there yet.
    Every batch the service runs goes through it."""
    dev = D.resolve(device)

    def program(model, images: torch.Tensor) -> dict[str, torch.Tensor]:
        with torch.inference_mode():
            return detection.decode_predictions(
                cfg, model, images.to(dev), max_detections=max_detections
            )

    return program


def to_host(pred: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Program output -> NumPy, with one device sync for all four arrays."""
    host = {k: v.to("cpu", non_blocking=True) for k, v in pred.items()}
    if any(v.is_cuda for v in pred.values()):
        torch.cuda.current_stream().synchronize()
    return {k: v.numpy() for k, v in host.items()}


def decode_result(pred: dict, i: int) -> list[tuple[int, float, tuple]]:
    """Slot ``i`` of a program output -> the RESULT frame's detection list
    (kept slots only, score order preserved)."""
    valid = np.asarray(pred["valid"][i])
    cls = np.asarray(pred["cls"][i])
    scores = np.asarray(pred["scores"][i])
    boxes = np.asarray(pred["boxes"][i])
    return [
        (int(cls[k]), float(scores[k]), tuple(float(v) for v in boxes[k]))
        for k in np.nonzero(valid)[0]
    ]


# -- the service -------------------------------------------------------------

@dataclasses.dataclass
class ServeStats:
    """Operational counters (part of the STATUS payload)."""

    requests: int = 0  # INFER frames accepted into the batcher
    results: int = 0  # RESULT frames sent
    batches: int = 0  # detection program runs
    occupancy_sum: int = 0  # real (non-padding) slots across launches
    status_requests: int = 0
    protocol_errors: int = 0  # malformed INFER payloads (connection dropped)
    crc_errors: int = 0

    @property
    def in_flight(self) -> int:
        """Requests accepted but not yet answered; 0 once the service is
        quiescent — the hot-swap bench's zero-dropped-requests check."""
        return self.requests - self.results

    @property
    def avg_occupancy(self) -> float:
        return self.occupancy_sum / self.batches if self.batches else 0.0

    def as_dict(self) -> dict:
        return {
            "requests": self.requests,
            "results": self.results,
            "batches": self.batches,
            "avg_occupancy": round(self.avg_occupancy, 3),
            "in_flight": self.in_flight,
            "status_requests": self.status_requests,
            "protocol_errors": self.protocol_errors,
        }


class InferenceService:
    """Socket-served batched detection over the wire framing.

    Reader threads parse INFER frames and enqueue ``(conn, request_id,
    image)``; ONE batcher thread (the only device caller) collects up to
    ``fed.serve_batch`` requests per launch — the first request opens the
    batch, then the batcher lingers ``fed.serve_max_wait_s`` for the rest
    of the slots — zero-pads to the fixed batch, snapshots the `ModelSlot`
    once, runs the cached program, and answers each request with its
    slot's detections + the snapshot's round version + the freshness tier.
    STATUS frames are answered from the reader (they never touch the device)
    through the same :func:`model_status` evaluator.

    ``latest_version``: callable returning the newest landed training
    round (e.g. ``lambda: engine.version``) — what rounds-behind is
    measured against. None means the slot's own version (a serve-only
    restore: rounds_behind 0, freshness then decays on wall time alone).
    """

    def __init__(self, cfg, fed: R.FedConfig, slot: ModelSlot, *,
                 img_size: int, host: str = "127.0.0.1", port: int = 0,
                 latest_version: Callable[[], int] | None = None,
                 max_detections: int = 0, device: str | torch.device = "cuda"):
        if fed.serve_batch < 1:
            raise ValueError(f"serve_batch={fed.serve_batch} must be >= 1")
        self.cfg, self.fed, self.slot = cfg, fed, slot
        self.img_size = int(img_size)
        self.batch = fed.serve_batch
        self.max_wait_s = fed.serve_max_wait_s
        self.max_detections = int(max_detections) or fed.serve_max_detections
        self._latest_version = latest_version
        self.device = D.resolve(device)
        self._program = detection_program(cfg, self.max_detections, self.device)
        self.stats = ServeStats()
        self._stats_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self._send_locks: dict[int, threading.Lock] = {}
        self._stopping = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()[:2]
        self._threads: list[threading.Thread] = []
        self.error: Exception | None = None  # what stopped the batcher, if anything

    # -- status (the one evaluator) ------------------------------------------

    def latest_version(self) -> int:
        if self._latest_version is not None:
            return int(self._latest_version())
        return self.slot.snapshot().version

    def status(self) -> dict:
        return model_status(
            self.slot, self.latest_version(), self.slot.now(), self.fed, self.stats
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "InferenceService":
        if self.slot.empty:
            raise RuntimeError("publish a model into the ModelSlot before start()")
        accept = threading.Thread(target=self._accept_loop, name="serve-accept",
                                  daemon=True)
        batcher = threading.Thread(target=self._batch_loop, name="serve-batcher",
                                   daemon=True)
        self._threads = [accept, batcher]
        accept.start()
        batcher.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        try:
            # shutdown wakes the accept thread; close alone leaves it blocked
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=5.0)
        if self.error is not None:
            raise RuntimeError("the serving batcher failed") from self.error

    # -- reader side ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._send_locks[id(sock)] = threading.Lock()
            threading.Thread(target=self._reader, args=(sock,),
                             name="serve-reader", daemon=True).start()

    def _send(self, sock: socket.socket, frame: bytes) -> None:
        lock = self._send_locks.get(id(sock))
        try:
            if lock is None:
                sock.sendall(frame)
            else:
                with lock:
                    sock.sendall(frame)
        except OSError:
            pass  # consumer gone mid-send; its requests die with the socket

    def _reader(self, sock: socket.socket) -> None:
        parser = wire.FrameParser()
        while not self._stopping.is_set():
            try:
                data = sock.recv(1 << 16)
            except OSError:
                break
            if not data:
                break
            try:
                frames = parser.feed(data)
            except ValueError:
                break  # structurally corrupt stream: drop the connection
            if parser.crc_errors:
                with self._stats_lock:
                    self.stats.crc_errors += parser.crc_errors
                break  # poisoned stream (same discipline as the WireServer)
            for ftype, payload in frames:
                if ftype == wire.INFER:
                    try:
                        rid, img = wire.parse_infer(payload)
                    except ValueError:
                        with self._stats_lock:
                            self.stats.protocol_errors += 1
                        sock.close()
                        return
                    if img.shape[:2] != (self.img_size, self.img_size):
                        # shape negotiation happens via STATUS; a wrong-size
                        # image is a protocol error, not a resize request
                        with self._stats_lock:
                            self.stats.protocol_errors += 1
                        sock.close()
                        return
                    with self._stats_lock:
                        self.stats.requests += 1
                    self._q.put((sock, rid, img))
                elif ftype == wire.STATUS:
                    with self._stats_lock:
                        self.stats.status_requests += 1
                    self._send(sock, wire.pack_status(self.status()))
                # anything else on a serving socket is ignored (the federation
                # frame types belong to the WireServer's port)

    # -- batcher (the only device caller) ---------------------------------------

    def _batch_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            items = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(items) < self.batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    items.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            try:
                self._run_batch(items)
            except Exception as e:  # noqa: BLE001 — no fallback: fail the service loudly
                self.error = e
                for sock, _, _ in items:  # its waiting clients see a closed connection
                    try:
                        sock.shutdown(socket.SHUT_RDWR)  # wakes the reader blocked in recv
                    except OSError:
                        pass
                    sock.close()
                self._stopping.set()
                return

    def _run_batch(self, items: list) -> None:
        # ONE slot snapshot per batch: the whole batch — and every RESULT in
        # it — is served from a single (version, params) pair; a concurrent
        # publish simply lands in the next batch. This is the entire
        # hot-swap protocol: no lock spans the program, no request can drop.
        pub = self.slot.snapshot()
        s = self.img_size
        imgs = np.zeros((self.batch, s, s, 3), np.float32)
        for i, (_, _, img) in enumerate(items):
            imgs[i] = img
        # one host->device copy of the padded batch, one sync to pull the
        # four outputs back
        pred = to_host(self._program(pub.params, torch.from_numpy(imgs)))
        tier = freshness_tier(
            max(0, self.latest_version() - pub.version),
            max(0.0, self.slot.now() - pub.published_t),
            self.fed,
        )
        # Count the results BEFORE sending them: a client that has received
        # its RESULT must never observe in_flight > 0 for that request, so
        # the quiesce check (in_flight == 0 once every response arrived) is
        # race-free for any outside observer.
        with self._stats_lock:
            self.stats.batches += 1
            self.stats.occupancy_sum += len(items)
            self.stats.results += len(items)
        for i, (sock, rid, _) in enumerate(items):
            self._send(sock, wire.pack_result(
                rid, pub.version, TIER_CODES[tier], decode_result(pred, i)
            ))


# -- the consumer half -------------------------------------------------------

@dataclasses.dataclass
class ServeResult:
    """One RESULT frame, decoded."""

    request_id: int
    version: int  # the landed training round the model was published from
    tier: str  # freshness tier the server evaluated at serve time
    detections: list  # [(label, score, (x, y, w, h)), ...] score-descending


class InferenceClient:
    """One consumer connection: framed INFER/STATUS out, RESULT/STATUS in.

    `infer` is the blocking request/response form; `send_infer` +
    `recv_result` pipeline many requests over one connection (match
    responses by ``request_id`` — the batcher preserves per-connection
    order, but don't lean on it)."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._parser = wire.FrameParser()
        self._frames: list = []
        self._next_id = 0

    def _recv_frame(self):
        while not self._frames:
            data = self.sock.recv(1 << 16)
            if not data:
                raise ConnectionError("serving connection closed")
            self._frames.extend(self._parser.feed(data))
            if self._parser.crc_errors:
                raise ConnectionError("serving stream CRC-poisoned")
        return self._frames.pop(0)

    def send_infer(self, image) -> int:
        rid = self._next_id
        self._next_id += 1
        self.sock.sendall(wire.pack_infer(rid, image))
        return rid

    def recv_result(self) -> ServeResult:
        while True:
            ftype, payload = self._recv_frame()
            if ftype == wire.RESULT:
                rid, version, tier_code, dets = wire.parse_result(payload)
                return ServeResult(rid, version, TIER_NAMES[tier_code], dets)

    def infer(self, image) -> ServeResult:
        rid = self.send_infer(image)
        res = self.recv_result()
        if res.request_id != rid:
            raise ConnectionError(
                f"response {res.request_id} does not match request {rid}"
            )
        return res

    def status(self) -> dict:
        self.sock.sendall(wire.pack_status_request())
        while True:
            ftype, payload = self._recv_frame()
            if ftype == wire.STATUS:
                return wire.parse_status(payload)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self) -> "InferenceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
