"""Federated round configuration (port of ``repro/core/rounds.py::FedConfig``).

Only the dataclass is ported so far, with every field of the reference so
later slices extend it in place; the serving plane reads its ``serve_*``
fields. The round machinery (``make_state``, the flat round, participation)
belongs to the training slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FedConfig:
    n_clients: int
    local_steps: int = 1
    aggregation: str = "eq6"  # any name in repro.core.aggregators.names()
    topn: int = 8  # Eq. 6 / static_topn upload budget (layer buckets)
    client_axis: str = "pod"  # mesh axis acting as the federation
    data_axis: str | None = "data"  # within-client data-parallel axis
    round_idx_static: int = 0  # static_topn: trace-time round phase
    microbatches: int = 1  # grad-accumulation splits of each local step
    agg_impl: str = "ref"  # ref (plain torch) | kernel (aggregation slice)
    quant_block: int = 1024  # quant8: elements per int8 scale block
    server_lr: float = 1.0  # fedavgm/fedadam server step (fedadam wants ~0.01-0.1)
    server_momentum: float = 0.9  # fedavgm momentum / fedadam b1
    server_beta2: float = 0.99  # fedadam second-moment decay
    server_eps: float = 1e-3  # fedadam adaptivity floor (Reddi et al. tau)
    trim_ratio: float = 0.25  # trimmed_mean: fraction trimmed per side (>=1 client)
    participation: str = "full"  # full | masked | compact (DESIGN.md §8)
    max_participants: int = 0  # compact: static per-round budget K (0 -> C)
    state_layout: str = "flat"  # flat (packed (C,N) round state) | tree (legacy reference)
    mode: str = "sync"  # sync | async (buffered FedBuff-style engine, DESIGN.md §12)
    buffer_size: int = 0  # async: K_buf staged updates per flush (0 -> n_clients)
    staleness_alpha: float = 0.5  # async: polynomial staleness discount (1+s)^-alpha
    max_staleness: int = 0  # async: drop updates staler than this (0 -> keep all)
    group_size: int = 0  # hier: edge-group width G (DESIGN.md §13; 0 -> C, one group)
    hier_base: str = "dense"  # hier: the registered reducer composed over group rows
    stream: bool = False  # async: streaming O(buffer_size*N) flush (DESIGN.md §13)
    # --- communication frontier (DESIGN.md §15) ---
    topk_frac: float = 0.1  # topk_ef: uploaded fraction k/N of each client delta
    topk_quant: str = "none"  # topk_ef: quantize the selected values (none | quant4)
    quant4_mode: str = "stochastic"  # quant4: stochastic | nearest | skip (dense passthrough)
    quant4_seed: int = 0  # quant4/topk_ef: session seed of the per-round counter PRNG
    secure_domain: str = "int8"  # secure: shared-scale integer ring width (int8 | int4)
    secure_mask: bool = True  # secure: pairwise masks on (False -> plain integer sum)
    secure_session: int = 0  # secure: session key feeding the per-round mask PRNG
    # --- multi-process transport (DESIGN.md §14) ---
    transport: str = "inproc"  # inproc (SimClock event heap) | socket (real wire)
    wire_codec: str = "dense"  # dense | quant8 | quant4 | topk (see transport/codec.py)
    queue_cap: int = 0  # socket: bounded landing-queue depth (0 -> 2 * n_clients)
    heartbeat_s: float = 0.2  # socket: worker heartbeat period (wall seconds)
    heartbeat_timeout_s: float = 2.0  # socket: silence beyond this marks a client dead
    # --- serving plane (DESIGN.md §17) ---
    serve_batch: int = 8  # inference batch slots of the jitted decode+NMS program
    serve_max_wait_s: float = 0.004  # batcher linger: how long a formed batch waits to fill
    serve_max_detections: int = 16  # NMS output slots per served image
    serve_soft_stale_rounds: int = 2  # freshness: rounds-behind beyond this -> soft_stale
    serve_hard_stale_rounds: int = 8  # freshness: rounds-behind beyond this -> hard_stale
    serve_soft_stale_s: float = 60.0  # freshness: seconds-behind beyond this -> soft_stale
    serve_hard_stale_s: float = 600.0  # freshness: seconds-behind beyond this -> hard_stale
