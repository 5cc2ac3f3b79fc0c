"""Packed-buffer transport for the aggregation engine (port of
``repro/core/packing.py``, the parts the flat round runs).

The packed ``(C, N_total)`` buffer is the round state of the flat engine:
row c holds client c's parameters, leaf after leaf in the reference's
flattening order (``heads``, ``stages``, ``stem`` for fedyolov3) and each
leaf in its HWIO element order, so a row of the port's buffer equals a row
of the reference's ``state["params"]`` element for element. Clients train
on per-leaf views of their row (:func:`unpack_views`) and the optimizer
writes back in place; :func:`pack` and :func:`unpack` survive only at the
edges (initial state, weight carry-over).

Layer buckets come from ``compression.leaf_layer_ids``: each slot spans a
contiguous range of Eq. 6 score buckets, kept slot-wise (offset + bucket
count per leaf); the explicit ``(N,)`` id vector (:func:`bucket_ids`) is
materialized only for the K1 kernel.

:func:`masked_bucket_mean` is the one masked/weighted reduction of the
dense, eq6 and static_topn rounds: ``impl="kernel"`` runs K1
(``kernels.pack.packed_bucket_reduce``), ``impl="ref"`` the reference's
folded-weight multiply-add chain over :func:`merged_runs` in plain torch.
The reference's ``bucket_tile_bound`` sizes a TPU kernel's bucket window;
the CUDA kernel gathers each element's weight directly and needs no bound.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import compression as comp
from repro_torch.models.params import (PROD_AXIS_SIZES, Spec, flatten_with_paths, spec_for,
                                       unflatten)

PyTree = Any

# clients beyond this reduce through one contraction instead of a
# multiply-add chain unrolled per client (the reference's cutover)
CHAIN_MAX_CLIENTS = 64


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    name: str  # the leaf's key path (``stages/0/down``)
    shape: tuple[int, ...]  # per-client leaf shape (no leading C)
    offset: int  # element offset into the packed buffer
    size: int  # number of elements
    bucket_off: int  # first Eq. 6 score bucket this slot touches
    n_buckets: int  # contiguous buckets spanned (layers, or 1 for misc)

    @property
    def per_bucket(self) -> int:
        return self.size // self.n_buckets


@dataclasses.dataclass(frozen=True)
class PackSpec:
    n_total: int
    n_buckets: int  # total score buckets (cfg.n_layers + 1)
    slots: tuple[LeafSlot, ...]


def build_pack_spec(cfg, template: PyTree) -> PackSpec:
    """Flatten the param template into slot metadata."""
    slots: list[LeafSlot] = []
    off = 0
    for path, info in flatten_with_paths(template):
        size = max(math.prod(info.shape), 1)
        kind, boff = comp.leaf_layer_ids(path, info, cfg)
        if kind == "stack2":
            nb = info.shape[0] * info.shape[1]
        elif kind == "stack1":
            nb = info.shape[0]
        else:
            nb = 1
        slots.append(LeafSlot(path, tuple(info.shape), off, size, boff, nb))
        off += size
    return PackSpec(off, comp.n_score_buckets(cfg), tuple(slots))


def mesh_axis_size(mesh, axis: str) -> int:
    """Size of the ``torch.distributed`` ``DeviceMesh`` dim named ``axis``
    (1 without a mesh or without such a dim)."""
    names = () if mesh is None else (mesh.mesh_dim_names or ())
    return mesh.size(names.index(axis)) if axis in names else 1


def packed_pspec(n_clients: int, client_axis: str, mesh=None) -> slice:
    """The torch meaning of the reference's ``packed_pspec``: the rows of the
    (C, N_total) buffer (and of every moment buffer) this rank owns. The
    client axis splits C into contiguous blocks of C/S rows, block r on the
    rank at coordinate r; the flat dim stays whole on every rank."""
    if mesh_axis_size(mesh, "model") > 1:
        raise NotImplementedError("a 'model' mesh axis larger than 1 (the flat dim sharded "
                                  "over ranks, FSDP-style) is slice 8")
    S = mesh_axis_size(mesh, client_axis)
    if S == 1:
        return slice(0, n_clients)
    k = n_clients // S
    r = mesh.get_local_rank(client_axis)
    return slice(r * k, (r + 1) * k)


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    """The spec of a packed buffer sharded leaf by leaf: its leading dims
    by ``lead``, and in its flat dim the segment of each template leaf by
    that leaf's own spec (``segments``: one (leaf shape, spec) a leaf, in
    packing order). The port's packed moment buffers are the reference's
    moment trees laid end to end; this is their ``PartitionSpec`` tree."""

    lead: Spec
    segments: tuple

    @classmethod
    def of(cls, template: PyTree, lead: Spec, rules: dict | None = None,
           axis_sizes: dict | None = None) -> "SegmentSpec":
        return cls(lead, tuple((info.shape, spec_for(info, rules, axis_sizes))
                               for _, info in flatten_with_paths(template)))


def packed_spec(n_total: int, client_axis: str, axis_sizes: dict | None = None) -> Spec:
    """The reference's ``packed_pspec`` as a plan's spec (``models.params.Spec``)
    of the (C, N_total) buffer: the client dim on ``client_axis``, the flat
    dim on ``"model"`` where that axis exists and divides N_total, by the
    axis sizes of a launch plan (the production sizes by default)."""
    sizes = PROD_AXIS_SIZES if axis_sizes is None else axis_sizes
    if "model" in sizes and n_total % sizes["model"] == 0:
        return Spec(client_axis, "model")
    return Spec(client_axis, None)


@functools.lru_cache(maxsize=16)
def bucket_ids(spec: PackSpec) -> np.ndarray:
    """Explicit (N_total,) int32 bucket id per element (the K1 operand)."""
    return np.concatenate(
        [
            np.repeat(np.arange(s.n_buckets, dtype=np.int32) + s.bucket_off, s.per_bucket)
            for s in spec.slots
        ]
    )


@functools.lru_cache(maxsize=16)
def bucket_ids_on(spec: PackSpec, device: torch.device) -> torch.Tensor:
    """:func:`bucket_ids` as an int32 tensor on ``device``, built there once
    per process: a full-width LM has 1.7 G ids (6.9 GB), which a host build
    and copy took seconds over."""
    return torch.cat([
        (torch.arange(s.n_buckets, dtype=torch.int32, device=device) + s.bucket_off)
        .repeat_interleave(s.per_bucket)
        for s in spec.slots
    ])


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def pack(spec: PackSpec, stacked: PyTree, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Client-stacked tree of (C, *shape) tensors -> one (C, N_total) buffer.
    With dtype None the buffer takes the promoted dtype of all leaves."""
    leaves = [leaf for _, leaf in flatten_with_paths(stacked)]
    C = leaves[0].shape[0]
    if dtype is None:
        dtype = functools.reduce(torch.promote_types, (x.dtype for x in leaves))
    return torch.cat([x.reshape(C, -1).to(dtype) for x in leaves], dim=1)


def unpack(spec: PackSpec, packed: torch.Tensor, like: PyTree) -> PyTree:
    """(C, N_total) buffer -> a tree shaped like ``like`` of (C, *shape)
    copies, each cast to its ``like`` leaf's dtype where the leaf has one."""
    out = {}
    C = packed.shape[0]
    for s, (path, leaf) in zip(spec.slots, flatten_with_paths(like)):
        x = packed[:, s.offset: s.offset + s.size].reshape((C,) + s.shape)
        out[path] = x.to(getattr(leaf, "dtype", x.dtype), copy=True)
    return unflatten(like, out)


def unpack_views(spec: PackSpec, packed: torch.Tensor, like: PyTree) -> PyTree:
    """Per-leaf views of the packed buffer: ``packed[..., off:off+size]``
    reshaped to ``lead + shape``, where ``lead`` is whatever leading dims the
    buffer has (``(C,)`` for the round state, none for one client's row).
    No copy: writes through a view land in the buffer, and autograd hands a
    leaf's gradient back into the buffer's layout. ``like`` gives only the
    tree structure (a ParamInfo template or any matching tree). The views
    come from one ``split``, whose backward concatenates the leaves'
    gradients once (slicing per leaf would zero-fill a full-size gradient
    per leaf)."""
    lead = packed.shape[:-1]
    parts = torch.split(packed, [s.size for s in spec.slots], dim=-1)
    views = {s.name: part.view(lead + s.shape) for s, part in zip(spec.slots, parts)}
    return unflatten(like, {path: views[path] for path, _ in flatten_with_paths(like)})


def write_slots(spec: PackSpec, packed: torch.Tensor, stacked: PyTree) -> torch.Tensor:
    """Write client-stacked leaves into the packed buffer in place
    (``unpack_views``' inverse) and return the buffer."""
    C = packed.shape[0]
    for s, (_, leaf) in zip(spec.slots, flatten_with_paths(stacked)):
        packed[:, s.offset: s.offset + s.size].copy_(leaf.reshape(C, s.size))
    return packed


# ---------------------------------------------------------------------------
# reduction tiling: maximal merged runs of uniform-width buckets
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def merged_runs(spec: PackSpec) -> tuple[tuple[int, int, int, int], ...]:
    """Maximal contiguous (column, bucket) runs with one per-bucket width.

    Each run ``(col0, bucket0, n_buckets, per)`` satisfies
    ``bucket(col0 + i) == bucket0 + i // per``: adjacent slots merge when
    both their columns and their bucket ranges continue the run (same-shape
    misc tensors do not merge: they share one bucket)."""
    runs: list[tuple[int, int, int, int]] = []
    for s in spec.slots:
        if runs:
            col0, b0, nb, per = runs[-1]
            if (
                per == s.per_bucket
                and s.offset == col0 + nb * per
                and s.bucket_off == b0 + nb
            ):
                runs[-1] = (col0, b0, nb + s.n_buckets, per)
                continue
        runs.append((s.offset, s.bucket_off, s.n_buckets, s.per_bucket))
    return tuple(runs)


def expand_bucket_vec(spec: PackSpec, vec: torch.Tensor) -> torch.Tensor:
    """(..., n_buckets) bucket vector -> (..., N_total) per-element vector,
    one broadcast per merged run."""
    parts = []
    for (_, b0, nb, per) in merged_runs(spec):
        v = vec[..., b0: b0 + nb]
        parts.append(v[..., None].expand(v.shape + (per,)).reshape(v.shape[:-1] + (nb * per,)))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def bucket_sums(spec: PackSpec, packed: torch.Tensor) -> torch.Tensor:
    """Per-bucket signed element sums: (C, N_total) -> (C, n_buckets) f32
    (the Eq. 6 inner sums)."""
    C = packed.shape[0]
    out = torch.zeros((C, spec.n_buckets), dtype=torch.float32, device=packed.device)
    for s in spec.slots:
        x = packed[:, s.offset: s.offset + s.size].float()
        sums = x.reshape(C, s.n_buckets, s.per_bucket).sum(dim=-1)
        out[:, s.bucket_off: s.bucket_off + s.n_buckets] += sums
    return out


# ---------------------------------------------------------------------------
# the masked/weighted reductions every stacked mode lowers to
# ---------------------------------------------------------------------------

def weighted_mean(packed: torch.Tensor, weights: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Unmasked Eq. 5 over the flat buffer: (C, N), (C,) -> (N,) f32, the
    optional (C,) 0/1 participation mask dropping rows from numerator and
    denominator. The 1/sum(w) normalization is folded into the weights:
    one multiply-add chain over the clients (one contraction beyond
    CHAIN_MAX_CLIENTS)."""
    C = packed.shape[0]
    w = weights.float()
    if mask is not None:
        w = w * mask.float()
    wn = w / torch.clamp_min(torch.sum(w), 1e-12)
    if C > CHAIN_MAX_CLIENTS:
        return wn @ packed.float()
    acc = packed[0].float() * wn[0]
    for c in range(1, C):
        acc = acc + packed[c].float() * wn[c]
    return acc


def grouped_weighted_mean(packed: torch.Tensor, weights: torch.Tensor, group_size: int,
                          mask: torch.Tensor | None = None, *,
                          impl: str = "ref") -> tuple[torch.Tensor, torch.Tensor]:
    """Per-group renormalized Eq. 5, the hierarchical inner reduce.

    packed (C, N), weights (C,), C % group_size == 0 -> (rows (C/G, N) f32,
    den (C/G,) f32) with ``rows[g] = sum_i w[gG+i] x[gG+i] / den[g]`` and
    ``den[g] = sum_i w[gG+i]`` (mask folded in). A group nobody in took part
    has den 0 and a zero row; ``aggregators/hier.py`` masks it out of the
    outer reduce. The 1/den renormalization folds into the member weights.
    ``impl="kernel"`` runs K6 (``kernels.pack.grouped_reduce``);
    ``impl="ref"`` one multiply-add chain per group (one batched contraction
    beyond CHAIN_MAX_CLIENTS members).
    """
    C, N = packed.shape
    G = group_size
    if G < 1 or C % G:
        raise ValueError(f"group_size={G} must divide n_clients={C}")
    ngroups = C // G
    w = weights.float()
    if mask is not None:
        w = w * mask.float()
    wg = w.reshape(ngroups, G)
    den = torch.sum(wg, dim=1)  # (C/G,)
    wn = wg / torch.clamp_min(den, 1e-12)[:, None]
    if impl == "kernel":
        from repro_torch.kernels import pack as kpack

        return kpack.grouped_reduce(packed, wn.contiguous()), den
    if impl != "ref":
        raise ValueError(f"agg_impl={impl!r}; expected ref | kernel")
    xg = packed.float().reshape(ngroups, G, N)
    if G > CHAIN_MAX_CLIENTS:
        return torch.einsum("gi,gin->gn", wn, xg), den
    acc = xg[:, 0] * wn[:, 0][:, None]
    for i in range(1, G):
        acc = acc + xg[:, i] * wn[:, i][:, None]
    return acc, den


def masked_bucket_mean(
    packed: torch.Tensor,
    wmask: torch.Tensor,
    spec: PackSpec,
    mask: torch.Tensor | None = None,
    *,
    impl: str = "ref",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted mean over clients under a per-(client, bucket) mask.

    packed (C, N); wmask (C, B): participation weight times the 0/1 upload
    mask per score bucket; mask: optional (C,) 0/1 participation vector.
    Returns (global (N,) f32, den (B,) f32) with
    ``global[n] = sum_c mask[c] wmask[c, b(n)] x[c, n] / den[b(n)]`` and
    ``den[b] = sum_c mask[c] wmask[c, b]`` (0 where nobody uploaded).

    ``impl="kernel"``: K1 gives per-element (num, den) and the division
    takes a 1e-12 floor. ``impl="ref"``: 1/den folds into the per-bucket
    weights and one multiply-add chain runs per merged run.
    """
    C = packed.shape[0]
    wm = wmask.float()
    if mask is not None:
        wm = wm * mask.float()[:, None]
    den_b = torch.sum(wm, dim=0)  # (B,)
    if impl == "kernel":
        from repro_torch.kernels import pack as kpack

        ids = bucket_ids_on(spec, packed.device)
        num, den = kpack.packed_bucket_reduce(
            packed, wmask.float().contiguous(), ids,
            None if mask is None else mask.float().contiguous(),
        )
        # in place: at full width num and den are 6.9 GB each
        return num.div_(den.clamp_min_(1e-12)), den_b
    if impl != "ref":
        raise ValueError(f"agg_impl={impl!r}; expected ref | kernel")
    wn = wm / torch.clamp_min(den_b, 1e-12)[None, :]
    parts = []
    for (col0, b0, nb, per) in merged_runs(spec):
        xs = packed[:, col0: col0 + nb * per].float().reshape(C, nb, per)
        wt = wn[:, b0: b0 + nb]  # (C, nb)
        if C > CHAIN_MAX_CLIENTS:
            parts.append(torch.einsum("cb,cbp->bp", wt, xs).reshape(nb * per))
            continue
        acc = xs[0] * wt[0][:, None]
        for c in range(1, C):
            acc = acc + xs[c] * wt[c][:, None]
        parts.append(acc.reshape(nb * per))
    g = parts[0] if len(parts) == 1 else torch.cat(parts)
    return g, den_b


# ---------------------------------------------------------------------------
# quant8 transport: fused encode -> decode -> reduce (no int8 payload)
# ---------------------------------------------------------------------------

def quant_blocks(xb: torch.Tensor, q_max: float,
                 u: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., nb, block) f32 -> (q (..., nb, block) f32 holding integers in
    [-q_max, q_max], scale (..., nb) f32), symmetric per block with
    ``scale = max(amax, 1e-12) / q_max``. ``u`` None: nearest,
    ``clip(round(x/s))`` (half to even); else stochastic,
    ``clip(floor(x/s + u))``, clipped AFTER the floor (7 + u can round to
    8.0 in f32). Every op is one IEEE rounding, so the CUDA kernels
    (``kernels/csrc/quant_reduce.cu``, ``row_quant.cu``) reproduce it bit
    for bit."""
    amax = torch.amax(torch.abs(xb), dim=-1)
    scale = exact_div(torch.clamp_min(amax, 1e-12), q_max)
    v = xb / scale[..., None]
    q = torch.round(v) if u is None else torch.floor(v + u)
    return torch.clamp(q, -q_max, q_max), scale


def dequant_blocks(xb: torch.Tensor, q_max: float, u: torch.Tensor | None = None) -> torch.Tensor:
    """(..., nb, block) f32 -> dequant(quant(xb)) per block
    (:func:`quant_blocks`, then ``q * scale``)."""
    q, scale = quant_blocks(xb, q_max, u)
    return q * scale[..., None]


def exact_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as one IEEE division on every device: torch on CUDA turns a
    division by a Python scalar into a multiply by its rounded reciprocal,
    which is not bit-equal; a 0-d tensor divisor on x's device is not. It is
    filled on the device (``torch.full``): ``torch.tensor`` would copy from
    the host and block until the device's queue drains."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _pad_cols(x: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    pad = (-x.shape[-1]) % block
    return (torch.nn.functional.pad(x, (0, pad)) if pad else x), pad


def quant_mean(delta: torch.Tensor, weights: torch.Tensor, block: int, q_max: float,
               key: int | None = None, chain_max: int = CHAIN_MAX_CLIENTS) -> torch.Tensor:
    """sum_c w_c dequant(quant(delta_c)) per ``block``-element scale block:
    (C, N), (C,) -> (N,) f32 with no payload and no (C, N) dequant buffer
    materialized. ``key`` None rounds to nearest, else stochastically from
    the counter hash over the global (client, element) index of the padded
    row. The clients are one ordered chain ``acc = d_0 w_0``, then
    ``acc = acc + d_c w_c`` (the CUDA kernels' order), or one contraction
    beyond ``chain_max`` clients. Weights are used as-is; fold the
    participation mask in first."""
    C, N = delta.shape
    x, pad = _pad_cols(delta.float(), block)
    w = weights.float()
    nidx = torch.arange(N + pad, dtype=torch.int64, device=delta.device)

    def dq(c):
        u = None if key is None else counter_uniform(key, c, nidx).reshape(-1, block)
        return dequant_blocks(x[c].reshape(-1, block), q_max, u).reshape(-1)

    if C > chain_max:
        acc = w @ torch.stack([dq(c) for c in range(C)])
    else:
        acc = dq(0) * w[0]
        for c in range(1, C):
            acc = acc + dq(c) * w[c]
    return acc[:N] if pad else acc


def quant8_mean_ref(delta: torch.Tensor, weights: torch.Tensor, block: int) -> torch.Tensor:
    """Fused quant8 encode -> reduce (|q| <= 127 is exact in f32, so this IS
    the int8 round trip): :func:`quant_mean` with Q = 127."""
    return quant_mean(delta, weights, block, 127.0)


# ---------------------------------------------------------------------------
# row-block int8 quantization of the packed buffer (the gathered quant8
# transport of a client mesh)
# ---------------------------------------------------------------------------

def quantize_rows_ref(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, N) f32 -> (q int8 (C, N), scales f32 (C, ceil(N/block))), the
    ragged tail zero-padded for the scale (K5a's plain arithmetic)."""
    C, N = x.shape
    xp, _ = _pad_cols(x.float(), block)
    q, scale = quant_blocks(xp.reshape(C, -1, block), 127.0)
    return q.to(torch.int8).reshape(C, -1)[:, :N].contiguous(), scale


def dequantize_rows_ref(q: torch.Tensor, scales: torch.Tensor, block: int,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(C, N) int8 + (C, ceil(N/block)) scales -> (C, N) ``q * scale`` cast
    to ``dtype`` (K5b's plain arithmetic)."""
    C, N = q.shape
    qp, _ = _pad_cols(q.float(), block)
    d = qp.reshape(C, -1, block) * scales.float()[..., None]
    return d.reshape(C, -1)[:, :N].to(dtype).contiguous()


def dequant_reduce_ref(q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor,
                       block: int) -> torch.Tensor:
    """Fused decode -> reduce of the gathered int8 payload: (C, N) int8 +
    (C, ceil(N/block)) scales + (C,) weights -> (N,) f32 ``sum_c w_c q_c
    s_c``, one row decoded at a time (no (C, N) f32 buffer). The clients
    are :func:`quant_mean`'s chain under the same CHAIN_MAX_CLIENTS cutover,
    so the gathered transport equals the fused one (K4, or
    :func:`quant8_mean_ref`) bit for bit."""
    C, N = q.shape
    w = weights.float()

    def dq(c):
        row, _ = _pad_cols(q[c].float(), block)
        return (row.reshape(-1, block) * scales[c].float()[:, None]).reshape(-1)

    if C > CHAIN_MAX_CLIENTS:
        acc = w @ torch.stack([dq(c) for c in range(C)])
    else:
        acc = dq(0) * w[0]
        for c in range(1, C):
            acc = acc + dq(c) * w[c]
    return acc[:N]


# ---------------------------------------------------------------------------
# communication frontier: counter PRNG, 4-bit transport, pairwise integer
# masks. The uint32 hash runs in int64 masked to 32 bits (torch has no
# uint32 shift on the CPU); every product is split so it stays below 2^49.
# ---------------------------------------------------------------------------

U32 = 0xFFFFFFFF
FMIX_C1 = 0x85EBCA6B
FMIX_C2 = 0xC2B2AE35
GOLDEN = 0x9E3779B9
IDX_C = 0x9E3779B1
IDX_N = 0x85EBCA77
IDX_E = 0xC2B2AE3D


def mul32(h, c: int):
    """(h * c) mod 2^32 for h in [0, 2^32) (int64 tensor or Python int) and
    a constant c: the high 16 bits of c contribute only their product's low
    16 bits, shifted, so no intermediate exceeds 2^49."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & U32


def fmix32(h):
    """murmur3 fmix32 over uint32 values held in int64 (tensor or Python
    int); the bits of ``ref.fmix32_np``."""
    h = h & U32
    h = h ^ (h >> 16)
    h = mul32(h, FMIX_C1)
    h = h ^ (h >> 13)
    h = mul32(h, FMIX_C2)
    return h ^ (h >> 16)


def round_key(seed: int, round_idx: int) -> int:
    """Per-round PRNG key ``fmix32(seed ^ fmix32(round + GOLDEN))`` as a
    Python int in [0, 2^32): computed on the host from the round counter,
    so it reaches a kernel as a launch argument with no device sync."""
    return fmix32((seed & U32) ^ fmix32(((round_idx & U32) + GOLDEN) & U32))


def counter_uniform(key: int, c_idx, n_idx) -> torch.Tensor:
    """u in [0, 1) f32 for (client, element) counters (int64 tensors or
    ints, broadcast): the 24 high bits of fmix32(key + c*IDX_C + n*IDX_N),
    times 2^-24 (both steps exact in f32)."""
    bits = fmix32(key + mul32(c_idx, IDX_C) + mul32(n_idx, IDX_N))
    return (bits >> 8).float() * 2.0 ** -24


def quant4_dequant_rows_ref(x: torch.Tensor, block: int, key: int = 0,
                            mode: str = "nearest") -> torch.Tensor:
    """(C, N) -> (C, N) f32 dequant(quant4(x)) per client row: what a client
    uploads under 4-bit transport (the topk_ef x quant4 composition). The
    stochastic counters cover the padded row, client c at row c."""
    C, N = x.shape
    xp, pad = _pad_cols(x.float(), block)
    u = None
    if mode == "stochastic":
        cidx = torch.arange(C, dtype=torch.int64, device=x.device)[:, None]
        nidx = torch.arange(N + pad, dtype=torch.int64, device=x.device)[None, :]
        u = counter_uniform(key, cidx, nidx).reshape(C, -1, block)
    elif mode != "nearest":
        raise ValueError(f"quant4 mode={mode!r}; expected nearest | stochastic")
    return dequant_blocks(xp.reshape(C, -1, block), 7.0, u).reshape(C, -1)[:, :N]


def quant4_mean_ref(delta: torch.Tensor, weights: torch.Tensor, block: int, key: int = 0,
                    mode: str = "nearest") -> torch.Tensor:
    """Fused 4-bit encode -> reduce (quant8_mean_ref's sibling):
    :func:`quant_mean` with Q = 7, rounding ``mode`` nearest or stochastic
    under ``key``."""
    if mode not in ("nearest", "stochastic"):
        raise ValueError(f"quant4 mode={mode!r}; expected nearest | stochastic")
    return quant_mean(delta, weights, block, 7.0, key if mode == "stochastic" else None)


def secure_client_masks(rk: int, participation: torch.Tensor, n: int) -> torch.Tensor:
    """(C,) 0/1 participation -> (C, n) int64 pairwise-mask sums in
    [0, 2^32).

    Client c carries sum_{p>c} m_cp - sum_{p<c} m_pc over ACTIVE pairs (both
    endpoints selected), mod 2^32, so the masks cancel exactly in the active
    rows' modular sum. The stream of pair (a < b) is
    ``fmix32(pair_key + n * IDX_E)``; it is drawn once and added to a and
    subtracted from b (the modular sum is the reference's per-client loop
    in another order, bit for bit). Selection stays on the device: an
    inactive pair adds 0."""
    act = (participation.float() > 0).to(torch.int64)
    C = act.shape[0]
    nidx = torch.arange(n, dtype=torch.int64, device=participation.device)
    en = mul32(nidx, IDX_E)
    M = torch.zeros((C, n), dtype=torch.int64, device=participation.device)
    for a in range(C):
        for b in range(a + 1, C):
            pk = fmix32(fmix32(rk + mul32(a, IDX_C)) ^ mul32(b, IDX_N))
            bits = fmix32(pk + en) * (act[a] * act[b])
            M[a] = (M[a] + bits) & U32
            M[b] = (M[b] - bits) & U32
    return M


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same 32 bits
    (no reliance on a wrapping cast)."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def secure_masked_rows(q: torch.Tensor, participation: torch.Tensor, rk: int) -> torch.Tensor:
    """q (C, N) int32 -> (C, N) int32 bits of each row plus its pairwise
    masks, mod 2^32: what each client uploads."""
    masks = secure_client_masks(rk, participation, q.shape[1])
    return to_int32_bits((q.to(torch.int64) + masks) & U32)


def secure_sum_ref(q: torch.Tensor, participation: torch.Tensor, rk: int, *,
                   use_masks: bool = True) -> torch.Tensor:
    """q (C, N) int32 -> (N,) int32 sum over participating rows, optionally
    through pairwise masking; bitwise equal either way (the masks cancel in
    the modular sum)."""
    act = participation.float() > 0
    rows = secure_masked_rows(q, participation, rk) if use_masks else q
    total = torch.sum(torch.where(act[:, None], rows.to(torch.int64) & U32, 0), dim=0) & U32
    return to_int32_bits(total)
