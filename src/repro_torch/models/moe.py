"""GShard-style top-k Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

Capacity-based one-hot dispatch and combine (GShard / Switch) over
``moe_group_size``-token routing groups, with the Switch load-balance aux
loss; ``moe_impl="sort"`` takes the gather/scatter dispatch instead. The
reference's dispatch is einsums outside any Pallas kernel, so here it is
``torch`` products, gathers and an ``index_add_``.

Two points where ``torch`` differs from JAX and the port follows JAX:

- ``jax.lax.top_k`` breaks ties by the lower index; ``torch.topk`` makes no
  such promise. :func:`top_k` takes the first k of a stable descending sort,
  which keeps equal probabilities in index order.
- The sort path's ``.at[slot].set(..., mode="drop")`` drops the entries past
  capacity, whose slot is ``E * C``. An out-of-range ``index_put_`` raises,
  so the tables get one extra slot at ``E * C`` that the dropped entries
  write into and that is cut off before use.

A token past its expert's capacity gets zero output from that expert.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import einsum
from repro_torch.models.params import ParamInfo


def moe_template(cfg, prefix_axes=("layer",), n_stack=()):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    pa, ns = prefix_axes, n_stack
    return {
        "router": ParamInfo(ns + (d, e), pa + ("embed", "expert"), init="small_normal"),
        "w_gate": ParamInfo(ns + (e, d, f), pa + ("expert", "embed", "ffn")),
        "w_up": ParamInfo(ns + (e, d, f), pa + ("expert", "embed", "ffn")),
        "w_down": ParamInfo(ns + (e, f, d), pa + ("expert", "ffn", "embed")),
    }


def capacity(cfg, group_size: int) -> int:
    cap = int(group_size * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor)
    return max(cap, cfg.experts_per_token)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index (as
    ``jax.lax.top_k``) -> (values, int64 indices)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _aux(probs: torch.Tensor, first: torch.Tensor, E: int) -> torch.Tensor:
    """Switch aux loss: E * mean over groups of sum_e (top-1 fraction_e *
    mean prob_e). probs (..., S, E), first (..., S) top-1 experts."""
    frac = F.one_hot(first, E).float().mean(dim=-2)
    return E * torch.mean(torch.sum(frac * probs.mean(dim=-2), dim=-1))


def route(cfg, logits: torch.Tensor):
    """logits (G, S, E) -> dispatch (G, S, E, C) 0/1 float32, combine (G, S,
    E, C) float32, aux loss: top-k per token, capacity-limited per expert
    within each group (the queue runs in (token, choice) order)."""
    G, S, E = logits.shape
    C = capacity(cfg, S)
    k = cfg.experts_per_token
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_idx = top_k(probs, k)  # (G, S, k)
    choice_oh = F.one_hot(expert_idx, E).float()  # (G, S, k, E)
    flat = choice_oh.reshape(G, S * k, E)
    # position of each (token, choice) in its expert's queue
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1).reshape(G, S, k)
    fits = pos < C
    gate_vals = gate_vals * fits
    pos_oh = F.one_hot(pos.long().clamp_max(C - 1), C).float() * fits[..., None]  # (G, S, k, C)
    dispatch = einsum("gske,gskc->gsec", choice_oh, pos_oh)
    combine = einsum("gske,gskc->gsec", choice_oh * gate_vals[..., None], pos_oh)
    return dispatch, combine, _aux(probs, expert_idx[..., 0], E)


def moe_block(p: dict, x: torch.Tensor, cfg):
    """x (B, S, D) -> (B, S, D), aux loss.

    Routing groups are ``moe_group_size``-token windows (GShard), so the
    capacity and the one-hot dispatch tensors stay bounded whatever the
    sequence length; a sequence the group size does not divide is one
    group. The batch axis stays apart from the group axis, as in the
    reference. The aux loss is ``E`` times the mean over all ``B * ng``
    groups, which equals the reference's mean over rows of each row's
    mean, since every row has the same ``ng`` groups."""
    if cfg.moe_impl == "sort":
        return moe_block_sort(p, x, cfg)
    B, S, D = x.shape
    gs = min(cfg.moe_group_size, S)
    ng = S // gs
    if S % gs:
        gs, ng = S, 1
    xg = x.reshape(B, ng, gs, D)
    logits = einsum("bgsd,de->bgse", xg, p["router"])
    dispatch, combine, aux = route(cfg, logits.reshape(B * ng, gs, -1))
    dispatch = dispatch.reshape(B, ng, *dispatch.shape[1:]).to(x.dtype)
    combine = combine.reshape(B, ng, *combine.shape[1:]).to(x.dtype)
    xe = einsum("bgsec,bgsd->bgecd", dispatch, xg)
    g = einsum("bgecd,edf->bgecf", xe, p["w_gate"])
    u = einsum("bgecd,edf->bgecf", xe, p["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    ye = einsum("bgecf,efd->bgecd", h, p["w_down"])
    y = einsum("bgsec,bgecd->bgsd", combine, ye)
    return y.reshape(B, S, -1), aux


def moe_block_sort(p: dict, x: torch.Tensor, cfg):
    """Sort-based (gather/scatter) top-k dispatch, per batch row over the
    whole sequence: the (token, choice) pairs sorted by expert (stable), the
    rank within an expert is the capacity slot, rows gathered into (E, C,
    D), the expert FFN run, scaled by the gates and scatter-added back."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = capacity(cfg, S)
    logits = einsum("bsd,de->bse", x, p["router"])
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_idx = top_k(probs, k)  # (B, S, k)
    flat_e = expert_idx.reshape(B, S * k)
    flat_tok = torch.arange(S, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = flat_tok[order]  # (B, S*k) token of each sorted entry
    sgate = torch.gather(gate_vals.reshape(B, S * k), 1, order)
    starts = torch.searchsorted(se, torch.arange(E, device=x.device).expand(B, E).contiguous())
    rank = torch.arange(S * k, device=x.device)[None] - torch.gather(starts, 1, se)
    slot = torch.where(rank < C, se * C + rank, E * C)  # E * C: dropped
    # slot E * C is the dropped entries' sink, cut off below
    dix = torch.full((B, E * C + 1), S, dtype=torch.long, device=x.device)
    dix.scatter_(1, slot, stok)
    gec = torch.zeros((B, E * C + 1), dtype=torch.float32, device=x.device)
    gec.scatter_(1, slot, sgate)
    dix, gec = dix[:, :E * C], gec[:, :E * C]
    xpad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)  # row S: a zero token
    xe = torch.gather(xpad, 1, dix[..., None].expand(B, E * C, D)).reshape(B, E, C, D)
    g = einsum("becd,edf->becf", xe, p["w_gate"])
    u = einsum("becd,edf->becf", xe, p["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    ye = einsum("becf,efd->becd", h, p["w_down"]).reshape(B, E * C, -1)
    ye = ye * gec[..., None].to(ye.dtype)
    y = torch.zeros((B, S + 1, ye.shape[-1]), dtype=ye.dtype, device=x.device)
    y.scatter_add_(1, dix[..., None].expand_as(ye), ye)
    return y[:, :S], _aux(probs, expert_idx[..., 0], E)
