"""Roofline terms of a plan's step on H100 constants (port of
``repro/launch/roofline.py``).

The hardware model is ``launch.mesh``'s: an NVIDIA H100 SXM5 at 700 W. Every
count is per device (``launch.op_analysis``); the terms are seconds per step
on one card and the largest names the bound. The compute term takes each
kind of product at its own rate: ``"fp32"`` the FP32 units (the port's
cuBLAS f32 products, TF32 off), ``"tf32x3"`` the 3xTF32 split of K9 and
K10 (a third of the TF32 tensor-core rate), ``"bf16"`` the BF16 tensor
cores; the kernels' other operations run on the FP32 units. A bare number
of FLOPs is taken at the BF16 rate, as the reference takes its one figure
at its chip's bf16 peak. The collective term puts every collective's bytes
over NVLink, the cross-node term those of groups that leave a node over
InfiniBand (the reference's ICI and cross-pod DCN terms).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import rounds as R
from repro_torch.launch.mesh import BF16_FLOPS, FP32_FLOPS, HBM_BW, IB_BW, NVLINK_BW, TF32X3_FLOPS
from repro_torch.models import params as mp

RATES = {"fp32": FP32_FLOPS, "tf32x3": TF32X3_FLOPS, "bf16": BF16_FLOPS}

# ring all-reduce moves ~2x the payload per device; others ~1x
COLLECTIVE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "ragged-all-to-all": 1.0,
    "collective-broadcast": 1.0,
}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    op_flops_total: float
    useful_ratio: float
    cross_node_s: float = 0.0
    cross_node_bytes: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def expert_params(arch: ArchConfig) -> int:
    if not arch.n_experts:
        return 0
    per_layer = 3 * arch.d_model * arch.d_ff * arch.n_experts
    return per_layer * arch.n_layers


def active_params(arch: ArchConfig) -> int:
    tpl = R.make_template(arch)
    n = mp.count_params(tpl)
    if arch.n_experts:
        ep = expert_params(arch)
        n = n - ep + int(ep * arch.experts_per_token / arch.n_experts)
    return n


def model_flops(arch: ArchConfig, shape: ShapeConfig, local_steps: int = 1) -> float:
    """MODEL_FLOPS: 6*N_active*D train, 2*N_active*D inference (+KV reads)."""
    n = active_params(arch)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len * local_steps
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    # decode: one token; add the attention context reads as flops
    flops = 2.0 * n * shape.global_batch
    if arch.n_heads and arch.family != "ssm":
        hd = arch.resolved_head_dim
        S = shape.seq_len
        if arch.family == "hybrid":
            # only the shared attention block applications read a KV cache
            n_attn_reads = (arch.n_layers // arch.shared_attn_period) * S
        elif arch.local_global_period:
            ng, nt = divmod(arch.n_layers, arch.local_global_period)
            n_local = ng * (arch.local_global_period - 1) + nt
            n_global = arch.n_layers - n_local
            W = min(arch.window, S)
            n_attn_reads = n_global * S + n_local * W
        else:
            n_attn_reads = arch.n_layers * S
        flops += 4.0 * arch.n_heads * hd * n_attn_reads * shape.global_batch
    return flops


def terms(flops_dev, traffic_dev: float, coll_bytes: dict, n_devices: int, arch: ArchConfig,
          shape: ShapeConfig, local_steps: int = 1, cross_node_bytes: dict | None = None,
          other_ops: float = 0.0) -> Roofline:
    """``flops_dev``: a device's FLOPs, a number (at the BF16 rate) or a dict
    by kind (each at its rate); ``other_ops``: operations on the FP32 units."""
    by_kind = flops_dev if isinstance(flops_dev, dict) else {"bf16": flops_dev}
    compute_s = sum(v / RATES[k] for k, v in by_kind.items()) + other_ops / FP32_FLOPS
    memory_s = traffic_dev / HBM_BW
    coll_s = sum(COLLECTIVE_FACTOR.get(k, 1.0) * v for k, v in coll_bytes.items()) / NVLINK_BW
    cross_b = sum((cross_node_bytes or {}).values())
    cross_s = sum(
        COLLECTIVE_FACTOR.get(k, 1.0) * v for k, v in (cross_node_bytes or {}).items()
    ) / IB_BW
    dom = max(
        [("compute", compute_s), ("memory", memory_s), ("collective", coll_s),
         ("cross-node", cross_s)],
        key=lambda kv: kv[1],
    )[0]
    mf = model_flops(arch, shape, local_steps)
    flops_total = sum(by_kind.values()) * n_devices
    ratio = mf / flops_total if flops_total else math.nan
    return Roofline(compute_s, memory_s, coll_s, dom, mf, flops_total, ratio, cross_s, cross_b)
