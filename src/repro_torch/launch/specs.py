"""Per-(arch x shape x mesh) lowering plans (port of ``repro/launch/specs.py``).

The single source of truth the dry-run (``launch.dryrun``), the op counter
(``launch.op_analysis``) and the launcher's ``--print-plan`` read. For every
combination it decides:

- which step function runs (the federated round, the fedsgd step, prefill
  or decode; :func:`step_fn` returns the port's own, wrapped in
  ``models.shard_ctx.activation_sharding``),
- the federated client mapping onto the mesh's axes,
- the param, batch and cache specs (``models.params.Spec``, the torch
  meaning of the reference's ``PartitionSpec``), including the FSDP-style
  rules of the architectures whose optimizer state exceeds a device's
  memory under pure tensor parallelism (gemma3-27b, grok-1-314b,
  llava-next-34b).

The plans, their names and every spec are the reference's, field by field
(``tests/test_torch_launch.py``). :func:`input_specs` gives the step's
inputs as ``meta`` tensors in the port's own layout (the packed round state
of ``core.rounds``), whose specs the dry-run turns into exact per-device
bytes (:func:`per_device_bytes`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs import get_arch, get_shape, shape_applicable
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import packing
from repro_torch.core import rounds as R
from repro_torch.models import params as mp
from repro_torch.models import serving, transformer
from repro_torch.models.params import DEFAULT_RULES, PROD_AXIS_SIZES, Spec
from repro_torch.optim import adamw

PyTree = Any

# Architectures needing parameter/optimizer sharding over the data axis.
FSDP_ARCHS = {"gemma3-27b", "grok-1-314b", "llava-next-34b"}
MODEL_AXIS = 16  # model-parallel width of both production meshes


def fsdp_rules() -> dict:
    rules = dict(DEFAULT_RULES)
    rules["embed"] = "data"  # ZeRO/FSDP-style: shard the d_model dim
    return rules


@dataclasses.dataclass(frozen=True)
class LoweringPlan:
    arch: ArchConfig
    shape: ShapeConfig
    multi_pod: bool
    kind: str  # train | fedsgd | prefill | decode
    fed: R.FedConfig | None
    rules: dict
    dp_axes: tuple[str, ...]  # serve batch axes
    aggregation: str
    opt_rules: dict | None = None  # ZeRO-1: separate moment sharding

    @property
    def name(self) -> str:
        mesh = "multipod" if self.multi_pod else "singlepod"
        return f"{self.arch.name}--{self.shape.name}--{mesh}"


# The reference's hillclimb variants:
#   moe_sort   — sort/gather-scatter MoE dispatch (no one-hot einsum FLOPs)
#   moe_ep     — expert-parallel: experts over "model" instead of d_ff
#   moe_sort_ep— both
#   zero1      — params TP-only, optimizer moments sharded over "data"
#   micro<N>   — override microbatch count
#   seqpar     — sequence-parallel residual stream (S over "model")
#   swa        — sliding-window serving variant for dense archs (enables
#                long_500k with ring-buffer KV caches)
VARIANTS = ("", "moe_sort", "moe_ep", "moe_sort_ep", "zero1", "seqpar", "swa")
SWA_WINDOW = 4096


def variant_arch(arch: ArchConfig, variant: str) -> ArchConfig:
    """Arch-level transforms that must precede shape-applicability checks."""
    if variant == "swa" and not arch.window:
        return dataclasses.replace(arch, window=SWA_WINDOW)
    return arch


def apply_variant(arch: ArchConfig, rules: dict, fed, variant: str):
    opt_rules = None
    if variant.startswith("micro") and fed is not None:
        fed = dataclasses.replace(fed, microbatches=int(variant[5:]))
    if variant in ("moe_sort", "moe_sort_ep"):
        arch = dataclasses.replace(arch, moe_impl="sort")
    if variant in ("moe_ep", "moe_sort_ep"):
        rules = dict(rules)
        rules["expert"] = "model"
        rules["ffn"] = None
    if variant == "zero1":
        opt_rules = dict(rules)
        rules = {k: v for k, v in rules.items() if k != "embed" or v != "data"}
        rules["embed"] = None
        opt_rules["embed"] = "data"
    return arch, rules, fed, opt_rules


def make_plan(arch_name: str, shape_name: str, multi_pod: bool, aggregation: str = "eq6",
              local_steps: int = 1, variant: str = "") -> LoweringPlan:
    arch = variant_arch(get_arch(arch_name), variant)
    shape = get_shape(shape_name)
    ok, why = shape_applicable(arch, shape)
    if not ok:
        raise ValueError(f"{arch_name} x {shape_name}: {why}")
    big = arch.name in FSDP_ARCHS
    if shape.kind == "train":
        # microbatch counts target ~2 rows of 4k tokens per device per
        # microbatch, bounding the checkpointed activations
        if multi_pod:
            fed = R.FedConfig(n_clients=2, local_steps=local_steps, aggregation=aggregation,
                              client_axis="pod", data_axis="data", topn=default_topn(arch),
                              microbatches=8 if big else 4)
            rules = fsdp_rules() if big else dict(DEFAULT_RULES)
            kind = "train"
        elif big:
            # single-pod: FedSGD-equivalent (E=1 param-avg == grad-avg) so
            # one model copy can shard over both axes
            fed = R.FedConfig(n_clients=16, local_steps=local_steps, aggregation="fedsgd",
                              client_axis="data", data_axis="data", topn=default_topn(arch),
                              microbatches=8)
            rules = fsdp_rules()
            kind = "fedsgd"
        else:
            fed = R.FedConfig(n_clients=16, local_steps=local_steps, aggregation=aggregation,
                              client_axis="data", data_axis=None, topn=default_topn(arch),
                              microbatches=8)
            rules = dict(DEFAULT_RULES)
            kind = "train"
        arch, rules, fed, opt_rules = apply_variant(arch, rules, fed, variant)
        return LoweringPlan(arch, shape, multi_pod, kind, fed, rules, (), fed.aggregation,
                            opt_rules)
    # serving
    rules = dict(DEFAULT_RULES)
    if arch.name == "grok-1-314b":
        rules["embed"] = "data"  # 314B bf16 exceeds HBM under pure TP
    dp = ("pod", "data") if multi_pod else ("data",)
    kind = "prefill" if shape.kind == "prefill" else "decode"
    arch, rules, _, opt_rules = apply_variant(arch, rules, None, variant)
    return LoweringPlan(arch, shape, multi_pod, kind, None, rules, dp, "none", opt_rules)


def default_topn(arch: ArchConfig) -> int:
    """Paper: user-set n. Default: a quarter of the layer buckets."""
    return max(1, (arch.n_layers + 1) // 4)


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_template(arch: ArchConfig, lead: tuple[int, ...], seq: int) -> PyTree:
    """Model inputs with ``lead`` prefix dims ((C, E, b) for train, (B,)
    serve), as ``meta`` tensors."""
    if arch.modality == "audio":
        return {
            "frames": _meta(lead + (seq, arch.d_model), torch.bfloat16),
            "labels": _meta(lead + (seq,), torch.int32),
            "mask": _meta(lead + (seq,), torch.bool),
        }
    if arch.modality == "vlm":
        ni = arch.n_image_tokens
        return {
            "tokens": _meta(lead + (seq - ni,), torch.int32),
            "images": _meta(lead + (ni, arch.d_model), torch.bfloat16),
        }
    return {"tokens": _meta(lead + (seq,), torch.int32)}


def batch_pspec_tree(arch: ArchConfig, batch: PyTree, lead_spec: tuple) -> PyTree:
    def spec_for(leaf):
        extra = (None,) * (leaf.dim() - len(lead_spec))
        return Spec(*lead_spec, *extra)

    return mp.map_tree(spec_for, batch)


def input_specs(plan: LoweringPlan, batch: int | None = None,
                dtype: torch.dtype = torch.bfloat16) -> tuple[tuple, tuple]:
    """Returns (meta args, specs) for the plan's step function, params in
    ``dtype`` (the reference's bf16 by default). ``batch`` overrides the
    shape's global batch (the op counter's one replica)."""
    arch, shape = plan.arch, plan.shape
    S, B = shape.seq_len, shape.global_batch if batch is None else batch
    optimizer = adamw()
    if plan.kind in ("train", "fedsgd"):
        fed = plan.fed
        state = R.state_template(arch, fed, optimizer, dtype)
        sspec = R.state_pspecs(arch, fed, optimizer, plan.rules, plan.opt_rules)
        if plan.kind == "fedsgd":
            # the port's fedsgd batch is the cohort's as one (E, C b, ...)
            data = batch_template(arch, (fed.local_steps, B), S)
            bspec = batch_pspec_tree(arch, data, (None, ("pod", "data") if plan.multi_pod
                                                  else ("data",)))
        else:
            b = B // fed.n_clients
            data = batch_template(arch, (fed.n_clients, fed.local_steps, b), S)
            bspec = batch_pspec_tree(arch, data, (fed.client_axis, None, fed.data_axis))
        w = _meta((fed.n_clients,), torch.float32)
        return (state, data, w), (sspec, bspec, Spec())
    # serving: the global (aggregated) model
    tpl = R.make_template(arch)
    params = mp.abstract(tpl, dtype)
    pspec = mp.pspecs(tpl, plan.rules)
    if plan.kind == "prefill":
        data = batch_template(arch, (B,), S)
        bspec = batch_pspec_tree(arch, data, (plan.dp_axes,))
        return (params, data), (pspec, bspec)
    # decode: one token at the cache's last position
    cache = serving.cache_spec(arch, B, S, abstract=True)
    cspec = cache_pspecs(arch, B, plan.dp_axes)
    tokens = _meta((B, 1), torch.int32)
    tspec = Spec(plan.dp_axes if B > 1 else None, None)
    return (params, cache, tokens, S - 1), (pspec, cspec, tspec, Spec())


def cache_pspecs(arch: ArchConfig, B: int, dp_axes: tuple[str, ...]) -> PyTree:
    """Specs mirroring ``serving.cache_spec``'s structure."""
    dp = dp_axes if B > 1 else None
    kv_ok = arch.n_kv_heads % MODEL_AXIS == 0 if arch.n_kv_heads else False
    if arch.family in ("dense", "vlm", "audio", "moe") and not arch.local_global_period:
        if kv_ok:
            spec = Spec(None, dp, None, "model", None)
        else:  # shard the cache sequence dim instead (flash-decode style)
            spec = Spec(None, dp, "model", None, None)
        return {"k": spec, "v": spec}
    if arch.local_global_period:
        head_ax = "model" if kv_ok else None
        long_seq = None if B > 1 else "data"  # long_500k: shard S over data
        local = Spec(None, None, dp, None, head_ax, None)
        glob_spec = Spec(None, dp, long_seq, head_ax, None)
        out = {"g_local": {"k": local, "v": local}, "g_global": {"k": glob_spec, "v": glob_spec}}
        ng, nt = transformer.gemma_pattern(arch)
        if nt:
            tail = Spec(None, dp, None, head_ax, None)
            out["tail"] = {"k": tail, "v": tail}
        return out
    if arch.family == "ssm":
        from repro_torch.models import mamba2 as m2

        _, h, _ = m2.dims(arch)
        head_ax = "model" if h % MODEL_AXIS == 0 else None
        return {
            "ssm": Spec(None, dp, head_ax, None, None),
            "conv": Spec(None, dp, None, None),
        }
    if arch.family == "hybrid":
        from repro_torch.models import mamba2 as m2

        _, h, _ = m2.dims(arch)
        head_ax = "model" if h % MODEL_AXIS == 0 else None
        kv_ax = "model" if kv_ok else None
        long_seq = None if B > 1 else "data"
        return {
            "ssm": Spec(None, None, dp, head_ax, None, None),
            "conv": Spec(None, None, dp, None, None),
            "shared": {
                "k": Spec(None, dp, long_seq, kv_ax, None),
                "v": Spec(None, dp, long_seq, kv_ax, None),
            },
        }
    raise ValueError(arch.family)


# ---------------------------------------------------------------------------
# Per-device bytes
# ---------------------------------------------------------------------------

def _shards(entry, sizes: dict) -> int:
    k = 1
    for name in entry if isinstance(entry, tuple) else (entry,):
        if name is not None:
            k *= sizes.get(name, 1)
    return k


def shard_numel(shape: tuple, spec: Spec, sizes: dict) -> int:
    """Elements one device holds of a ``shape`` tensor under ``spec`` (a dim
    that its axes do not divide is padded, as XLA pads a shard)."""
    n = 1
    for i, d in enumerate(shape):
        k = _shards(spec[i], sizes) if i < len(spec) else 1
        n *= -(-d // k)
    return n


def per_device_bytes(tree: PyTree, specs: PyTree, axis_sizes: dict | None = None) -> int:
    """Bytes one device holds of ``tree`` (tensors, and the round counter as
    an int32) under ``specs`` (``Spec`` or ``packing.SegmentSpec`` leaves)."""
    sizes = PROD_AXIS_SIZES if axis_sizes is None else axis_sizes
    if isinstance(specs, dict):
        return sum(per_device_bytes(tree[k], specs[k], sizes) for k in specs)
    if isinstance(specs, packing.SegmentSpec):
        lead = shard_numel(tuple(tree.shape[:len(specs.lead)]), specs.lead, sizes)
        flat = sum(shard_numel(shape, spec, sizes) for shape, spec in specs.segments)
        return lead * flat * tree.element_size()
    if isinstance(specs, (tuple, list)) and not isinstance(specs, Spec):
        return sum(per_device_bytes(t, s, sizes) for t, s in zip(tree, specs))
    if isinstance(tree, int):
        return 4  # the round counter / decode position, an int32 on the reference
    return shard_numel(tuple(tree.shape), specs, sizes) * tree.element_size()


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

def _act_axes(plan: LoweringPlan):
    """Activation batch-dim sharding for the plan (see models.shard_ctx)."""
    if plan.kind == "fedsgd":
        return ("pod", "data") if plan.multi_pod else ("data",)
    if plan.kind == "train":
        # () -> a constraint with no batch axes; data_axis when within-client
        # data parallelism is present
        return (plan.fed.data_axis,) if plan.fed.data_axis else ()
    return plan.dp_axes if plan.shape.global_batch > 1 else None


def step_fn(plan: LoweringPlan, mesh=None, variant: str = ""):
    """The plan's step as the port runs it: ``core.rounds.build_fed_round``'s
    round (train and fedsgd; ``mesh`` is its client mesh), the encoder's
    forward, ``serving.prefill`` or ``serving.decode_step``, each under
    ``activation_sharding`` of the plan's axes."""
    from repro_torch.models.shard_ctx import activation_sharding

    arch = plan.arch
    axes = _act_axes(plan)
    seq_axis = "model" if variant == "seqpar" else None
    if plan.kind in ("train", "fedsgd"):
        inner = R.build_fed_round(arch, plan.fed, adamw(), mesh)

        def fed_wrapped(state, batch, weights):
            with activation_sharding(axes, seq_axis):
                return inner(state, batch, weights)

        return fed_wrapped
    if plan.kind == "prefill":
        if arch.is_encoder_only:
            # encoder inference: full-sequence logits (no cache)
            def enc_fwd(params, batch):
                with activation_sharding(axes):
                    x = transformer.embed_inputs(arch, params, batch)
                    hidden, _ = transformer.trunk(arch, params, x)
                    return transformer.logits_fn(arch, params, hidden)

            return enc_fwd

        def prefill_wrapped(params, batch):
            with activation_sharding(axes):
                return serving.prefill(arch, params, batch)

        return prefill_wrapped

    def decode_wrapped(params, cache, tokens, pos):
        with activation_sharding(axes):
            return serving.decode_step(arch, params, cache, tokens, pos)

    return decode_wrapped

