"""Architecture configuration (port of ``repro/configs/base.py::ArchConfig``).

With ``ShapeConfig``, ``SHAPES`` and ``shape_applicable``, the launch
plans' (arch x shape) matrix. A plain copy: the config is pure Python, but importing it from the JAX
package would run ``repro/__init__.py`` and with it JAX, so the port keeps
its own. Field names, defaults and :meth:`ArchConfig.reduced` match the
reference exactly, so a config compares equal field by field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm | yolo
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    causal: bool = True  # False for encoder-only (hubert)
    tie_embeddings: bool = True
    # --- attention pattern ---
    window: int = 0  # sliding-window size for local layers (0 = full)
    local_global_period: int = 0  # gemma3: 6 -> [5 local, 1 global] repeating
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_group_size: int = 4096  # GShard routing group (bounds capacity/dispatch)
    moe_impl: str = "gshard"  # gshard (one-hot einsum) | sort (gather/scatter)
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_impl: str = "ref"  # ref | kernel
    # --- hybrid (zamba2) ---
    shared_attn_period: int = 0  # apply one shared attention block every N layers
    # --- modality stubs ---
    modality: str = "text"  # text | audio | vlm | image
    n_image_tokens: int = 0  # vlm: anyres patch-embedding tokens prepended
    # --- sharding-only structural padding (exact semantics preserved) ---
    q_group_pad: int = 0  # pad each GQA group to this many q heads (masked)
    attention_impl: str = "ref"  # ref | kernel
    # --- misc ---
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    source: str = ""  # citation bracket from the assignment

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def supports_long_decode(self) -> bool:
        """True if long_500k decode is sub-quadratic/memory-feasible: SSM /
        hybrid state, or a structural sliding window (gemma3 natively, any
        dense arch under the beyond-paper `swa` serving variant)."""
        if self.is_encoder_only:
            return False
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window > 0

    @property
    def has_decode(self) -> bool:
        return not self.is_encoder_only

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts
        (``repro/configs/base.py::ArchConfig.reduced``)."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads, 2))
        period = self.local_global_period
        n_layers = max(2, period) if period else 2
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=64 if self.head_dim else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token
            else 0,
            window=min(self.window, 16) if self.window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else 64,
            ssm_chunk=8 if self.ssm_state else 128,
            shared_attn_period=min(self.shared_attn_period, 2)
            if self.shared_attn_period
            else 0,
            n_image_tokens=min(self.n_image_tokens, 16) if self.n_image_tokens else 0,
            q_group_pad=0,
            dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Return (applicable, reason-if-not) per the DESIGN.md skip matrix."""
    if shape.kind == "decode" and not arch.has_decode:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not arch.supports_long_decode:
        return False, "pure full-attention arch: long-context decode skipped (see DESIGN.md)"
    return True, ""
