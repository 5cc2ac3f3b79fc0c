"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]

54 Mamba2 layers; one *shared* (single weight set) attention+MLP block is
applied every 9 layers (6 applications), following Zamba2's shared-block
design.

Port of ``repro/configs/zamba2_2_7b.py``: the same fields.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    shared_attn_period=9,
    source="arXiv:2411.15242",
)
