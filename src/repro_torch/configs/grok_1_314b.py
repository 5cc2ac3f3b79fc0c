"""grok-1-314b [moe] — 8 experts top-2. [hf:xai-org/grok-1]

Port of ``repro/configs/grok_1_314b.py``: the same fields.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    experts_per_token=2,
    source="hf:xai-org/grok-1",
)
