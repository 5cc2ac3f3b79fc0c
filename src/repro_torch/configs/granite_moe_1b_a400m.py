"""granite-moe-1b-a400m [moe] — 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]

Port of ``repro/configs/granite_moe_1b_a400m.py``: the same fields.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    experts_per_token=8,
    # tiny experts (d_ff=512): dispatch cost ~ E*C*D rivals the expert FFN,
    # so keep routing groups small
    moe_group_size=512,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
