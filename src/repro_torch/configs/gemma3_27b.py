"""gemma3-27b [dense] — 5:1 local:global sliding window, 128k context.
[hf:google/gemma-3-1b-pt]

Layer pattern repeats with period 6: five local (1024-token sliding window)
layers then one global layer. 62 layers -> 10 full periods + 2 local layers.

Port of ``repro/configs/gemma3_27b.py``: the same fields.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    qk_norm=True,
    window=1024,
    local_global_period=6,
    source="hf:google/gemma-3-1b-pt",
)
