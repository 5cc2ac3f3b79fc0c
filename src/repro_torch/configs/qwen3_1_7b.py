"""qwen3-1.7b [dense] — qk_norm, GQA (port of ``repro/configs/qwen3_1_7b.py``).
[hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    head_dim=128,
    source="hf:Qwen/Qwen3-8B",
)
