"""minitron-8b [dense] — pruned nemotron. [arXiv:2407.14679]

Port of ``repro/configs/minitron_8b.py``: the same fields.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    tie_embeddings=False,
    source="arXiv:2407.14679",
)
