"""hubert-xlarge [audio] — encoder-only, same arch as w2v2. [arXiv:2106.07447]

The conv/mel frontend is a stub: input_specs()
provides pre-computed frame embeddings (B, T, d_model); the training
objective is HuBERT masked cluster prediction over vocab=504 cluster ids.

Port of ``repro/configs/hubert_xlarge.py``: the same fields.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    tie_embeddings=False,
    modality="audio",
    source="arXiv:2106.07447",
)
