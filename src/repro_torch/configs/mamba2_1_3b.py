"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free (port of
``repro/configs/mamba2_1_3b.py``). [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    source="arXiv:2405.21060",
)
