"""Config registry: ``--arch <id>`` ids -> ArchConfig (port of
``repro/configs/__init__.py``): the reference's 10 assigned architectures in
its ``ASSIGNED`` order, and the paper's own detector."""
from repro_torch.configs import (
    fedyolov3,
    gemma3_27b,
    granite_3_8b,
    granite_moe_1b_a400m,
    grok_1_314b,
    hubert_xlarge,
    llava_next_34b,
    mamba2_1_3b,
    minitron_8b,
    qwen3_1_7b,
    zamba2_2_7b,
)
from repro_torch.configs.base import ArchConfig

ASSIGNED = [
    granite_3_8b.CONFIG,
    qwen3_1_7b.CONFIG,
    hubert_xlarge.CONFIG,
    grok_1_314b.CONFIG,
    granite_moe_1b_a400m.CONFIG,
    gemma3_27b.CONFIG,
    llava_next_34b.CONFIG,
    minitron_8b.CONFIG,
    mamba2_1_3b.CONFIG,
    zamba2_2_7b.CONFIG,
]

REGISTRY: dict[str, ArchConfig] = {c.name: c for c in ASSIGNED}
REGISTRY[fedyolov3.CONFIG.name] = fedyolov3.CONFIG


def get_arch(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ASSIGNED", "REGISTRY", "ArchConfig", "get_arch"]
