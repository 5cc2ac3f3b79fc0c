"""Config registry: ``--arch <id>`` ids -> ArchConfig (port of
``repro/configs/__init__.py``): the reference's 10 assigned architectures in
its ``ASSIGNED`` order, and the paper's own detector; ``SHAPES`` and
``get_shape`` for the launch plans."""
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
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, shape_applicable

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


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = ["ASSIGNED", "REGISTRY", "SHAPES", "ArchConfig", "ShapeConfig", "get_arch", "get_shape",
           "shape_applicable"]
