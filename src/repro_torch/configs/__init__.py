"""Config registry: ``--arch <id>`` ids -> ArchConfig (port of
``repro/configs/__init__.py``). Only the architectures the port can run are
registered; asking for any other raises."""
from repro_torch.configs import fedyolov3, mamba2_1_3b, qwen3_1_7b
from repro_torch.configs.base import ArchConfig

REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in (fedyolov3.CONFIG, qwen3_1_7b.CONFIG, mamba2_1_3b.CONFIG)
}


def get_arch(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"arch {name!r} is not ported yet; the PyTorch port has: {sorted(REGISTRY)}"
        )
    return REGISTRY[name]


__all__ = ["REGISTRY", "ArchConfig", "get_arch"]
