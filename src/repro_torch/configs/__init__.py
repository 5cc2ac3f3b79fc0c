"""Config registry: ``--arch <id>`` ids -> ArchConfig (port of
``repro/configs/__init__.py``). Only the architectures the port can run are
registered; asking for any other raises."""
from repro_torch.configs import fedyolov3
from repro_torch.configs.base import ArchConfig

REGISTRY: dict[str, ArchConfig] = {fedyolov3.CONFIG.name: fedyolov3.CONFIG}


def get_arch(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"arch {name!r} is not ported yet; the PyTorch port has: {sorted(REGISTRY)}"
        )
    return REGISTRY[name]


__all__ = ["REGISTRY", "ArchConfig", "get_arch"]
