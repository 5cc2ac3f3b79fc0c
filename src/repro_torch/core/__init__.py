"""Federation core: config, rounds, aggregation, the platform components
(scheduler, explorer, task manager, server, client, secure aggregation,
monitor) and the serving plane.

The reference's ``repro/core/__init__.py`` imports its modules eagerly; here
they load on first attribute access, so ``import repro_torch.core`` stays
cheap (``repro_torch.core.task_manager`` and ``from repro_torch.core import
secure_agg`` work either way).
"""
import importlib

_MODULES = ("aggregators", "compression", "explorer", "monitor", "packing", "rounds",
            "scheduler", "secure_agg", "server", "task_manager")

__all__ = list(_MODULES)


def __getattr__(name: str):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
