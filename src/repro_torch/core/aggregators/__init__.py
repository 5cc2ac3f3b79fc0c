"""Pluggable aggregation strategies (port of ``repro/core/aggregators``).

Importing this package registers every stacked mode: dense | eq6 | quant8 |
static_topn | fedavgm | fedadam | trimmed_mean, the two-level ``hier``
composer, the communication frontier topk_ef | quant4 | secure, and the
fedsgd topology (one shared model copy). ``get(name)`` resolves a FedConfig
aggregation name to its strategy class; ``names()`` lists what is
available.
"""
from repro_torch.core.aggregators.base import (
    AggContext, Aggregator, gather_clients, get, names, register,
)
from repro_torch.core.aggregators import (  # noqa: F401,E402 (registration)
    basic, eq6, hier, lowbit, quant, robust, secure, server_opt, sparse,
)
from repro_torch.core.aggregators.basic import static_layer_schedule

__all__ = [
    "AggContext",
    "Aggregator",
    "gather_clients",
    "get",
    "names",
    "register",
    "static_layer_schedule",
]
