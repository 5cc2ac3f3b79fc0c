"""Pluggable aggregation strategies (port of ``repro/core/aggregators``).

Importing this package registers the ported modes: dense | eq6 |
static_topn. ``get(name)`` resolves a FedConfig aggregation name to its
strategy class; ``names()`` lists what is available. The fedsgd topology,
quant8, hier, the server optimizers, trimmed_mean and the communication
frontier (topk_ef, quant4, secure) belong to later slices.
"""
from repro_torch.core.aggregators.base import AggContext, Aggregator, get, names, register
from repro_torch.core.aggregators import basic, eq6  # noqa: F401,E402 (registration)
from repro_torch.core.aggregators.basic import static_layer_schedule

__all__ = [
    "AggContext",
    "Aggregator",
    "get",
    "names",
    "register",
    "static_layer_schedule",
]
