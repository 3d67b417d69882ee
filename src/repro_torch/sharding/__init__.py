"""Sharding rules and the activation-sharding context (port of
``repro.sharding``), with ``to_placements`` for ``torch.distributed.tensor``."""

from repro_torch.compat import to_placements
from repro_torch.sharding.rules import (
    batch_specs,
    cache_specs,
    dp_axes,
    param_rules,
)

__all__ = ["batch_specs", "cache_specs", "dp_axes", "param_rules", "to_placements"]
