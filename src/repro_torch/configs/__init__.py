"""Assigned architecture registry (``--arch <id>``).

Port of ``repro.configs``: the same eleven configurations, as data.
"""

from repro_torch.configs.registry import (
    ALL_IDS,
    ARCH_IDS,
    SHAPES,
    get_config,
    input_specs,
    shape_skips,
    smoke_config,
)

__all__ = [
    "ALL_IDS",
    "ARCH_IDS",
    "SHAPES",
    "get_config",
    "input_specs",
    "shape_skips",
    "smoke_config",
]
