"""repro_torch.engines — the FFT engine registry the planner schedules.

Importing this package registers the built-in engines and the
double-precision ``reference_x64`` engine.
"""

from repro_torch.engines.registry import (
    PRECISIONS,
    CostHints,
    EngineSpec,
    get_engine,
    has_engine,
    iter_engines,
    register_alias,
    register_engine,
    registered_backends,
    registered_variants,
)
from repro_torch.engines import builtin as _builtin  # noqa: F401
from repro_torch.engines import x64 as _x64  # noqa: F401

__all__ = [
    "PRECISIONS",
    "CostHints",
    "EngineSpec",
    "get_engine",
    "has_engine",
    "iter_engines",
    "register_alias",
    "register_engine",
    "registered_backends",
    "registered_variants",
]
