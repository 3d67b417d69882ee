"""repro_torch.plan — the FFT planner (ESTIMATE and MEASURE), its plan
cache and wisdom files, ``plan_fft`` and ``execute``, and the pencil's
``chunk_candidates``.

``PLAN_VARIANTS`` is the reference's deprecation alias of the engine list:
the single-precision engines of the live registry, read at each access."""

from repro_torch.engines.registry import PRECISIONS
from repro_torch.plan.api import execute, plan_fft, resolve, resolve_call
from repro_torch.plan.autotune import (
    chunk_candidates,
    estimate_plan,
    measure_plan,
    oaconv_tile_candidates,
    variant_candidates,
)
from repro_torch.plan.cache import PlanCache, default_cache, reset_default_cache
from repro_torch.plan.plan import (
    DIRECTIONS,
    KINDS,
    NORMS,
    PLAN_SCHEMA_VERSION,
    FFTPlan,
    ProblemKey,
    problem_key,
)

__all__ = [
    "DIRECTIONS",
    "FFTPlan",
    "KINDS",
    "NORMS",
    "PLAN_SCHEMA_VERSION",
    "PLAN_VARIANTS",
    "PRECISIONS",
    "PlanCache",
    "ProblemKey",
    "chunk_candidates",
    "default_cache",
    "estimate_plan",
    "execute",
    "measure_plan",
    "oaconv_tile_candidates",
    "plan_fft",
    "problem_key",
    "reset_default_cache",
    "resolve",
    "resolve_call",
    "variant_candidates",
]


def __getattr__(name: str):
    if name == "PLAN_VARIANTS":
        from repro_torch.engines import registered_variants

        return registered_variants(precision="single")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
