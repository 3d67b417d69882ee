"""repro_torch.plan — the FFT planner (ESTIMATE and MEASURE), its plan
cache and wisdom files, ``plan_fft`` and ``execute``."""

from repro_torch.plan.api import execute, plan_fft, resolve, resolve_call
from repro_torch.plan.autotune import estimate_plan, measure_plan, variant_candidates
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
    "PlanCache",
    "ProblemKey",
    "default_cache",
    "estimate_plan",
    "execute",
    "measure_plan",
    "plan_fft",
    "problem_key",
    "reset_default_cache",
    "resolve",
    "resolve_call",
    "variant_candidates",
]
