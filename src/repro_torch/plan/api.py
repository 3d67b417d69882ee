"""Planner entry points: ``resolve_call`` and ``resolve``.

Port of ``repro.plan.api`` (the resolution half). Every ``repro_torch.xfft``
transform resolves its call here, and ``repro_torch.imaging.oaconvolve2``
its overlap-save tile (kind ``oaconv2d``): the plan cache first, then the scoped
``repro_torch.xfft.config`` overrides, then ESTIMATE on a miss. Nothing
here runs the transform: the front door calls the chosen engine directly.
There is no circuit breaker in this port yet, and MEASURE waits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.plan.autotune import estimate_plan
from repro_torch.plan.cache import PlanCache, default_cache
from repro_torch.plan.plan import FFTPlan, problem_key

__all__ = ["resolve", "resolve_call"]


def resolve_call(
    kind: str,
    shape: Tuple[int, ...],
    device: torch.device,
    dtype: str = "complex64",
    n_devices: int = 1,
    cache: Optional[PlanCache] = None,
    direction: str = "fwd",
    axes: Optional[Tuple[int, ...]] = None,
    mode: str = "estimate",
) -> FFTPlan:
    """Resolve one transform call on ``device`` to a concrete plan.

    1. The active :func:`repro_torch.xfft.config` scope supplies the
       engine-backend restriction, which is part of the problem key.
    2. Cache hit -> the cached plan. Miss -> ESTIMATE, cached in memory.
       ``mode="measure"`` raises until MEASURE is ported.
    3. A scoped ``variant=...`` replaces the planned engine; the returned
       plan is marked ``mode="forced"`` and is never cached.
    """
    from repro_torch.xfft._config import check_mode, get_config  # lazy: xfft builds on plan

    check_mode(mode)
    cfg = get_config()
    cache = cache if cache is not None else default_cache()
    key = problem_key(kind, shape, device, dtype, n_devices, direction, axes,
                      backends=cfg.backends)
    plan = cache.get(key)
    if plan is None:
        plan = cache.put(estimate_plan(key))
    if cfg.variant is not None and cfg.variant != plan.variant:
        plan = dataclasses.replace(plan, variant=cfg.variant, mode="forced")
    return plan


def resolve(
    kind: str,
    shape: Tuple[int, ...],
    device: torch.device,
    dtype: str = "complex64",
    n_devices: int = 1,
    cache: Optional[PlanCache] = None,
    direction: str = "fwd",
) -> FFTPlan:
    """:func:`resolve_call` under the kind's canonical axes."""
    return resolve_call(kind, shape, device, dtype, n_devices, cache, direction)
