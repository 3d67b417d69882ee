"""Planner entry points: ``resolve_call`` and ``resolve``.

Port of ``repro.plan.api`` (the resolution half). Every ``repro_torch.xfft``
transform resolves its call here, and ``repro_torch.imaging.oaconvolve2``
its overlap-save tile (kind ``oaconv2d``): the plan cache first, then the scoped
``repro_torch.xfft.config`` overrides, then ESTIMATE on a miss. Nothing
here runs the transform: the front door calls the chosen engine directly.
There is no circuit breaker in this port yet, and MEASURE waits.

Every resolution emits one ``plan.resolve`` event with the reference's
fields and bumps ``plan.resolve.<outcome>``; a MEASURE request that needs
no timing (a forced variant, an analytic-only kind) is recorded as a
``plan.degrade`` event and ``plan.degrade.<reason>`` counter, as the
reference records it, and planned by ESTIMATE.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.plan.autotune import estimate_plan
from repro_torch.plan.cache import PlanCache, default_cache
from repro_torch.plan.plan import FFTPlan, ProblemKey, problem_key

__all__ = ["resolve", "resolve_call"]

#: Kinds the reference plans analytically whatever the mode: oaconv2d tile
#: choice is a closed-form working-set trade-off (pencil kinds wait).
_ESTIMATE_ONLY_KINDS = ("fft2d_pencil", "oaconv2d")


def _degrade_event(key: ProblemKey, reason: str) -> str:
    """Emit and count a MEASURE -> ESTIMATE degrade; returns ``reason``."""
    obs.emit("plan.degrade", kind=key.kind, shape=key.shape, direction=key.direction,
             reason=reason)
    obs.count(f"plan.degrade.{reason}")
    return reason


def _resolve_event(entry: str, key: ProblemKey, mode: str, outcome: str, plan: FFTPlan,
                   cache: Optional[PlanCache]) -> None:
    """One ``plan.resolve`` event per planner decision (+ outcome counter).

    ``outcome`` is the cache verdict: ``"hit"`` (cached plan served),
    ``"miss"`` (fresh ESTIMATE) or ``"forced"`` (a scoped variant pin
    replaced the planned engine).
    """
    obs.count(f"plan.resolve.{outcome}")
    obs.emit(
        "plan.resolve",
        entry=entry,
        kind=key.kind,
        shape=key.shape,
        dtype=key.dtype,
        direction=key.direction,
        precision=key.precision,
        backend=key.backend,
        mode=mode,
        outcome=outcome,
        variant=plan.variant,
        plan_mode=plan.mode,
        est_time_s=plan.est_time_s,
        measured_us=plan.measured_us,
        degrade_reason=plan.degrade_reason,
        cache_path=getattr(cache, "path", None),
        key=key.cache_key(),
    )


def resolve_call(
    kind: str,
    shape: Tuple[int, ...],
    device: torch.device,
    dtype: str = "complex64",
    n_devices: int = 1,
    cache: Optional[PlanCache] = None,
    direction: str = "fwd",
    axes: Optional[Tuple[int, ...]] = None,
    mode: Optional[str] = "estimate",
) -> FFTPlan:
    """Resolve one transform call on ``device`` to a concrete plan.

    1. The active :func:`repro_torch.xfft.config` scope supplies the
       precision and the engine-backend restriction, which are part of the
       problem key.
    2. Cache hit -> the cached plan. Miss -> ESTIMATE, cached in memory.
       ``mode="measure"`` raises until MEASURE is ported, except where the
       reference would not time either (a forced variant, an analytic-only
       kind): there it degrades to ESTIMATE and says so (``plan.degrade``).
    3. A scoped ``variant=...`` replaces the planned engine; the returned
       plan is marked ``mode="forced"`` and is never cached.
    """
    from repro_torch.xfft._config import check_mode, get_config  # lazy: xfft builds on plan

    cfg = get_config()
    mode = "estimate" if mode is None else mode
    cache = cache if cache is not None else default_cache()
    key = problem_key(kind, shape, device, dtype, n_devices, direction, axes,
                      precision=cfg.precision, backends=cfg.backends)
    degrade = None
    if mode == "measure" and cfg.variant is not None:
        degrade = _degrade_event(key, "forced_variant")
    elif mode == "measure" and kind in _ESTIMATE_ONLY_KINDS:
        degrade = _degrade_event(key, "estimate_only_kind")
    else:
        check_mode(mode)
    plan = cache.get(key)
    outcome = "hit" if plan is not None else "miss"
    if plan is None:
        fresh = estimate_plan(key)
        if degrade is not None:
            fresh = dataclasses.replace(fresh, degrade_reason=degrade)
        plan = cache.put(fresh)
    if cfg.variant is not None and cfg.variant != plan.variant:
        plan = dataclasses.replace(plan, variant=cfg.variant, mode="forced", measured_us=None,
                                   degrade_reason=degrade)
        outcome = "forced"
    _resolve_event("resolve_call", key, mode, outcome, plan, cache)
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
