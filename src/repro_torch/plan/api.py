"""Planner entry points: ``plan_fft`` / ``execute`` / ``resolve_call``.

Port of ``repro.plan.api``. ``plan_fft`` is the explicit front door (pick
a mode, get a plan, it is cached — and saved when the cache is
file-backed). ``resolve_call`` is the implicit one: every
``repro_torch.xfft`` transform resolves its call here, and
``repro_torch.imaging.oaconvolve2`` its overlap-save tile (kind
``oaconv2d``): the plan cache first, then the scoped
``repro_torch.xfft.config`` overrides (a forced variant, a measure-on-miss
mode, a wisdom directory), ESTIMATE on a miss. ``execute`` runs a plan;
the single-device kinds go through the degradation ladder
(``repro_torch.resilience.run_plan``), as the front door's transforms do.

Every resolution emits one ``plan.resolve`` event with the reference's
fields and bumps ``plan.resolve.<outcome>``; a MEASURE request that cannot
or need not time (a forced variant, an analytic-only kind, a quarantined
engine, a CUDA graph being captured) is recorded as a ``plan.degrade``
event and ``plan.degrade.<reason>`` counter and planned by ESTIMATE.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.plan.autotune import estimate_plan, measure_plan
from repro_torch.plan.cache import PlanCache, default_cache
from repro_torch.plan.plan import FFTPlan, ProblemKey, problem_key
from repro_torch.resilience.breaker import quarantine
from repro_torch.resilience.ladder import run_plan

__all__ = ["execute", "plan_fft", "resolve", "resolve_call"]

#: Kinds whose MEASURE mode degrades to ESTIMATE: pencil problems need a
#: live mesh to time; oaconv2d tile choice is analytic by construction.
_ESTIMATE_ONLY_KINDS = ("fft2d_pencil", "oaconv2d")


def _device(device) -> torch.device:
    """``device``, or the card when none is given (raises without CUDA)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.plan plans for torch.device('cuda') unless given a device, and "
            "CUDA is not available; pass device='cpu' to plan for the CPU"
        )
    return torch.device("cuda")


def plan_fft(
    kind: str,
    shape: Tuple[int, ...],
    device=None,
    dtype: str = "complex64",
    mode: str = "estimate",
    n_devices: int = 1,
    cache: Optional[PlanCache] = None,
    force: bool = False,
    measure_iters: int = 5,
    timings_out: Optional[Dict[str, float]] = None,
    direction: str = "fwd",
    axes: Optional[Tuple[int, ...]] = None,
    precision: str = "single",
    backends: Tuple[str, ...] = (),
) -> FFTPlan:
    """Plan one FFT problem on ``device`` (default: the card); consult the
    cache first unless ``force``.

    ``mode="estimate"`` is analytic and instant; ``mode="measure"`` times
    every candidate engine on the device (CUDA events on the card;
    ``oaconv2d`` tile selection and pencil problems stay analytic). A
    MEASURE result replaces a cached ESTIMATE plan for the same key.
    File-backed caches are saved after every new plan, so a second
    process re-tunes nothing.

    ``direction``, ``axes``, ``precision`` and ``backends`` are part of
    the key, as in the reference; the ``norm`` convention is not.
    """
    if mode not in ("estimate", "measure"):
        raise ValueError(f"mode must be 'estimate' or 'measure', got {mode!r}")
    cache = cache if cache is not None else default_cache()
    key = problem_key(kind, shape, _device(device), dtype, n_devices, direction, axes,
                      precision, backends)
    effective_mode = "estimate" if kind in _ESTIMATE_ONLY_KINDS else mode
    degrade = (_degrade_event(key, "estimate_only_kind")
               if mode == "measure" and effective_mode != "measure" else None)
    if not force:
        hit = cache.get(key)
        if hit is not None and (effective_mode == "estimate" or hit.mode == "measure"):
            _resolve_event("plan_fft", key, mode, "hit", hit, cache)
            return hit
    if effective_mode == "measure":
        plan = measure_plan(key, iters=measure_iters, timings_out=timings_out)
        outcome = "measured"
    else:
        plan = estimate_plan(key)
        outcome = "miss"
        if degrade is not None:
            plan = dataclasses.replace(plan, degrade_reason=degrade)
    cache.put(plan)
    if cache.path:
        cache.save()
    _resolve_event("plan_fft", key, mode, outcome, plan, cache)
    return plan


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
    ``"miss"`` (fresh ESTIMATE), ``"measured"`` (a timed sweep ran),
    ``"quarantined"`` (a cached plan's engine is benched: re-resolved
    around it) or ``"forced"`` (a scoped variant pin replaced the planned
    engine).
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


#: PlanCache instances memoized per config ``cache_dir`` so repeated calls
#: under the same scope accumulate hits in ONE cache (and one wisdom file).
_DIR_CACHES: Dict[str, PlanCache] = {}


def _cache_for_dir(cache_dir: str) -> PlanCache:
    path = os.path.join(cache_dir, "xfft_plans.json")
    cache = _DIR_CACHES.get(path)
    if cache is None:
        cache = _DIR_CACHES.setdefault(path, PlanCache(path=path))
    return cache


def _trace_safe() -> bool:
    """True when MEASURE may run and time kernels here: the port's
    counterpart of the reference's jit-trace check. False while the
    current CUDA stream is capturing a graph (timing inside a capture is
    illegal) or while the compiler (``torch.compiler``) traces the call."""
    if torch.compiler.is_compiling():
        return False
    return not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def resolve_call(
    kind: str,
    shape: Tuple[int, ...],
    device: torch.device,
    dtype: str = "complex64",
    n_devices: int = 1,
    cache: Optional[PlanCache] = None,
    direction: str = "fwd",
    axes: Optional[Tuple[int, ...]] = None,
    mode: Optional[str] = None,
) -> FFTPlan:
    """Resolve one transform call on ``device`` to a concrete plan.

    1. The active :func:`repro_torch.xfft.config` scope supplies defaults:
       its ``cache_dir`` selects the wisdom cache
       (``<cache_dir>/xfft_plans.json``, else the process-wide default
       cache), its ``mode`` decides what a cache miss costs (``mode=None``
       reads it), and its precision and backend restriction are part of
       the problem key.
    2. Cache hit -> the cached plan. Miss -> ESTIMATE, cached in memory.
       ``mode="measure"`` upgrades misses and cached ESTIMATE plans to a
       timed sweep, saved when the cache is file-backed — but not while a
       CUDA graph is being captured (``trace_not_clean``), under a forced
       variant, for an analytic-only kind, or while an engine is
       quarantined for the key: those degrade to ESTIMATE and say so. A
       ``measure_timeout`` plan is not swept again
       (``plan_fft(force=True)`` re-tunes).
    3. A scoped ``variant=...`` replaces the planned engine; the returned
       plan is marked ``mode="forced"`` and is never cached.

    Resilience: a cached plan whose engine is quarantined for this key is
    not served — the call re-resolves with the benched engine excluded
    (outcome ``"quarantined"``), and a plan made while a breaker is open
    for the key stays out of the cache: the planned engine comes back the
    moment its breaker closes.
    """
    from repro_torch.xfft._config import get_config  # lazy: xfft builds on plan

    cfg = get_config()
    if cache is None:
        cache = _cache_for_dir(cfg.cache_dir) if cfg.cache_dir else default_cache()
    key = problem_key(kind, shape, device, dtype, n_devices, direction, axes,
                      precision=cfg.precision, backends=cfg.backends)
    mode = mode if mode is not None else cfg.mode
    breaker = quarantine()
    plan = cache.get(key)
    hit = plan is not None
    quarantined = hit and breaker.excluded(plan.variant, key)
    if quarantined:
        plan = None  # re-resolve around the benched engine
    affected = quarantined or breaker.affects(key)
    degrade = None
    if mode == "measure" and (plan is None or plan.mode != "measure"):
        if cfg.variant is not None:
            degrade = "forced_variant"
        elif kind in _ESTIMATE_ONLY_KINDS:
            degrade = "estimate_only_kind"
        elif affected:
            # Sweeping while an engine is benched would tune (and save)
            # wisdom over a temporarily reduced engine population.
            degrade = "engine_quarantined"
    want_measure = (
        mode == "measure"
        and degrade is None
        and (plan is None or plan.mode != "measure")
        and (plan is None or plan.degrade_reason != "measure_timeout")
    )
    measured = False
    if want_measure and not _trace_safe():
        degrade = "trace_not_clean"
        want_measure = False
    if degrade is not None:
        _degrade_event(key, degrade)
    if want_measure:
        plan = cache.put(measure_plan(key))
        measured = True
        if cache.path:
            cache.save()
    elif plan is None:
        # ESTIMATE results stay in memory only: they are free to recompute,
        # and a whole-file save here could clobber wisdom another process
        # measured into the same file after this one loaded it.
        fresh = estimate_plan(key)
        if degrade is not None:
            fresh = dataclasses.replace(fresh, degrade_reason=degrade)
        plan = fresh if affected else cache.put(fresh)
    if cfg.variant is not None and cfg.variant != plan.variant:
        plan = dataclasses.replace(plan, variant=cfg.variant, mode="forced", measured_us=None,
                                   degrade_reason=degrade)
        _resolve_event("resolve_call", key, mode, "forced", plan, cache)
        return plan
    outcome = ("quarantined" if quarantined else "measured" if measured
               else "hit" if hit else "miss")
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


def execute(plan: FFTPlan, x, mesh=None, axis: str = "data"):
    """Run ``x`` (transform axes last) through the transform ``plan`` was
    made for.

    The single-device kinds run the plan's engine through the degradation
    ladder (:func:`repro_torch.resilience.run_plan`): an engine failure is
    quarantined and the call retries the next-best healthy rung. An
    ``oaconv2d`` plan takes ``x=(image, kernel)`` and runs
    ``repro_torch.imaging.tiled.oaconvolve2`` on the plan's tile. An
    ``fft2d_stream`` plan runs ``repro_torch.core.fft2d.fft2_stream`` under
    the plan's variant and unroll, through the ladder too. An
    ``fft2d_pencil`` plan runs
    ``repro_torch.core.distributed.fft2_pencil_overlapped`` on ``mesh``
    along ``axis`` under the plan's variant and chunks (no ladder, as in
    the reference), and raises ``ValueError`` without a mesh. A tensor runs
    on its own device; other input goes to the card.
    """
    kind = plan.key.kind
    if kind in ("fft1d", "fft2d", "rfft1d", "rfft2d"):
        from repro_torch.engines import get_engine
        from repro_torch.xfft._transforms import _as_tensor

        x = _as_tensor(x)
        direction = plan.key.direction
        return run_plan(plan, lambda v: get_engine(v).op(kind, direction)(x))
    if kind == "oaconv2d":
        if not (isinstance(x, (tuple, list)) and len(x) == 2):
            raise ValueError("execute() needs x=(image, kernel) for an oaconv2d plan")
        from repro_torch.imaging.tiled import oaconvolve2

        image, kernel = x
        return oaconvolve2(image, kernel, tile=plan.tile)
    if kind == "fft2d_stream":
        from repro_torch.core.fft2d import fft2_stream  # lazy: core imports plan lazily
        from repro_torch.xfft._transforms import _as_tensor

        x = _as_tensor(x)
        return run_plan(plan, lambda v: fft2_stream(x, variant=v, unroll=plan.unroll))
    if kind == "fft2d_pencil":
        if mesh is None:
            raise ValueError("execute() needs mesh=... for a pencil plan")
        from repro_torch.core.distributed import fft2_pencil_overlapped  # lazy: core imports plan

        return fft2_pencil_overlapped(x, mesh, axis=axis, variant=plan.variant,
                                      chunks=plan.chunks)
    raise ValueError(f"plan has unknown kind {kind!r}")
