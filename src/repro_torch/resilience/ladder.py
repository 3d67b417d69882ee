"""The degradation ladder: every transform call lands somewhere.

Port of ``repro.resilience.ladder``. ``run_plan`` wraps the engine
dispatch of every ``repro_torch.xfft`` transform and of
``repro_torch.plan.execute``. When the planned engine raises, the failure
is recorded in the quarantine breaker (:mod:`.breaker`), a
``resilience.failover`` obs event names the benched engine, and the call
retries on the next-best healthy rung — ranked by the same analytic
ESTIMATE model the planner uses — down to the bottom of the planner's
candidates (``repro_torch.plan.autotune.variant_candidates``). On a CPU
tensor that bottom is the always-works plain schedules (``stockham``,
and ``reference_x64`` at double), as in the reference.

On the card the rungs are the planner's candidates for a CUDA key: the
hand-written kernels, ``fused_r4`` then ``fused`` (``reference_x64`` at
double precision). When every rung has failed the last error is raised;
the ladder never lands on the plain ``torch`` schedules on a CUDA tensor
unless the scope asked for ``xfft.config(backend="torch")``. This is a
divergence from the reference, whose ladder bottoms out at its jnp
engines on every device (ROADMAP queue 3). The ladder sees what a launch
reports (a build failure, an argument check, a launch the card refuses),
not a fault that surfaces at a later synchronisation: its success path
never waits for the card.

The opt-in output-health guard (``xfft.config(check_health="nan")``)
treats a non-finite output the same way: the producing engine takes a
failure, the call retries one rung down. On the card the check is one
wait for the card a call, paid only under the guard; inside a CUDA
graph capture, where no wait is legal, it reads nothing and counts the
output healthy, as the reference does a traced one. If every rung
yields non-finite values the last output is returned as-is — at that
point the *input* is poisoned and no engine can do better.

Forced plans (``xfft.config(variant=...)``) bypass the ladder entirely:
a pin is an explicit opinion, and tests that pin an engine must observe
exactly that engine, faults and all.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Set

from repro_torch import obs
from repro_torch.kernels._launch import NoBackward
from repro_torch.resilience import faults
from repro_torch.resilience.breaker import quarantine

__all__ = ["run_plan"]


def _check_health_enabled() -> bool:
    from repro_torch.xfft._config import get_config  # lazy: xfft sits above plan

    return get_config().check_health == "nan"


def _is_finite(out: Any) -> bool:
    """False only when ``out`` is a tensor holding a non-finite value
    (on the card: one wait for the card). Any other payload counts as
    healthy, and so does every output while a CUDA graph is captured or
    ``torch.compiler`` traces the call (``plan.api._trace_safe``): its
    values cannot be read there, as the reference counts a tracer
    healthy."""
    import torch  # lazy: the ladder module itself needs no torch

    from repro_torch.plan.api import _trace_safe  # lazy: plan sits above resilience

    if not isinstance(out, torch.Tensor) or not _trace_safe():
        return True
    return bool(torch.isfinite(out).all())


def _engine_meta(variant: str):
    """(backend, x64) for a registered engine, (None, None) for a name the
    registry does not know. ``x64`` is true for the double-precision
    engine (backend ``"x64"``): the port has no ``requires_x64`` field."""
    from repro_torch.engines import get_engine

    try:
        spec = get_engine(variant)
    except Exception:
        return None, None
    return spec.backend, spec.backend == "x64"


def _next_rung(key, attempted: Set[str]) -> Optional[str]:
    """Best untried healthy engine for ``key``, or None at the bottom.

    Candidates come from the planner's own quarantine-filtered
    enumeration, ranked by the analytic ESTIMATE model — the failover
    plan is exactly the plan the planner would have made without the
    benched engine.
    """
    from repro_torch.plan.autotune import fastest_variant, variant_candidates

    try:
        names = [v for v in variant_candidates(key) if v not in attempted]
    except (ValueError, NotImplementedError):
        return None
    if not names:
        return None
    return fastest_variant(key, names)[0]


def run_plan(plan, runner: Callable[[str], Any]):
    """Run ``runner(variant)`` with failover down the engine ladder.

    ``runner`` executes the transform under a named engine (a closure
    over the input tensor). Success records into the breaker — closing
    any half-open probe for (engine, key) — and returns. Failure
    quarantines the engine for this problem key and retries the
    next-best rung; when no rung remains the last error propagates.
    """
    key = plan.key
    if plan.mode == "forced":
        # Pinned engines are exempt from injection and failover alike:
        # the scope asked for this engine, so this engine is the answer.
        # The dispatch span still fires, for the flight recorder and the
        # calibration ledger like any other.
        backend, x64 = _engine_meta(plan.variant)
        with obs.span(
            "engine.apply", engine=plan.variant, backend=backend,
            kind=key.kind, direction=key.direction,
            shape=key.shape, precision=key.precision, x64=x64,
        ) as sp:
            out = runner(plan.variant)
            sp["ok"] = True
        return out
    breaker = quarantine()
    variant = plan.variant
    attempted: Set[str] = set()
    check_health = _check_health_enabled()
    unhealthy_out = None
    while True:
        reason = "error"
        err: Optional[BaseException] = None
        try:
            # Injected pre-dispatch failures (error/latency/vmem) fire
            # OUTSIDE the span: a fault that prevented the engine from
            # running must not pollute its observed-duration population.
            faults.maybe_fail(
                "engine.apply", engine=variant, kind=key.kind,
                direction=key.direction,
            )
            backend, x64 = _engine_meta(variant)
            with obs.span(
                "engine.apply", engine=variant, backend=backend,
                kind=key.kind, direction=key.direction, shape=key.shape,
                precision=key.precision, x64=x64,
            ) as sp:
                out = faults.maybe_corrupt(
                    "engine.apply", runner(variant), engine=variant,
                    kind=key.kind, direction=key.direction,
                )
                sp["ok"] = True
            if not check_health or _is_finite(out):
                breaker.record_success(variant, key)
                return out
            reason = "nonfinite"
            unhealthy_out = out
        except NoBackward:
            raise  # the caller differentiates through a kernel: no engine would do better
        except Exception as e:  # noqa: BLE001 — the ladder exists to catch
            err = e
        attempted.add(variant)
        opened = breaker.record_failure(variant, key, error=repr(err or reason))
        nxt = _next_rung(key, attempted)
        obs.emit(
            "resilience.failover",
            engine=variant,
            kind=key.kind,
            shape=key.shape,
            direction=key.direction,
            reason=reason,
            error=repr(err) if err is not None else None,
            next=nxt,
            quarantined=opened,
        )
        obs.count("resilience.failover")
        if nxt is None:
            if err is not None:
                raise err
            # Non-finite on the bottom rung: the input itself is poisoned;
            # returning the output beats raising for a health *guard*.
            return unhealthy_out
        variant = nxt
