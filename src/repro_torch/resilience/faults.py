"""Deterministic fault injection: seeded chaos for every seam that matters.

Port of ``repro.resilience.faults``, with the same vocabulary: a
:class:`FaultPlan` written against the reference reads the same here, and
the same seed fires on the same consultations. A :class:`FaultPlan` is a
frozen, seeded schedule of faults aimed at named seams; scope it with
``repro_torch.xfft.config(faults=FaultPlan(...))`` (contextvars-based) and
every chaos run replays identically.

Seams (the places the rest of the port consults this module):

* ``engine.apply``     — the degradation ladder's engine dispatch
                         (``repro_torch.resilience.ladder.run_plan``):
                         error / latency / vmem faults raise or stall
                         before the engine runs; nan/inf faults poison its
                         output.
* ``plan.measure``     — each MEASURE candidate
                         (``repro_torch.plan.autotune``): latency faults
                         trip the per-candidate wall-clock budget, error
                         faults crash the candidate.
* ``plan.cache.load``  — wisdom-file reads (``PlanCache.load``): error
                         faults are accounted as ``file_error`` loads.
* ``plan.cache.save``  — wisdom-file writes (``PlanCache.save``): error
                         faults drive the read-only degrade path.
* ``kernel.fused``     — the 2D kernel entries' whole-frame decision
                         (``repro_torch.kernels.ops``): a vmem fault stands
                         for a frame over the shared-memory census and
                         forces the composed route (rows, an HBM corner
                         turn, columns), both routes hand-written kernels.
* ``serve.batch``      — one batched group execution in the serve layer:
                         error faults drive the bounded-retry path,
                         latency faults eat the request deadline.

The ``vmem`` mode keeps the reference's name. On the card it stands for
the shared-memory census: the message it raises reads like CUDA's launch
refusal.

Every fired fault emits a ``resilience.fault`` obs event and bumps the
``resilience.fault.<mode>`` counter, so a chaos run's injection schedule
is itself observable. With no plan in scope every hook is a single
contextvar read — the hot path stays clean.

This module imports only :mod:`repro_torch.obs` and the standard library;
plan, engines, kernels and serve all consult it without cycles.
"""

from __future__ import annotations

import contextvars
import dataclasses
import random
import threading
import time
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch import obs

__all__ = [
    "FAULT_MODES",
    "FAULT_SEAMS",
    "FaultPlan",
    "FaultSpec",
    "FaultState",
    "InjectedFault",
    "active_faults",
    "maybe_corrupt",
    "maybe_fail",
    "push_faults",
    "pop_faults",
    "vmem_exhausted",
]

#: Seams a FaultSpec may target (validated at construction so a typo'd
#: seam fails when the plan is built, not by silently never firing).
FAULT_SEAMS = (
    "engine.apply",
    "plan.measure",
    "plan.cache.load",
    "plan.cache.save",
    "kernel.fused",
    "serve.batch",
)

#: What a fired fault does: raise (error), stall (latency), poison the
#: output payload (nan/inf), or report shared-memory exhaustion (vmem).
FAULT_MODES = ("error", "latency", "nan", "inf", "vmem")


class InjectedFault(RuntimeError):
    """The exception a fired ``error``/``vmem`` fault raises at its seam.

    Deliberately a distinct type: resilience tests assert the *recovery*
    machinery (ladder, retry, readonly degrade) handled exactly the fault
    that was scheduled, not some unrelated failure.
    """

    def __init__(self, seam: str, mode: str, message: str):
        super().__init__(message)
        self.seam = seam
        self.mode = mode


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: where it fires, what it does, how often.

    seam      — one of :data:`FAULT_SEAMS`.
    mode      — one of :data:`FAULT_MODES`.
    p         — firing probability per consultation (1.0 = always); draws
                come from the plan's seeded RNG, so a chaos run replays.
    times     — total fire budget (``None`` = unlimited): ``times=1``
                injects exactly one failure, the shape the acceptance
                test uses to watch a breaker open and then close.
    match     — context filter: only fire when every (field, value) pair
                matches the seam's call context (e.g. ``{"engine":
                "fused_r4"}`` aims at one engine). Dicts are normalized
                to a sorted tuple so specs stay hashable.
    latency_s — stall duration for ``latency`` faults.
    message   — override for the injected exception text.
    """

    seam: str
    mode: str = "error"
    p: float = 1.0
    times: Optional[int] = None
    match: Union[dict, Tuple[Tuple[str, Any], ...]] = ()
    latency_s: float = 0.05
    message: Optional[str] = None

    def __post_init__(self):
        if self.seam not in FAULT_SEAMS:
            raise ValueError(
                f"unknown fault seam {self.seam!r}; want one of {FAULT_SEAMS}"
            )
        if self.mode not in FAULT_MODES:
            raise ValueError(
                f"unknown fault mode {self.mode!r}; want one of {FAULT_MODES}"
            )
        if not 0.0 < self.p <= 1.0:
            raise ValueError(f"fault probability must be in (0, 1], got {self.p}")
        if self.times is not None and self.times < 1:
            raise ValueError(f"times must be >= 1 or None, got {self.times}")
        if isinstance(self.match, dict):
            object.__setattr__(
                self, "match", tuple(sorted(self.match.items()))
            )
        else:
            object.__setattr__(self, "match", tuple(self.match))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A frozen, seeded schedule of :class:`FaultSpec` faults.

    Hashable by construction (it rides on the frozen
    ``repro_torch.xfft.XFFTConfig``); all mutable firing state lives on the
    :class:`FaultState` created when the plan enters scope, so the same
    plan object can be reused across scopes and each scope replays from
    the seed.
    """

    specs: Tuple[FaultSpec, ...] = ()
    seed: int = 0

    def __post_init__(self):
        if isinstance(self.specs, FaultSpec):
            object.__setattr__(self, "specs", (self.specs,))
        else:
            object.__setattr__(self, "specs", tuple(self.specs))
        for spec in self.specs:
            if not isinstance(spec, FaultSpec):
                raise TypeError(
                    f"FaultPlan.specs wants FaultSpec entries, got {spec!r}"
                )


class FaultState:
    """Runtime firing state for one in-scope :class:`FaultPlan`.

    Holds the seeded RNG and per-spec fire counts. Thread-safe: a chaos
    run over the threaded serve layer must not double-spend a ``times``
    budget.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self._fired: Dict[int, int] = {}
        self._lock = threading.Lock()

    def fire(
        self, seam: str, modes: Tuple[str, ...], ctx: Dict[str, Any]
    ) -> Optional[FaultSpec]:
        """The first armed spec matching (seam, modes, ctx), else None.

        A returned spec has been *spent*: its fire count is bumped, its
        probability draw consumed, and a ``resilience.fault`` event
        emitted — the consultation itself is the schedule.
        """
        with self._lock:
            for i, spec in enumerate(self.plan.specs):
                if spec.seam != seam or spec.mode not in modes:
                    continue
                if spec.times is not None and self._fired.get(i, 0) >= spec.times:
                    continue
                if any(ctx.get(k) != v for k, v in spec.match):
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                self._fired[i] = self._fired.get(i, 0) + 1
                obs.emit(
                    "resilience.fault", seam=seam, mode=spec.mode,
                    fired=self._fired[i], **ctx,
                )
                obs.count(f"resilience.fault.{spec.mode}")
                return spec
        return None


_ACTIVE: contextvars.ContextVar[Optional[FaultState]] = contextvars.ContextVar(
    "repro_resilience_faults", default=None
)


def active_faults() -> Optional[FaultState]:
    """The in-scope fault state, or None when chaos is off (the default)."""
    return _ACTIVE.get()


def push_faults(plan: Optional[FaultPlan]):
    """Enter a fault scope (``repro_torch.xfft.config(faults=...)`` calls this).

    ``plan=None`` pushes a cleared scope — an inner ``faults=False``
    turns chaos off without disturbing the enclosing scope's state.
    Returns a token for :func:`pop_faults`.
    """
    state = FaultState(plan) if isinstance(plan, FaultPlan) else None
    return _ACTIVE.set(state)


def pop_faults(token) -> None:
    """Undo one :func:`push_faults` (LIFO)."""
    _ACTIVE.reset(token)


def maybe_fail(seam: str, **ctx: Any) -> None:
    """Consult the seam for error/latency/vmem faults: raise or stall.

    The no-plan cost is one contextvar read. ``error`` and ``vmem``
    faults raise :class:`InjectedFault` (vmem with the message CUDA gives
    a launch whose block asks for more shared memory than the card has);
    ``latency`` faults sleep ``latency_s`` and return.
    """
    state = _ACTIVE.get()
    if state is None:
        return
    spec = state.fire(seam, ("error", "latency", "vmem"), ctx)
    if spec is None:
        return
    if spec.mode == "latency":
        time.sleep(spec.latency_s)
        return
    if spec.mode == "vmem":
        raise InjectedFault(
            seam, "vmem",
            spec.message
            or "CUDA error: too many resources requested for launch "
            f"(injected shared-memory exhaustion at {seam} ({ctx}))",
        )
    raise InjectedFault(
        seam, "error", spec.message or f"injected fault at {seam} ({ctx})"
    )


def maybe_corrupt(seam: str, value, **ctx: Any):
    """Consult the seam for nan/inf faults: poison one output element.

    Returns ``value`` unchanged when nothing fires. The poison is a
    single non-finite element at the origin — exactly the escape the
    opt-in ``check_health="nan"`` guard exists to catch. A tensor is
    cloned on its own device and one element of the clone set, so the
    caller's tensor is untouched and nothing moves to the host.
    """
    state = _ACTIVE.get()
    if state is None:
        return value
    spec = state.fire(seam, ("nan", "inf"), ctx)
    if spec is None:
        return value
    poison = float("nan") if spec.mode == "nan" else float("inf")
    import torch  # lazy: the module stays importable without torch users

    if isinstance(value, torch.Tensor):
        out = value.clone()
        out[(0,) * out.dim()] = poison
        return out
    import numpy as np  # plain numpy (or scalar) payloads

    out = np.array(value)
    out[(0,) * out.ndim] = poison
    return out


def vmem_exhausted(seam: str, **ctx: Any) -> bool:
    """True when a ``vmem`` fault fires at this seam (non-raising form).

    The 2D kernel entries consult this beside their real shared-memory
    census, so an injected exhaustion runs the composed route without
    needing a frame that really is over the census.
    """
    state = _ACTIVE.get()
    if state is None:
        return False
    return state.fire(seam, ("vmem",), ctx) is not None
