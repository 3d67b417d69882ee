"""Context-scoped configuration for the ``repro_torch.xfft`` namespace.

Port of ``repro.xfft._config``: the fields ``variant``, ``mode``,
``precision``, ``cache_dir``, ``backend``, ``observe``, ``faults`` and
``check_health``, and the ``flight_recorder`` argument. :func:`config`
applies its overrides at once and, used as a context manager, restores the
previous configuration on exit. Scoping is :mod:`contextvars`-based, so
scopes nest and never leak between threads; the flight recorder is
process-wide state, swapped by the scope and restored on its exit.

    import repro_torch.xfft as xfft

    with xfft.config(variant="fused_r4"):   # force the CUDA kernel here
        y = xfft.rfft2(frames)
    with xfft.config(backend="torch"):      # planner may pick schedules only
        y = xfft.fft2(frames)
    with xfft.config(precision="double"):   # complex128 end to end
        y = xfft.fft2(frames)               # (the reference_x64 engine)
    with xfft.config(mode="measure", cache_dir="/srv/wisdom"):
        y = xfft.fft2(frames)               # time the kernels on a miss, save
    with xfft.config(faults=FaultPlan(FaultSpec("engine.apply",
                                                match={"engine": "fused_r4"})),
                     check_health="nan"):
        y = xfft.fft2(frames)               # fails over to the radix-2 kernel
    with xfft.config(flight_recorder=False):
        y = xfft.fft2(frames)               # the always-on recorder off here
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

from repro_torch import obs
from repro_torch.engines import get_engine, has_engine, registered_backends, registered_variants
from repro_torch.obs import telemetry as _telemetry
from repro_torch.resilience.faults import FaultPlan, pop_faults, push_faults

__all__ = ["XFFTConfig", "config", "get_config"]

#: Accepted spellings per canonical precision. "single" is the paper's
#: complex64 butterfly datapath; "double" resolves to engines registered
#: with the "double" capability (``reference_x64``), complex128 end to end.
_PRECISIONS = {
    "single": "single",
    "complex64": "single",
    "float32": "single",
    "double": "double",
    "complex128": "double",
    "float64": "double",
}

@dataclasses.dataclass(frozen=True)
class XFFTConfig:
    """One immutable configuration snapshot.

    variant   — force a registered engine for every call in scope; ``None``
                lets ``repro_torch.plan`` decide.
    mode      — what a plan-cache miss costs: ``"estimate"`` (analytic,
                instant) or ``"measure"`` (every candidate timed on the
                device, CUDA events on the card; not while a CUDA graph
                is being captured).
    precision — ``"single"`` (complex64, the paper's datapath) or
                ``"double"`` (complex128 through the ``reference_x64``
                engine); part of every plan key.
    cache_dir — directory holding the plan-wisdom file for calls in scope
                (``<cache_dir>/xfft_plans.json``); ``None`` uses the
                process-wide default cache (``$REPRO_PLAN_CACHE``). Pass
                ``""`` to :func:`config` to clear an inherited directory.
    backends  — engine-backend families the planner may consider (e.g.
                ``("torch",)``); ``()`` means all.
    observe   — observability policy for calls in scope: a
                :class:`repro_torch.obs.Trace` collects every event emitted
                in scope into that trace; ``True`` turns spans into
                ``torch.profiler`` ranges; ``False`` (the default) disables
                both. ``repro_torch.obs.capture()`` is the usual spelling;
                this field lets a long-lived scope stream into one trace.
    faults    — chaos policy for calls in scope: a
                :class:`repro_torch.resilience.FaultPlan` injects its
                seeded fault schedule into every named seam reached in
                scope; ``False`` (the default) injects nothing.
    check_health — ``"nan"`` makes the degradation ladder treat a
                non-finite transform output as an engine failure (one
                wait for the card a call); ``"off"`` (the default)
                trusts outputs.

    ``flight_recorder=`` is an argument of :func:`config`, not a field: the
    recorder is process-wide state, not part of the planning configuration.
    """

    variant: Optional[str] = None
    mode: str = "estimate"
    precision: str = "single"
    cache_dir: Optional[str] = None
    backends: Tuple[str, ...] = ()
    observe: Any = False
    faults: Any = False
    check_health: str = "off"


_ACTIVE: contextvars.ContextVar[XFFTConfig] = contextvars.ContextVar(
    "repro_torch_xfft_config", default=XFFTConfig()
)


def get_config() -> XFFTConfig:
    """The configuration currently in scope."""
    return _ACTIVE.get()


def _canon_backends(backend: Union[str, Sequence[str], None]) -> Optional[Tuple[str, ...]]:
    if backend is None:
        return None
    if backend == "auto":
        return ()
    names = (backend,) if isinstance(backend, str) else tuple(backend)
    known = registered_backends()
    for name in names:
        if name not in known:
            raise ValueError(
                f"unknown engine backend {name!r}; registered backends: {known} "
                "('auto' clears an outer restriction)"
            )
    return tuple(sorted(set(names)))


class config:
    """Set xfft configuration, globally or for a ``with`` scope.

    Unspecified fields inherit from the configuration active at call time;
    ``variant="auto"`` and ``backend="auto"`` clear an outer override.
    An explicit ``faults=`` arms a fresh seeded fault state for the scope
    (``False`` pushes a cleared one), and an explicit ``observe=`` pushes
    its policy; inheriting leaves the enclosing scope's state alone.
    ``flight_recorder`` installs a recorder for the scope: ``True`` a fresh
    default one, ``False`` none (the black box off), an int a fresh one of
    that capacity, or a :class:`repro_torch.obs.FlightRecorder`; the
    previous recorder comes back on exit.
    """

    def __init__(
        self,
        variant: Optional[str] = None,
        mode: Optional[str] = None,
        precision: Optional[str] = None,
        cache_dir: Optional[str] = None,
        backend: Union[str, Sequence[str], None] = None,
        observe: Any = None,
        faults: Any = None,
        check_health: Optional[str] = None,
        flight_recorder: Any = None,
    ):
        prev = _ACTIVE.get()
        if flight_recorder is None:
            recorder = None
        elif isinstance(flight_recorder, bool):
            recorder = _telemetry.FlightRecorder() if flight_recorder else None
        elif isinstance(flight_recorder, int):
            recorder = _telemetry.FlightRecorder(capacity=flight_recorder)
        elif isinstance(flight_recorder, _telemetry.FlightRecorder):
            recorder = flight_recorder
        else:
            raise ValueError(
                f"flight_recorder must be a repro_torch.obs.FlightRecorder, True (fresh "
                f"default recorder), False (off), an int capacity, or None (inherit); "
                f"got {flight_recorder!r}"
            )
        if observe is not None and not isinstance(observe, (bool, obs.Trace)):
            raise ValueError(
                f"observe must be a repro_torch.obs.Trace, True (profiler ranges), False "
                f"(off) or None (inherit); got {observe!r}"
            )
        if faults is not None and faults is not False and not isinstance(faults, FaultPlan):
            raise ValueError(
                f"faults must be a repro_torch.resilience.FaultPlan, False (off) or None "
                f"(inherit); got {faults!r}"
            )
        if check_health is not None and check_health not in ("nan", "off"):
            raise ValueError(
                f'check_health must be "nan", "off" or None (inherit); got {check_health!r}'
            )
        clear_variant = variant == "auto"
        if variant is not None and not clear_variant and not has_engine(variant):
            raise ValueError(
                f"unknown variant {variant!r}; registered engines: "
                f"{registered_variants()}, 'auto' to clear an outer override, "
                "or None to inherit"
            )
        if mode is not None and mode not in ("estimate", "measure"):
            raise ValueError(f"mode must be 'estimate' or 'measure', got {mode!r}")
        if precision is not None:
            if precision not in _PRECISIONS:
                raise ValueError(
                    f"unsupported precision {precision!r}; want a spelling of one of "
                    f"{sorted(set(_PRECISIONS.values()))} (accepted: {sorted(_PRECISIONS)})"
                )
            precision = _PRECISIONS[precision]
        backends = _canon_backends(backend)
        merged = XFFTConfig(
            variant=None if clear_variant else (variant if variant is not None else prev.variant),
            mode=mode if mode is not None else prev.mode,
            precision=precision if precision is not None else prev.precision,
            # "" clears an inherited directory; None inherits, as for every field.
            cache_dir=(None if cache_dir == "" else
                       cache_dir if cache_dir is not None else prev.cache_dir),
            backends=backends if backends is not None else prev.backends,
            observe=observe if observe is not None else prev.observe,
            faults=faults if faults is not None else prev.faults,
            check_health=check_health if check_health is not None else prev.check_health,
        )
        # A forced variant must be capable of the scope's precision, or a
        # double scope would compute in complex64 against its contract.
        if merged.variant is not None:
            spec = get_engine(merged.variant)
            if merged.precision not in spec.precisions:
                raise ValueError(
                    f"engine {merged.variant!r} cannot serve precision "
                    f"{merged.precision!r} (it supports {spec.precisions}); "
                    "force a capable engine or change precision="
                )
            if merged.backends and spec.backend not in merged.backends:
                raise ValueError(
                    f"engine {merged.variant!r} is on backend {spec.backend!r}, "
                    f"outside the scoped backend restriction {merged.backends}"
                )
        self._token = _ACTIVE.set(merged)
        # Only an explicit observe= pushes obs scope state: a Trace pushed
        # again by an inheriting scope would record every event twice.
        self._obs_tokens = obs.push_observe(observe) if observe is not None else None
        self._flight_prev = ((_telemetry.set_flight_recorder(recorder),)
                             if flight_recorder is not None else None)
        self._faults_token = (
            push_faults(faults if isinstance(faults, FaultPlan) else None)
            if faults is not None else None
        )

    def __enter__(self) -> "config":
        return self

    def __exit__(self, *exc) -> None:
        self.restore()

    def restore(self) -> None:
        """Undo this call's overrides (automatic when used as a context)."""
        if self._flight_prev is not None:
            _telemetry.set_flight_recorder(self._flight_prev[0])
            self._flight_prev = None
        if self._faults_token is not None:
            pop_faults(self._faults_token)
            self._faults_token = None
        if self._obs_tokens is not None:
            obs.pop_observe(self._obs_tokens)
            self._obs_tokens = None
        if self._token is not None:
            _ACTIVE.reset(self._token)
            self._token = None
