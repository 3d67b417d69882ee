"""Context-scoped configuration for the ``repro_torch.xfft`` namespace.

Port of ``repro.xfft._config`` for the fields this slice runs: ``variant``,
``precision`` and ``backend``. ``mode`` has one working value, ESTIMATE:
:func:`config` accepts it and raises ``NotImplementedError`` for MEASURE,
which is queued in the ROADMAP (queue 1, item 7), and stores nothing.
:func:`config` applies its overrides at once and, used as a context
manager, restores the previous configuration on exit. Scoping is
:mod:`contextvars`-based, so scopes nest and never leak between threads.

    import repro_torch.xfft as xfft

    with xfft.config(variant="fused_r4"):   # force the CUDA kernel here
        y = xfft.rfft2(frames)
    with xfft.config(backend="torch"):      # planner may pick schedules only
        y = xfft.fft2(frames)
    with xfft.config(precision="double"):   # complex128 end to end
        y = xfft.fft2(frames)               # (the reference_x64 engine)
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Optional, Sequence, Tuple, Union

from repro_torch.engines import get_engine, has_engine, registered_backends, registered_variants

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

#: Raised for the mode whose engine is not ported yet.
_MEASURE_NOT_PORTED = (
    "mode='measure' is not ported yet (see ROADMAP, queue 1 item 7: MEASURE, "
    "timed with CUDA events); use mode='estimate'"
)


@dataclasses.dataclass(frozen=True)
class XFFTConfig:
    """One immutable configuration snapshot.

    variant   — force a registered engine for every call in scope; ``None``
                lets ``repro_torch.plan`` decide.
    precision — ``"single"`` (complex64, the paper's datapath) or
                ``"double"`` (complex128 through the ``reference_x64``
                engine); part of every plan key.
    backends  — engine-backend families the planner may consider (e.g.
                ``("torch",)``); ``()`` means all.
    """

    variant: Optional[str] = None
    precision: str = "single"
    backends: Tuple[str, ...] = ()


_ACTIVE: contextvars.ContextVar[XFFTConfig] = contextvars.ContextVar(
    "repro_torch_xfft_config", default=XFFTConfig()
)


def get_config() -> XFFTConfig:
    """The configuration currently in scope."""
    return _ACTIVE.get()


def check_mode(mode: Optional[str]) -> None:
    """Accept ``None`` or ``"estimate"``; MEASURE raises until it is ported."""
    if mode is None or mode == "estimate":
        return
    if mode == "measure":
        raise NotImplementedError(_MEASURE_NOT_PORTED)
    raise ValueError(f"mode must be 'estimate' or 'measure', got {mode!r}")


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
    """

    def __init__(
        self,
        variant: Optional[str] = None,
        mode: Optional[str] = None,
        precision: Optional[str] = None,
        backend: Union[str, Sequence[str], None] = None,
    ):
        prev = _ACTIVE.get()
        clear_variant = variant == "auto"
        if variant is not None and not clear_variant and not has_engine(variant):
            raise ValueError(
                f"unknown variant {variant!r}; registered engines: "
                f"{registered_variants()}, 'auto' to clear an outer override, "
                "or None to inherit"
            )
        check_mode(mode)
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
            precision=precision if precision is not None else prev.precision,
            backends=backends if backends is not None else prev.backends,
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

    def __enter__(self) -> "config":
        return self

    def __exit__(self, *exc) -> None:
        self.restore()

    def restore(self) -> None:
        """Undo this call's overrides (automatic when used as a context)."""
        if self._token is not None:
            _ACTIVE.reset(self._token)
            self._token = None
